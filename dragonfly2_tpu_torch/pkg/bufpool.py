"""Reusable buffers for the dataset plane's span reads: the port's copy of
``dragonfly2_tpu/pkg/bufpool.py``.

The pool hands out ``memoryview`` windows over recycled bytearrays; a
read fills one in place and ``release()`` parks the backing buffer for the
next acquire.

Ownership rules (as in the JAX package):
  - acquire() transfers ownership to the caller; exactly one release()
    returns it. A second release of the same view is refused (the view is
    released with the first).
  - A released view must not be read again: the next acquire() will
    overwrite its bytes.
  - A consumer that must keep the bytes past the call that handed them
    over copies them (``bytes(view)``).
  - A buffer lent to a worker thread is not released until that thread
    is done with it, even when the caller is cancelled: the caller awaits
    the worker through ``await_worker``.

Every pool reports ``bufpool_acquires_total{pool,source}``,
``bufpool_releases_total{pool,outcome}`` and
``bufpool_retained_bytes{pool}`` in the port's metric registry.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import socket
import threading

from dragonfly2_tpu_torch.pkg import metrics

_MB = 1 << 20

BUFPOOL_ACQUIRES = metrics.counter(
    "bufpool_acquires_total",
    "Buffer-pool acquires (pooled-hit vs fresh allocation)",
    ("pool", "source"))
BUFPOOL_RELEASES = metrics.counter(
    "bufpool_releases_total",
    "Buffer-pool releases (retained for reuse vs dropped over cap)",
    ("pool", "outcome"))
BUFPOOL_RETAINED = metrics.gauge(
    "bufpool_retained_bytes",
    "Bytes currently parked in the buffer-pool free list", ("pool",))


class BufferPool:
    """Free-list of bytearrays, bounded by total retained bytes.
    Thread-safe."""

    def __init__(self, max_retained_bytes: int = 64 * _MB,
                 name: str = "default"):
        self.name = name
        self._free: list[bytearray] = []
        self._retained = 0
        self._max_retained = max_retained_bytes
        self._mu = threading.Lock()
        self._acquires = 0
        self._releases = 0
        self._m_pooled = BUFPOOL_ACQUIRES.labels(name, "pooled")
        self._m_fresh = BUFPOOL_ACQUIRES.labels(name, "fresh")
        self._m_retained_rel = BUFPOOL_RELEASES.labels(name, "retained")
        self._m_dropped_rel = BUFPOOL_RELEASES.labels(name, "dropped")
        self._m_retained_bytes = BUFPOOL_RETAINED.labels(name)

    def acquire(self, size: int) -> memoryview:
        """A writable ``memoryview`` of exactly ``size`` bytes over a pooled
        (or fresh) bytearray."""
        size = max(size, 1)
        with self._mu:
            self._acquires += 1
            # First fit: the spans of one dataset are near-uniform in size.
            for i, ba in enumerate(self._free):
                if len(ba) >= size:
                    self._free.pop(i)
                    self._retained -= len(ba)
                    self._m_pooled.inc()
                    self._m_retained_bytes.set(self._retained)
                    return memoryview(ba)[:size]
        self._m_fresh.inc()
        return memoryview(bytearray(size))

    def release(self, view: "memoryview | bytearray | bytes | None") -> None:
        """Return a buffer obtained from acquire(). Plain bytes (paths that
        did not pool) are simply dropped."""
        if isinstance(view, memoryview):
            obj = view.obj
            view.release()
        else:
            obj = view
        if not isinstance(obj, bytearray):
            return
        with self._mu:
            self._releases += 1
            if self._retained + len(obj) <= self._max_retained:
                self._free.append(obj)
                self._retained += len(obj)
                self._m_retained_rel.inc()
                self._m_retained_bytes.set(self._retained)
            else:
                self._m_dropped_rel.inc()

    def stats(self) -> dict:
        with self._mu:
            return {"free_buffers": len(self._free),
                    "retained_bytes": self._retained,
                    "acquires": self._acquires,
                    "releases": self._releases,
                    # Views handed out and not yet returned.
                    "outstanding": self._acquires - self._releases}


async def await_worker(future, abort=None):
    """Await a worker thread that may be writing into a caller's buffer,
    and return its result. ``future`` is the worker's
    ``concurrent.futures.Future``, or an asyncio future that ends when the
    worker does (``asyncio.to_thread``'s task).

    If the caller is cancelled, a worker that has not started never
    starts; one that has is told to stop (``abort()``, when given) and
    awaited to its end before ``CancelledError`` propagates, so the
    caller's ``finally`` may release the buffer: nothing writes into it
    any more."""
    threaded = isinstance(future, concurrent.futures.Future)
    waiter = asyncio.wrap_future(future) if threaded else future
    try:
        return await asyncio.shield(waiter)
    except asyncio.CancelledError:
        if not (threaded and future.cancel()):
            if abort is not None:
                abort()
            while not waiter.done():
                try:
                    await asyncio.wait([waiter])
                except asyncio.CancelledError:
                    pass   # cancelled already; the worker must end first
            if not waiter.cancelled():
                waiter.exception()   # retrieved: the caller gets the cancel
        raise


class CallAborted(Exception):
    """The caller was cancelled; its worker stops."""


class WorkerCall:
    """The connections one call's worker is using, so that a cancelled
    caller can cut them: ``abort`` is the abort to hand ``await_worker``.
    The HTTP clients on worker threads (the origin's, the object
    gateway's and the piece downloader's) share it."""

    def __init__(self):
        self._mu = threading.Lock()
        self._conns: list = []
        self.stopped = False

    def attach(self, conn) -> None:
        with self._mu:
            if self.stopped:
                raise CallAborted()
            self._conns.append(conn)

    def detach(self, conn) -> None:
        """The worker is done with ``conn``. A cancel may have cut its
        socket after the worker's last read, so a stopped call closes it:
        the worker's next request opens a fresh connection. A ``conn``
        whose attach was refused is not on the list."""
        with self._mu:
            if conn in self._conns:
                self._conns.remove(conn)
            if self.stopped:
                conn.close()

    def abort(self) -> None:
        with self._mu:
            self.stopped = True
            for conn in self._conns:
                if conn.sock is not None:
                    try:
                        conn.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

    def check(self) -> None:
        if self.stopped:
            raise CallAborted()
