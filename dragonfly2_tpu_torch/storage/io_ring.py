"""Batched span I/O for the task store: the port's copy of
``dragonfly2_tpu/storage/io_ring.py`` with one backend.

``LocalTaskStore.read_spans_into`` hands a multi-span batch to the ring;
its spans go to ``os.preadv`` on a small pool of ``df-ioring`` threads,
concurrently, and each lands directly in the caller's (usually pooled)
buffer: nothing is allocated or copied here. This is the behaviour of the
JAX package's ``threads`` rung, under which a piece's chunks are written
by the store's own ``os.pwritev``; the port has no native batch ring, no
io_uring and no environment pin (``ring_backend()`` is always
``"threads"``).

EOF inside a requested span raises ``ShortReadError`` (the store turns it
into the StorageError its single-span read raises); I/O errors raise
OSError. Scrapeable as ``storage_ring_submissions_total{backend}`` (one
per batch) and ``storage_ring_spans_total{op}`` (spans carried), the JAX
package's families.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

from dragonfly2_tpu_torch.pkg import metrics

RING_SUBMISSIONS = metrics.counter(
    "storage_ring_submissions_total",
    "Batched-IO submissions by backend (one per batch, however many "
    "spans it carries)", ("backend",))
RING_SPANS = metrics.counter(
    "storage_ring_spans_total",
    "Spans (reads) and chunks (writes) carried by batched-IO "
    "submissions", ("op",))

BACKEND = "threads"
_POOL_WORKERS = 4


class ShortReadError(OSError):
    """EOF inside a requested span: the bytes were never landed or the
    file was truncated under us."""

    def __init__(self, detail: str = "EOF inside requested span"):
        super().__init__(5, f"short read: {detail}")


def _read_span(fd: int, offset: int, length: int, mv) -> None:
    got = 0
    while got < length:
        n = os.preadv(fd, [mv[got:length]], offset + got)
        if n <= 0:
            raise ShortReadError(
                f"at offset {offset + got}: {got}/{length} bytes (EOF)")
        got += n


class SubmissionRing:
    """The process-wide batch submitter."""

    def __init__(self):
        self.backend = BACKEND
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._m_subs = RING_SUBMISSIONS.labels(BACKEND)
        self._m_read = RING_SPANS.labels("read")

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=_POOL_WORKERS,
                    thread_name_prefix="df-ioring")
            return self._pool

    def read_spans(self, fd: int, spans, buf, buf_offsets) -> int:
        """Fill ``buf`` at ``buf_offsets[i]`` with span ``spans[i]`` =
        (file_offset, length); one submission for the whole batch.
        Returns the total bytes. Raises ShortReadError / OSError."""
        work = [((off, ln), at) for (off, ln), at in zip(spans, buf_offsets)
                if ln > 0]
        if not work:
            return 0
        self._m_subs.inc()
        self._m_read.inc(len(work))
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        total = sum(ln for (_, ln), _ in work)
        if len(work) == 1:
            (off, ln), at = work[0]
            _read_span(fd, off, ln, mv[at:at + ln])
            return total
        futs = [self._executor().submit(_read_span, fd, off, ln,
                                        mv[at:at + ln])
                for (off, ln), at in work]
        for f in futs:
            f.result()
        return total


_ring: SubmissionRing | None = None
_ring_lock = threading.Lock()


def get_ring() -> SubmissionRing:
    """The process-wide submission ring (made at first use)."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = SubmissionRing()
    return _ring


def ring_backend() -> str:
    """The submission backend the store uses: always ``"threads"``."""
    return BACKEND
