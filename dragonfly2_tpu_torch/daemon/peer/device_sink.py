"""Device sink manager: the daemon-side terminal store, on the card.

The port of ``dragonfly2_tpu/daemon/peer/device_sink.py``, with the same
duck-typed surface the reference daemon's task manager drives
(``on_piece``, ``finalize``, ``admit``, ``protect``/``unprotect``, ``get``,
``take``, ``discard``, ``gc``, ``close``). Inject it into a reference
daemon built with ``tpu_sink.enabled=False``::

    d = Daemon(cfg)                       # cfg.tpu_sink.enabled = False
    d.task_manager.device_sinks = DeviceSinkManager()

Pieces land into a port ``HBMSink`` as they verify, completion checks the
landed bytes on the card against the host checksums, and the result is a
device tensor (``as_bytes_array``, ``as_tensor``) or, spread over a device
mesh, a ``DTensor`` (``shard_to_mesh``, ``ici_broadcast``; the mesh of
this host's ranks is ``DeviceSinkManager.default_mesh``).

Threading: every sink mutation runs on one ``df-device-sink`` worker
thread, so host-to-device copies never stall the daemon's event loop.
``busy_s`` counts the seconds that worker has spent on landings and
finalizes (store reads, host checksums, staging, launches).
``take`` and the views run on the caller's thread; each view waits on the
CUDA event recorded by the last landing.

Failures: the manager degrades a task to disk-only on a device-side
exception (out of memory, a store read race), which is the daemon's
contract (the disk store stays authoritative). A fault of the port's own
kernels must not hide behind that: a CUDA manager builds the kernels in
its constructor, and every degrade handler re-raises ``KernelError`` (a
failed build or launch). Device-copy corruption raises
``DeviceSinkError``.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink
from dragonfly2_tpu_torch.parallel.multihost import local_mesh
from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("peer.device_sink")

SINK_LANDED_BYTES = metrics.counter(
    "device_sink_landed_bytes_total", "Bytes landed into device sinks")
SINK_VERIFY_COUNT = metrics.counter(
    "device_sink_verify_total", "Device sink verifications", ("result",))


class DeviceSinkError(Exception):
    pass


class TaskDeviceSink:
    """One task's landing: an ``HBMSink`` plus the piece bookkeeping the
    daemon needs (landed pieces, their host digests, staleness)."""

    def __init__(self, task_id: str, content_length: int, piece_size: int, *,
                 device=None, batch_pieces: int = 8):
        # Offsets are word-addressed: a piece size that is not a multiple
        # of 4 (only possible for a single-piece task, where it equals the
        # content length) rounds up; zero padding is checksum-neutral.
        total_pieces = max(
            1, (content_length + piece_size - 1) // piece_size)
        if piece_size % 4 and total_pieces > 1:
            raise DeviceSinkError(
                f"piece size {piece_size} not 4-byte aligned")
        aligned = piece_size + ((-piece_size) % 4)
        self.task_id = task_id
        self.sink = HBMSink(content_length, aligned, device=device,
                            batch_pieces=batch_pieces)
        self.created_at = time.time()
        self.verified = False
        self.verified_at = 0.0
        # Host-side piece digests at land time: lets a later finalize
        # detect that the store's content changed under a resident sink.
        self.piece_digests: dict[int, str] = {}

    def land(self, piece_num: int, data, digest: str = "") -> None:
        self.sink.land_piece(piece_num, data)
        self.piece_digests[piece_num] = digest
        SINK_LANDED_BYTES.inc(len(data))

    @property
    def landed(self) -> set[int]:
        return self.sink.landed

    def verify(self) -> None:
        try:
            self.sink.verify()
        except ValueError as e:
            SINK_VERIFY_COUNT.labels("corrupt").inc()
            raise DeviceSinkError(str(e)) from e
        SINK_VERIFY_COUNT.labels("ok").inc()
        self.verified = True
        self.verified_at = time.time()

    def as_bytes_array(self):
        return self.sink.as_bytes_array()

    def as_tensor(self, dtype, shape):
        return self.sink.as_tensor(dtype, shape)

    def shard_to_mesh(self, mesh, axis_name: str = "d", *,
                      src: int | None = None):
        return self.sink.shard_to_mesh(mesh, axis_name, src=src)

    def ici_broadcast(self, mesh, axis_name: str = "d", n_chunks: int = 4, *,
                      src: int | None = None):
        """Striped-broadcast consumption: the landed content on every
        rank of the axis through the chunked ring. Requires a verified
        sink: a striped task never exposes unverified bytes."""
        if not self.verified:
            raise DeviceSinkError(
                f"ici_broadcast on unverified sink {self.task_id[:16]}")
        return self.sink.ring_replicate(mesh, axis_name, n_chunks=n_chunks,
                                        src=src)


class DeviceSinkManager:
    """Owns the per-task sinks a daemon is landing."""

    def __init__(self, *, mesh_shape: list[int] | None = None,
                 batch_pieces: int = 8, max_tasks: int = 4,
                 ttl: float = 600.0, device=None):
        self._device = default_device(device)
        self.mesh_shape = list(mesh_shape or [])
        if self._device.type == "cuda":
            _build.library()   # a build failure raises here, not in a landing
        self._admission = None
        self.claim_grace_s = 10.0   # see _create's eviction rule
        # Task ids a client pull has announced it WILL claim: never evicted.
        # Refcounted: concurrent claimers of one deduped task each hold one.
        self._protected: dict[str, int] = {}
        self.batch_pieces = batch_pieces
        self.max_tasks = max_tasks
        self.ttl = ttl
        self._sinks: dict[str, TaskDeviceSink] = {}
        # Tasks whose sink hit a device error mid-download: disk-only for
        # the rest of this attempt (cleared on discard, so a retry is fresh).
        self._degraded: set[str] = set()
        # One worker: serializes sink mutation (HBMSink is not thread-safe)
        # and keeps device copies off the event loop.
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="df-device-sink")
        self.busy_s = 0.0   # written by the worker only

    def admit(self):
        """Admission bound for client-API device pulls: an async context
        holding one sink slot (one below ``max_tasks``, so an RPC-path
        device task is never starved)."""
        if self._admission is None:
            self._admission = asyncio.Semaphore(max(1, self.max_tasks - 1))
        return self._admission

    def close(self, wait: bool = False) -> None:
        """Stop the worker, dropping queued landings; ``wait``: until the
        one in progress has returned."""
        self._exec.shutdown(wait=wait, cancel_futures=True)

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._exec, self._timed, fn, *args)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.busy_s += time.perf_counter() - t0

    # -- landing ----------------------------------------------------------

    async def on_piece(self, task_id: str, store, rec) -> None:
        """Land one verified piece as it arrives. The first piece after
        the task's length and piece size are known allocates the buffer."""
        await self._run(self._land_sync, task_id, store, rec)

    def _land_sync(self, task_id: str, store, rec) -> None:
        if task_id in self._degraded:
            return
        sink = self._sinks.get(task_id)
        if sink is None:
            m = store.metadata
            if m.content_length < 0 or m.piece_size <= 0:
                return  # metadata not known yet; finalize backfills it
            sink = self._create(task_id, m.content_length, m.piece_size)
            if sink is None:
                return
        if rec.num in sink.landed:
            return
        if rec.num >= sink.sink.total_pieces:
            log.warning("piece out of sink range, skipped",
                        task=task_id[:16], piece=rec.num)
            return
        try:
            sink.land(rec.num, store.read_piece(rec.num), rec.digest)
        except _build.KernelError:
            self._sinks.pop(task_id, None)   # fails the download, loudly
            raise
        except Exception as e:
            # Device trouble mid-stream (out of memory, runtime errors):
            # this task goes disk-only; the download itself must not fail.
            log.warning("device landing failed; degrading to disk-only",
                        task=task_id[:16], error=str(e)[:200])
            self._sinks.pop(task_id, None)
            self._degraded.add(task_id)

    def _create(self, task_id: str, content_length: int,
                piece_size: int) -> TaskDeviceSink | None:
        self._expire()
        if len(self._sinks) >= self.max_tasks:
            # Residents are caches (the disk store stays authoritative): a
            # verified, unclaimed sink yields to a NEW landing, oldest
            # first. Mid-landing and protected sinks are never evicted;
            # residents past their claim grace go before fresh ones.
            now = time.time()
            verified = sorted(
                (s for s in self._sinks.values()
                 if s.verified and s.task_id not in self._protected),
                key=lambda s: s.created_at)
            evictable = ([s for s in verified
                          if now - s.verified_at > self.claim_grace_s]
                         or verified)
            if evictable:
                victim = evictable[0]
                log.info("evicting resident device sink for new landing",
                         evicted=victim.task_id[:16], task=task_id[:16])
                del self._sinks[victim.task_id]
            else:
                log.warning("device sink cap reached; landing to disk only",
                            task=task_id[:16], cap=self.max_tasks)
                return None
        try:
            sink = TaskDeviceSink(task_id, content_length, piece_size,
                                  device=self._device,
                                  batch_pieces=self.batch_pieces)
        except _build.KernelError:
            raise
        except Exception as e:
            # Device out of memory, misaligned pieces: disk-only.
            log.warning("device sink unavailable for task",
                        task=task_id[:16], error=str(e)[:200])
            return None
        self._sinks[task_id] = sink
        log.info("device sink created", task=task_id[:16],
                 bytes=content_length)
        return sink

    # -- completion -------------------------------------------------------

    async def finalize(self, task_id: str, store) -> TaskDeviceSink | None:
        """Backfill pieces the streaming hook missed, then verify every
        landed piece on the card. Returns None when no sink could be
        allocated (disk-only); raises DeviceSinkError on corruption."""
        return await self._run(self._finalize_sync, task_id, store)

    def _finalize_sync(self, task_id: str, store) -> TaskDeviceSink | None:
        if task_id in self._degraded:
            self._degraded.discard(task_id)  # next attempt starts fresh
            return None
        try:
            return self._finalize_inner(task_id, store)
        except (DeviceSinkError, _build.KernelError):
            # Corruption and kernel faults fail the request. The reference
            # task manager discards the sink on its own package's
            # DeviceSinkError only; drop the copy here.
            self._sinks.pop(task_id, None)
            raise
        except Exception as e:
            # Environment failures (OOM during backfill, store read races)
            # degrade to disk-only: the disk result is digest-verified.
            log.warning("device finalize failed; disk-only result",
                        task=task_id[:16], error=str(e)[:200])
            self._sinks.pop(task_id, None)
            return None

    def _finalize_inner(self, task_id: str, store) -> TaskDeviceSink | None:
        m = store.metadata
        sink = self._sinks.get(task_id)
        if sink is not None and self._stale(sink, store):
            # Same task id, new bytes: a mixed buffer must never verify.
            log.warning("device sink stale vs store; rebuilding",
                        task=task_id[:16])
            del self._sinks[task_id]
            sink = None
        if sink is None:
            sink = self._create(task_id, m.content_length, m.piece_size)
            if sink is None:
                return None
        for rec in store.get_pieces():
            if rec.num not in sink.landed:
                sink.land(rec.num, store.read_piece(rec.num), rec.digest)
        sink.verify()
        log.info("device sink verified", task=task_id[:16],
                 pieces=len(sink.landed))
        return sink

    @staticmethod
    def _stale(sink: TaskDeviceSink, store) -> bool:
        pieces = store.metadata.pieces
        for num, digest in sink.piece_digests.items():
            rec = pieces.get(num)
            if rec is None or (digest and rec.digest and rec.digest != digest):
                return True
        return False

    # -- consumption / lifecycle ------------------------------------------

    def protect(self, task_id: str) -> None:
        """Exempt ``task_id``'s sink from eviction until ``unprotect``."""
        self._protected[task_id] = self._protected.get(task_id, 0) + 1

    def unprotect(self, task_id: str) -> None:
        n = self._protected.get(task_id, 0) - 1
        if n > 0:
            self._protected[task_id] = n
        else:
            self._protected.pop(task_id, None)

    def get(self, task_id: str) -> TaskDeviceSink | None:
        return self._sinks.get(task_id)

    def take(self, task_id: str) -> TaskDeviceSink | None:
        """Claim the sink (the caller owns the buffer; the manager forgets)."""
        return self._sinks.pop(task_id, None)

    def discard(self, task_id: str) -> None:
        self._sinks.pop(task_id, None)
        self._degraded.discard(task_id)

    def gc(self) -> None:
        """TTL sweep: unclaimed sinks must not hold device memory forever."""
        self._expire()

    def _expire(self) -> None:
        now = time.time()
        for tid in [t for t, s in self._sinks.items()
                    if now - s.created_at > self.ttl]:
            log.info("device sink expired", task=tid[:16])
            del self._sinks[tid]

    def default_mesh(self):
        """Mesh over this host's ranks (``LOCAL_WORLD_SIZE`` consecutive
        ranks, one card each), shaped by ``mesh_shape`` into axes ``d0``,
        ``d1``, ... or one ``"d"`` axis when unset: the sinks'
        ``shard_to_mesh`` spreads over this host's cards. A collective:
        every rank of the job calls it."""
        return local_mesh(self.mesh_shape, device=self._device)
