"""The daemon's task manager: the port's copy of
``dragonfly2_tpu/daemon/peer/task_manager.py``.

``start_file_task`` runs a file task and yields its progress:

1. reuse of a completed local task (``from_reuse``);
2. a ranged request for a file whose slice a local parent task covers:
   exported from the parent (``output`` set, no device);
3. dedup: a request for a task already running waits for it;
4. a fresh download: with a scheduler client and a conductor factory,
   a ``PeerTaskConductor`` (``daemon/peer/conductor.py``) registers with
   the scheduler and pulls the pieces from parents (or demotes to the
   origin); without them, a ranged task whose slice a local parent covers
   imports it (``import_range_from_local_parent``) and any other goes to
   the origin (``PieceManager.download_source``). Each landed piece is
   published on the broker with its digest (a child's sync stream reads
   them, ``daemon/rpcserver.py``) and, for ``device="tpu"``, landed in the
   device sink as it arrives; at completion the whole-content digest is
   checked, unless a done parent's digest map certifies every piece
   (``peer_completion_rehash_total{result="skipped"}``), the output
   stored, and the device sink finalized (backfill plus the on-card
   check).

The wire value that asks for the device sink stays ``device="tpu"``, the
literal the JAX daemon tests for: the port's client sends it. A device
request lands in ``device_sinks`` (the port's ``DeviceSinkManager``);
corruption of the device copy fails the request with
``ClientPieceDownloadFail`` while the disk store stays complete and
reusable, and a kernel fault (``KernelError``) propagates.

An imported task is announced to the scheduler (``AnnounceTask``), so
that it can be handed out as a parent.

Not ported yet: PEX (a task manager without a scheduler fails a
``disable_back_source`` task that no local parent covers), stream and
seed tasks, the delta task, ranged prefetch, the flight recorder, the
quarantine, the persistent import (``import_task(persistent=True)``
raises), and the traffic shaper's wiring (it comes with the daemon's
config and loop; downloads go through the piece manager's one limiter).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import AsyncIterator

from dragonfly2_tpu_torch.daemon.peer.broker import PieceBroker, PieceEvent
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkError
from dragonfly2_tpu_torch.daemon.peer.piece_manager import PieceManager
from dragonfly2_tpu_torch.pkg import dflog, idgen, metrics
from dragonfly2_tpu_torch.pkg.errors import (
    Code,
    DfError,
    StorageError,
    describe,
)
from dragonfly2_tpu_torch.pkg.piece import (
    Range,
    compute_piece_count,
    compute_piece_size,
)
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.storage import (
    LocalTaskStore,
    StorageManager,
    TaskStoreMetadata,
)
from dragonfly2_tpu_torch.storage.local_store import (
    acquire_read_buffer,
    release_read_buffer,
)

log = dflog.get("peer.task_manager")

# The daemon's wire value for "also land the pieces in device memory".
DEVICE_SINK = "tpu"

# Completion-time whole-content digest decisions: "skipped" when a done
# parent's digest map certified every piece, "hashed" when the re-hash ran.
COMPLETION_REHASH = metrics.counter(
    "peer_completion_rehash_total",
    "Completion-time whole-content digest decisions", ("result",))


@dataclass
class FileTaskRequest:
    url: str
    output: str
    meta: UrlMeta = field(default_factory=UrlMeta)
    peer_id: str = ""
    disable_back_source: bool = False
    range: Range | None = None
    # "" = disk only; DEVICE_SINK additionally lands verified pieces into
    # the daemon's device sinks as they arrive.
    device: str = ""
    # Register as a pod broadcast (the scheduler stripes the pull across
    # same-slice hosts).
    pod_broadcast: bool = False

    def task_id(self) -> str:
        return idgen.task_id_v1(
            self.url, digest=self.meta.digest, tag=self.meta.tag,
            application=self.meta.application, filters=self.meta.filter,
            range_header=self.meta.range)

    def parent_task_id(self) -> str:
        """The whole-content task id of a ranged request."""
        return idgen.parent_task_id_v1(
            self.url, digest=self.meta.digest, tag=self.meta.tag,
            application=self.meta.application, filters=self.meta.filter)


@dataclass
class FileTaskProgress:
    state: str                  # running | done | failed
    task_id: str = ""
    peer_id: str = ""
    content_length: int = -1
    completed_length: int = 0
    piece_count: int = 0
    total_piece_count: int = -1
    digest: str = ""
    error: dict | None = None
    from_reuse: bool = False
    from_p2p: bool = False
    # The content also landed in a device sink and passed the on-card
    # check (device="tpu" requests).
    device_verified: bool = False

    def to_wire(self) -> dict:
        return {
            "state": self.state,
            "task_id": self.task_id,
            "peer_id": self.peer_id,
            "content_length": self.content_length,
            "completed_length": self.completed_length,
            "piece_count": self.piece_count,
            "total_piece_count": self.total_piece_count,
            "digest": self.digest,
            "error": self.error,
            "from_reuse": self.from_reuse,
            "from_p2p": self.from_p2p,
            "device_verified": self.device_verified,
        }


class _RunningTask:
    def __init__(self, store):
        self.store = store
        self.done = asyncio.Event()
        self.error: DfError | None = None


class TaskManager:
    """The front end of file tasks: reuse, dedup, the origin download and
    the device sink."""

    def __init__(
        self,
        storage: StorageManager,
        piece_manager: PieceManager,
        *,
        host_ip: str = "127.0.0.1",
        scheduler_client=None,
        conductor_factory=None,
        host_wire=None,
        device_sinks=None,
    ):
        self.storage = storage
        self.piece_manager = piece_manager
        # The device terminal store (daemon/peer/device_sink's
        # DeviceSinkManager), chosen per task by FileTaskRequest.device.
        self.device_sinks = device_sinks
        self.host_ip = host_ip
        self.scheduler_client = scheduler_client
        # conductor_factory(task_id=, peer_id=, request=, store=,
        # on_piece=, limiter=) -> a conductor with run() and
        # from_p2p (daemon/peer/conductor.conductor_factory).
        self.conductor_factory = conductor_factory
        # () -> the host's AnnounceHost-shaped dict: the identity imported
        # tasks are announced under.
        self.host_wire = host_wire
        self.broker = PieceBroker()
        self._running: dict[str, _RunningTask] = {}
        # The last delta landing's accounting by task id (the delta plane
        # writes it; bounded by its writer).
        self.delta_stats: dict[str, dict] = {}

    # -- the download core -------------------------------------------------

    async def _run_download(self, task_id: str, peer_id: str,
                            req: FileTaskRequest, store,
                            progress_q: "_ProgressAggregator | None") -> bool:
        """Download into ``store``; returns from_p2p. Each piece is
        published on the broker and, for a device request, landed in the
        device sink as it arrives."""
        # Ranged tasks land too: the store's piece grid is slice-relative,
        # so the sink's geometry is the slice's (download_sharded).
        sink_wanted = req.device == DEVICE_SINK and self.device_sinks is not None

        async def on_piece(st, rec) -> None:
            m = st.metadata
            self.broker.publish(task_id, PieceEvent(
                [rec.num], m.total_piece_count, m.content_length, m.piece_size,
                digests={rec.num: rec.digest}))
            if sink_wanted:
                await self.device_sinks.on_piece(task_id, st, rec)
            if progress_q is not None:
                await progress_q.on_piece(st, rec)

        if (self.scheduler_client is not None
                and self.conductor_factory is not None):
            conductor = self.conductor_factory(
                task_id=task_id, peer_id=peer_id, request=req, store=store,
                on_piece=on_piece, limiter=self.piece_manager.limiter)
            await conductor.run()
            return conductor.from_p2p
        # A ranged task whose slice a local parent covers imports it
        # without touching the origin (allowed even with the origin off the
        # table). Origin reads go through the piece manager's own limiter.
        if await self.import_range_from_local_parent(store, req, on_piece):
            return False
        if req.disable_back_source:
            raise DfError(Code.ClientBackSourceError,
                          "no scheduler and back-to-source disabled")
        if LocalTaskStore.completion_digest_applies(
                req.meta.digest, req.range is not None):
            # Back-source piece digests are self-computed, so the
            # completion re-hash is certain: overlap it.
            store.start_prefix_hasher(req.meta.digest)
        await self.piece_manager.download_source(
            store, req.url, req.meta.header,
            content_range=req.range, on_piece=on_piece)
        return False

    # -- import (dfcache) --------------------------------------------------

    async def import_task(self, path: str, req: FileTaskRequest, *,
                          persistent: bool = False, replica_count: int = 1,
                          ttl: float = 0.0) -> dict:
        """Import a local file as a completed task and announce it to the
        scheduler. The persistent import is not ported: it raises
        ``DfError(BadRequest)``, as the JAX one does without a scheduler
        connection."""
        if persistent:
            raise DfError(Code.BadRequest,
                          "persistent import needs a scheduler connection")
        task_id = req.task_id()
        peer_id = req.peer_id or idgen.peer_id_v1(self.host_ip)
        store = self.storage.find_completed_task(task_id)
        if store is None:
            store = self.storage.register_task(TaskStoreMetadata(
                task_id=task_id, peer_id=peer_id, url=req.url,
                tag=req.meta.tag, application=req.meta.application))
            with store:
                try:
                    await self.piece_manager.import_file(store, path)
                    if req.meta.digest:
                        await asyncio.to_thread(store.validate_digest,
                                                req.meta.digest)
                        store.metadata.digest = req.meta.digest
                    store.mark_done()
                except BaseException:
                    # A half-imported store must not be resumed by a retry.
                    store.mark_invalid()
                    raise
        await self._announce_local_task(store, task_id, peer_id)
        return {"task_id": task_id, "peer_id": peer_id,
                "pieces": len(store.metadata.pieces),
                "piece_size": store.metadata.piece_size,
                "total_piece_count": store.metadata.total_piece_count,
                "content_length": store.metadata.content_length}

    async def _announce_local_task(self, store, task_id: str,
                                   peer_id: str) -> None:
        """Tell the scheduler this host holds the complete task, so that it
        can be scheduled as a parent (``Scheduler.AnnounceTask``)."""
        if self.scheduler_client is None or self.host_wire is None:
            return
        try:
            host_info = dict(self.host_wire())
            if not host_info:
                return
            host_info.pop("telemetry", None)
            m = store.metadata
            await self.scheduler_client.announce_task({
                "task_id": task_id, "peer_id": peer_id, "url": m.url,
                "tag": m.tag, "application": m.application, "host": host_info,
                "content_length": m.content_length, "piece_size": m.piece_size,
                "total_piece_count": m.total_piece_count,
                "piece_nums": sorted(m.pieces.keys()),
            })
        except Exception as e:
            log.warning("announce_task failed", task_id=task_id[:16],
                        error=str(e))

    # -- file task ---------------------------------------------------------

    async def start_file_task(
            self, req: FileTaskRequest) -> AsyncIterator[FileTaskProgress]:
        task_id = req.task_id()
        peer_id = req.peer_id or idgen.peer_id_v1(self.host_ip)

        # 1. Reuse a completed local task.
        reused = self.storage.find_completed_task(task_id)
        if reused is not None:
            log.info("reusing completed task", task_id=task_id[:16])
            async for p in self._finish_from_store(req, task_id, peer_id,
                                                   reused):
                yield p
            return

        # 2. A ranged request to a file: export the slice off a local
        # parent that covers it (a device request lands a fresh ranged
        # task below instead, which imports from the same parent).
        if req.meta.range and req.device != DEVICE_SINK and req.output:
            covering = self._covering_local_parent(req)
            if covering is not None:
                parent, rng = covering
                log.info("reusing ranged slice from parent task",
                         parent=parent.metadata.task_id[:16],
                         start=rng.start, length=rng.length)
                with parent:
                    await asyncio.to_thread(parent.export_range, req.output,
                                            rng.start, rng.length)
                yield FileTaskProgress(
                    state="done", task_id=task_id, peer_id=peer_id,
                    content_length=rng.length, completed_length=rng.length,
                    piece_count=0, total_piece_count=0, from_reuse=True)
                return

        # 3. Dedup: wait for the running download of the same task.
        running = self._running.get(task_id)
        if running is not None:
            log.info("waiting on running task", task_id=task_id[:16])
            await running.done.wait()
            if running.error is not None:
                yield FileTaskProgress(state="failed", task_id=task_id,
                                       peer_id=peer_id,
                                       error=running.error.to_wire())
                return
            store = self.storage.find_completed_task(task_id)
            if store is None:
                yield FileTaskProgress(
                    state="failed", task_id=task_id, peer_id=peer_id,
                    error=DfError(Code.UnknownError,
                                  "dedup race: no store").to_wire())
                return
            async for p in self._finish_from_store(req, task_id, peer_id,
                                                   store):
                yield p
            return

        # 4. A fresh download.
        store = self.storage.register_task(TaskStoreMetadata(
            task_id=task_id, peer_id=peer_id, url=req.url, tag=req.meta.tag,
            application=req.meta.application, header=dict(req.meta.header)))
        run = _RunningTask(store)
        self._running[task_id] = run
        progress_q = _ProgressAggregator(task_id, peer_id, store)
        store.pin()
        from_p2p = False
        download = asyncio.ensure_future(
            self._run_download(task_id, peer_id, req, store, progress_q))
        try:
            async for p in self._stream_progress(download, progress_q):
                yield p
            from_p2p = download.result()
            # Verify and land the output inside the same failure envelope.
            await self._finalize_content_digest(req, store)
            store.mark_done()
            if req.output:
                await asyncio.to_thread(store.store_to, req.output)
        except DfError as e:
            self._fail(req, task_id, store, run, e)
            yield FileTaskProgress(state="failed", task_id=task_id,
                                   peer_id=peer_id, error=e.to_wire())
            return
        except Exception as e:
            log.error("file task crashed", exc_info=True)
            self._fail(req, task_id, store, run,
                       DfError(Code.UnknownError, describe(e)))
            yield FileTaskProgress(state="failed", task_id=task_id,
                                   peer_id=peer_id,
                                   error=run.error.to_wire())
            return
        finally:
            # An early close of the generator (a client gone) must not
            # leave the download running against an unpinned store.
            if not download.done():
                download.cancel()
                try:
                    await download
                except BaseException:
                    pass
                self._fail(req, task_id, store, run, run.error or DfError(
                    Code.ClientContextCanceled, "download aborted by client"))
            store.unpin()
            run.done.set()
            self._running.pop(task_id, None)

        m = store.metadata
        self.broker.publish(task_id, PieceEvent(
            [], m.total_piece_count, m.content_length, m.piece_size,
            done=True))
        # The device finalize runs after the disk result is final: a corrupt
        # device copy fails this request only, and the store stays reusable.
        try:
            device_verified = await self._finalize_device(req, task_id, store)
        except DfError as e:
            yield FileTaskProgress(state="failed", task_id=task_id,
                                   peer_id=peer_id, error=e.to_wire())
            return
        yield self._final_progress(store, task_id, peer_id,
                                   from_p2p=from_p2p,
                                   device_verified=device_verified)

    async def _finish_from_store(self, req: FileTaskRequest, task_id: str,
                                 peer_id: str, store):
        """A request served by a completed store: the output, then the
        device finalize (which backfills the sink from the store)."""
        if req.output:
            # Pinned across the off-loop copy: GC must not reclaim it.
            with store:
                await asyncio.to_thread(store.store_to, req.output)
        try:
            dev = await self._finalize_device(req, task_id, store)
        except DfError as e:
            yield FileTaskProgress(state="failed", task_id=task_id,
                                   peer_id=peer_id, error=e.to_wire())
            return
        yield self._final_progress(store, task_id, peer_id, from_reuse=True,
                                   device_verified=dev)

    def _fail(self, req: FileTaskRequest, task_id: str, store,
              run: _RunningTask, error: DfError) -> None:
        self._discard_sink(req, task_id)
        store.mark_invalid()
        run.error = error
        self.broker.publish(task_id, PieceEvent([], failed=True))

    # -- helpers -----------------------------------------------------------

    def is_task_running(self, task_id: str) -> bool:
        return task_id in self._running

    def _final_progress(self, store, task_id: str, peer_id: str, *,
                        from_reuse: bool = False, from_p2p: bool = False,
                        device_verified: bool = False) -> FileTaskProgress:
        m = store.metadata
        return FileTaskProgress(
            state="done",
            task_id=task_id,
            peer_id=peer_id,
            content_length=m.content_length,
            completed_length=store.downloaded_bytes(),
            piece_count=len(m.pieces),
            total_piece_count=m.total_piece_count,
            digest=m.digest,
            from_reuse=from_reuse,
            from_p2p=from_p2p,
            device_verified=device_verified,
        )

    def _discard_sink(self, req: FileTaskRequest, task_id: str) -> None:
        """Drop a partly landed sink on a failure: a stale one could
        shadow a retry's bytes."""
        if req.device and self.device_sinks is not None:
            self.device_sinks.discard(task_id)

    def _covering_local_parent(self, req: FileTaskRequest):
        """(parent_store, resolved_range) when a local completed or partial
        parent task covers ``req``'s range, else None: the one coverage
        gate of the ranged export and the ranged import."""
        if not req.meta.range:
            return None
        parent_id = req.parent_task_id()
        parent = (self.storage.find_completed_task(parent_id)
                  or self.storage.find_partial_completed_task(parent_id))
        if parent is None or parent.metadata.piece_size <= 0:
            return None
        total = parent.metadata.content_length
        try:
            rng = Range.parse_http(req.meta.range, total)
        except ValueError:
            return None
        if rng is None:
            return None
        # Clamp a span past the end as download_source clamps it, so the
        # local parent serves the slice the origin would.
        length = rng.length
        if total >= 0:
            length = min(length, max(0, total - rng.start))
        if length <= 0 or not parent.covers_range(rng.start, length):
            return None
        return parent, Range(rng.start, length)

    async def import_range_from_local_parent(self, store, req,
                                             on_piece) -> bool:
        """A ranged task whose slice a local parent task holds imports it
        from the parent's store instead of the origin. Imported pieces go
        through ``on_piece`` like downloaded ones. True when the ranged
        store completed; a failed import (a parent truncated under its
        metadata) returns False and the caller goes to the origin."""
        covering = self._covering_local_parent(req)
        if covering is None:
            return False
        parent, rng = covering
        piece_size = store.metadata.piece_size or compute_piece_size(rng.length)
        store.update_task(content_length=rng.length, piece_size=piece_size,
                          total_piece_count=compute_piece_count(
                              rng.length, piece_size))
        log.info("ranged task imports from local parent",
                 task=store.metadata.task_id[:16],
                 parent=parent.metadata.task_id[:16],
                 start=rng.start, length=rng.length)
        try:
            with parent:  # pinned: GC must not reclaim it mid-import
                # One pooled buffer for every piece: read_into fills it in
                # place and the write lands (and digests) from it.
                buf = acquire_read_buffer(piece_size)
                try:
                    for n in range(store.metadata.total_piece_count):
                        if n in store.metadata.pieces:
                            continue
                        off = n * piece_size
                        size = min(piece_size, rng.length - off)
                        await asyncio.to_thread(
                            parent.read_into, rng.start + off, size, buf)
                        rec = await asyncio.to_thread(
                            store.write_piece, n, buf[:size])
                        if on_piece is not None:
                            await on_piece(store, rec)
                finally:
                    release_read_buffer(buf)
        except (StorageError, OSError) as e:
            log.warning("local range import failed; falling back to origin",
                        task=store.metadata.task_id[:16], error=str(e)[:200])
            return False
        return store.is_complete()

    async def _finalize_content_digest(self, req: FileTaskRequest,
                                       store) -> None:
        """The one completion-digest decision: none for a ranged task (the
        digest names the whole object); else skipped when every piece's
        verified-against digest matches a done parent's map (its own
        completion gate anchors the chain), or the whole-content re-hash,
        off the loop. A back-to-source task's piece digests are its own,
        so no certified chain can skip it."""
        if not LocalTaskStore.completion_digest_applies(
                req.meta.digest, req.range is not None):
            return
        if store.pieces_all_digest_verified():
            COMPLETION_REHASH.labels("skipped").inc()
        else:
            COMPLETION_REHASH.labels("hashed").inc()
            await asyncio.to_thread(store.validate_digest, req.meta.digest)
        store.metadata.digest = req.meta.digest

    async def _finalize_device(self, req: FileTaskRequest, task_id: str,
                               store) -> bool:
        """The device sink's completion for a ``device="tpu"`` request:
        backfill and the on-card check. An unavailable sink (no manager,
        its cap reached) leaves the result disk-only (False); a corrupt
        device copy raises DfError; the disk store stays valid either
        way."""
        if req.device != DEVICE_SINK:
            return False
        if self.device_sinks is None:
            log.warning("device=tpu requested but the daemon has no device "
                        "sink", task_id=task_id[:16])
            return False
        try:
            return await self.device_sinks.finalize(task_id, store) is not None
        except DeviceSinkError as e:
            self.device_sinks.discard(task_id)
            raise DfError(Code.ClientPieceDownloadFail,
                          f"device sink verification failed: {e}")

    async def _stream_progress(self, task: asyncio.Task,
                               progress_q: "_ProgressAggregator"):
        while True:
            snap = await progress_q.next_or_done(task)
            if snap is not None:
                yield snap
            if task.done():
                task.result()  # re-raise
                while (s := progress_q.try_next()) is not None:
                    yield s
                return


class _ProgressAggregator:
    def __init__(self, task_id: str, peer_id: str, store):
        self.task_id = task_id
        self.peer_id = peer_id
        self.store = store
        self._event = asyncio.Event()
        self._last_report = 0.0

    async def on_piece(self, store, rec) -> None:
        self._event.set()

    def _snapshot(self) -> FileTaskProgress:
        m = self.store.metadata
        return FileTaskProgress(
            state="running",
            task_id=self.task_id,
            peer_id=self.peer_id,
            content_length=m.content_length,
            completed_length=self.store.downloaded_bytes(),
            piece_count=len(m.pieces),
            total_piece_count=m.total_piece_count,
        )

    def try_next(self) -> FileTaskProgress | None:
        if self._event.is_set():
            self._event.clear()
            now = time.monotonic()
            if now - self._last_report >= 0.1:  # throttle progress frames
                self._last_report = now
                return self._snapshot()
        return None

    async def next_or_done(self, task) -> FileTaskProgress | None:
        waiter = asyncio.ensure_future(self._event.wait())
        try:
            await asyncio.wait({waiter, task},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            waiter.cancel()
        return self.try_next()
