"""The daemon's task manager: the port's copy of
``dragonfly2_tpu/daemon/peer/task_manager.py``.

``start_file_task`` runs a file task and yields its progress:

1. reuse of a completed local task (``from_reuse``);
2. a ranged request for a file whose slice a local parent task covers:
   exported from the parent (``output`` set, no device); on a miss, with
   ``prefetch``, the whole task starts in the background;
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

The other task kinds:

- ``start_delta_task``: a new version landed against a local base version
  (``delta/resolver.run_delta_task``); its base manifest, when none is
  published, is built on ``device``;
- ``start_seed_task``: a scheduler's trigger (``Peer.TriggerDownloadTask``):
  the task runs as a seed (or, with ``seed: False``, as a normal peer),
  its content digest is finalized before the announce, and a
  ``device: "tpu"`` trigger lands it in the device sink, where a device
  fault leaves the disk store standing;
- ``start_stream_task``: ordered bytes of a task (or of a range of it)
  as its pieces land, off a completed or covering store when there is
  one;
- ``import_task``: a local file as a completed task, announced to the
  scheduler; ``persistent=True`` also records it at the scheduler as a
  persistent cache task (``Scheduler.UploadPersistentCacheTask*``).

The wire value that asks for the device sink stays ``device="tpu"``, the
literal the JAX daemon tests for: the port's client sends it. A device
request lands in ``device_sinks`` (the port's ``DeviceSinkManager``);
corruption of the device copy fails the request with
``ClientPieceDownloadFail`` while the disk store stays complete and
reusable, and a kernel fault (``KernelError``) propagates, except on a
seed: a preheat has no requester to fail, so its disk store stands and the
fault is counted in ``peer_seed_device_failures_total{reason="kernel"}``.

PEX (``pex=``, a ``daemon/pex.PeerExchange``): with no scheduler, a task
that gossip says live members hold is pulled from them
(``_pex_download``: their piece maps over ``Peer.SyncPieceTasks``, the
pieces from their upload servers, four workers); a failed or holderless
PEX pull falls back to the origin unless ``disable_back_source``. Every
task kind announces its completed tasks over PEX (``_pex_announce``).
Intended divergence: a PEX pull records each piece's ``EV_LANDED`` (and
its dispatcher the parents it drops), which the JAX pull leaves out, so
that its flight's fold closes each piece's request.

The flight recorder (``flight=``, the process-wide
``pkg/flight.recorder()`` by default) holds a flight a task: its device
landing of each piece (``EV_HBM_START`` / ``EV_HBM_LANDED`` around the
sink), its completion re-hash (``EV_VERIFY_START`` / ``EV_VERIFIED``),
and on every terminal path of every task kind ``finish_task`` (done or
failed, with the error), which feeds ``peer_task_phase_seconds``. One
daemon-wide ``pkg/quarantine.ParentQuarantine`` (``quarantine``) is shared
by every conductor and PEX pull.

Bandwidth: every download rides the traffic shaper's limiter for its
task (``total_rate_limit`` split by ``traffic_shaper``, ``plain`` or
``sampling``; the daemon runs the shaper's ``serve()`` loop), as the JAX
task manager's do: the conductor's pieces, a PEX pull's and the origin's.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import AsyncIterator

from dragonfly2_tpu_torch.daemon.peer.broker import PieceBroker, PieceEvent
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkError
from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import (
    PieceDispatcher,
    parent_key,
)
from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
    PieceDownloader,
    failure_reason,
    is_parent_gone,
    pull_one_piece,
)
from dragonfly2_tpu_torch.daemon.peer.piece_manager import PieceManager
from dragonfly2_tpu_torch.daemon.peer.synchronizer import (
    PieceTaskSynchronizer,
)
from dragonfly2_tpu_torch.daemon.peer.traffic_shaper import TrafficShaper
from dragonfly2_tpu_torch.ops._build import KernelError
from dragonfly2_tpu_torch.pkg import aio, dflog, idgen, metrics
from dragonfly2_tpu_torch.pkg import flight as flightlib
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
from dragonfly2_tpu_torch.pkg.quarantine import ParentQuarantine
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

# A seed's device copy that failed to land or verify: "kernel" for a fault
# of the port's own kernels, "device" for any other. The disk warm-up
# stands either way, so only this count tells a broken kernel apart.
SEED_DEVICE_FAILURES = metrics.counter(
    "peer_seed_device_failures_total",
    "Seed device-copy finalize failures (the disk warm-up stands)",
    ("reason",))


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
class StreamTaskRequest:
    """A stream task: ordered bytes as the pieces land. The task id leaves
    the range out, so ranged readers of one object share one
    whole-content task."""

    url: str
    meta: UrlMeta = field(default_factory=UrlMeta)
    peer_id: str = ""
    range: Range | None = None          # the bytes to emit (None: all)
    disable_back_source: bool = False

    def task_id(self) -> str:
        return idgen.task_id_v1(
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
    """The front end of file, delta, seed and stream tasks: reuse, dedup,
    the download (P2P or the origin) and the device sink."""

    def __init__(
        self,
        storage: StorageManager,
        piece_manager: PieceManager,
        *,
        host_ip: str = "127.0.0.1",
        scheduler_client=None,
        conductor_factory=None,
        total_rate_limit: int = 0,
        host_wire=None,
        traffic_shaper: str = "plain",
        pex=None,
        prefetch: bool = False,
        device_sinks=None,
        flight=None,
    ):
        self.storage = storage
        self.piece_manager = piece_manager
        # The device terminal store (daemon/peer/device_sink's
        # DeviceSinkManager), chosen per task by FileTaskRequest.device.
        self.device_sinks = device_sinks
        # A ranged request that misses also starts the whole task in the
        # background, so that the next overlapping range hits its store.
        self.prefetch = prefetch
        self.host_ip = host_ip
        self.scheduler_client = scheduler_client
        # conductor_factory(task_id=, peer_id=, request=, store=,
        # on_piece=, is_seed=, limiter=) -> a conductor with run() and
        # from_p2p (daemon/peer/conductor.conductor_factory).
        self.conductor_factory = conductor_factory
        # () -> the host's AnnounceHost-shaped dict: the identity imported
        # tasks are announced under.
        self.host_wire = host_wire
        # Gossip peer exchange: schedulerless discovery of the holders of
        # a task, and this host's own possession list.
        self.pex = pex
        # One decaying-penalty registry for every conductor and PEX pull,
        # keyed by a parent's serving endpoint.
        self.quarantine = ParentQuarantine()
        # The daemon's download bandwidth, shared among its tasks.
        self.shaper = TrafficShaper(
            total_rate_limit if total_rate_limit > 0 else float("inf"),
            algorithm=traffic_shaper)
        # The bounded task index of flights; tests inject one a daemon.
        self.flight = flight if flight is not None else flightlib.recorder()
        self.broker = PieceBroker()
        self._running: dict[str, _RunningTask] = {}
        # The last delta landing's accounting by task id, and its host
        # seconds by phase (delta/resolver.py writes both, 256 at most).
        self.delta_stats: dict[str, dict] = {}
        self.delta_timings: dict[str, dict] = {}

    # -- the download core -------------------------------------------------

    async def _run_download(self, task_id: str, peer_id: str,
                            req: FileTaskRequest, store,
                            progress_q: "_ProgressAggregator | None",
                            *, is_seed: bool = False) -> bool:
        """Download into ``store``; returns from_p2p. Each piece is
        published on the broker and, for a device request, landed in the
        device sink as it arrives. ``is_seed``: the conductor registers
        the task as a seed's."""
        # Ranged tasks land too: the store's piece grid is slice-relative,
        # so the sink's geometry is the slice's (download_sharded).
        sink_wanted = req.device == DEVICE_SINK and self.device_sinks is not None
        tf = self.flight.task(task_id)

        async def on_piece(st, rec) -> None:
            m = st.metadata
            self.broker.publish(task_id, PieceEvent(
                [rec.num], m.total_piece_count, m.content_length, m.piece_size,
                digests={rec.num: rec.digest}))
            if sink_wanted:
                tf.record(flightlib.EV_HBM_START, rec.num)
                await self.device_sinks.on_piece(task_id, st, rec)
                tf.record(flightlib.EV_HBM_LANDED, rec.num)
            if progress_q is not None:
                await progress_q.on_piece(st, rec)

        limiter = self.shaper.start_task(task_id)
        try:
            if (self.scheduler_client is not None
                    and self.conductor_factory is not None):
                conductor = self.conductor_factory(
                    task_id=task_id, peer_id=peer_id, request=req,
                    store=store, on_piece=on_piece, is_seed=is_seed,
                    limiter=limiter)
                await conductor.run()
                return conductor.from_p2p
            if self.pex is not None:
                # No scheduler: gossip may name holders. A failed pull
                # (stale holders, a stall) falls back to the origin when
                # allowed.
                try:
                    if await self._pex_download(task_id, peer_id, store,
                                                on_piece, limiter):
                        return True
                except DfError as e:
                    if req.disable_back_source:
                        raise
                    log.warning("pex download failed, falling back to "
                                "source", task_id=task_id[:16], error=str(e))
            # A ranged task whose slice a local parent covers imports it
            # without touching the origin (allowed even with the origin off
            # the table).
            if await self.import_range_from_local_parent(store, req,
                                                         on_piece):
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
                content_range=req.range, on_piece=on_piece, limiter=limiter)
            return False
        finally:
            self.shaper.finish_task(task_id)

    async def _pex_download(self, task_id: str, peer_id: str, store,
                            on_piece, limiter) -> bool:
        """Pull every piece from the holders gossip names, with no
        scheduler: their piece maps over ``Peer.SyncPieceTasks``, one GET
        a piece, four workers, failures penalized in the quarantine. False
        when gossip knows no live holder; raises when the pull stalls or
        ends incomplete."""
        holders = [m for m in self.pex.find_holders(task_id)
                   if m.peer_port and m.upload_port]
        if not holders:
            return False
        tf = self.flight.task(task_id)
        dispatcher = PieceDispatcher(quarantine=self.quarantine, flight=tf)
        synchronizer = PieceTaskSynchronizer(task_id, peer_id, dispatcher)
        downloader = PieceDownloader()
        dispatcher.mark_known_downloaded(store.metadata.pieces.keys())
        synchronizer.sync_parents([
            {"id": m.node_id,
             "host": {"ip": m.ip, "port": m.peer_port,
                      "upload_port": m.upload_port}}
            for m in holders])
        log.info("pex download", task_id=task_id[:16], holders=len(holders))

        async def worker() -> None:
            while not dispatcher.is_complete():
                assignment = await dispatcher.get(timeout=15.0)
                if assignment is None:
                    if dispatcher.is_complete():
                        return
                    raise DfError(Code.ClientPieceDownloadFail,
                                  "pex download stalled (no usable holders)")
                try:
                    rec = await pull_one_piece(
                        downloader, store, dispatcher, assignment,
                        task_id=task_id, peer_id=peer_id, limiter=limiter)
                except DfError as e:
                    dispatcher.report_failure(assignment,
                                              parent_gone=is_parent_gone(e))
                    self.quarantine.penalize(parent_key(assignment.parent),
                                             failure_reason(e))
                    continue
                dispatcher.report_success(assignment, rec.cost_ms)
                # The landing closes the piece's request in the flight's
                # fold (the JAX PEX pull records none, and its fold counts
                # every request as open to the end).
                tf.record(flightlib.EV_LANDED, assignment.piece_num,
                          float(rec.cost_ms), "unlabeled")
                await on_piece(store, rec)

        try:
            workers = [asyncio.ensure_future(worker()) for _ in range(4)]
            try:
                await asyncio.gather(*workers)
            except BaseException:
                for w in workers:
                    w.cancel()
                await asyncio.gather(*workers, return_exceptions=True)
                raise
        finally:
            await synchronizer.close()
            await downloader.close()
        if not dispatcher.is_complete():
            raise DfError(Code.ClientPieceDownloadFail,
                          "pex download incomplete")
        if (store.metadata.content_length < 0
                and dispatcher.content_length >= 0):
            store.update_task(content_length=dispatcher.content_length)
        return True

    def _pex_announce(self, task_id: str) -> None:
        if self.pex is not None:
            self.pex.add_task(task_id)

    # -- import (dfcache) --------------------------------------------------

    async def import_task(self, path: str, req: FileTaskRequest, *,
                          persistent: bool = False, replica_count: int = 1,
                          ttl: float = 0.0) -> dict:
        """Import a local file as a completed task and announce it to the
        scheduler. With ``persistent``, the scheduler also records it as a
        persistent cache task replicated to ``replica_count`` hosts:
        ``...Started`` before the import, then ``...Finished``, or
        ``...Failed`` (best effort) when the import fails. Without a
        scheduler connection that raises ``DfError(BadRequest)``."""
        task_id = req.task_id()
        peer_id = req.peer_id or idgen.peer_id_v1(self.host_ip)
        if persistent:
            await self._persistent_call(
                "Scheduler.UploadPersistentCacheTaskStarted", task_id, peer_id,
                {"url": req.url, "tag": req.meta.tag,
                 "application": req.meta.application,
                 "replica_count": replica_count, "ttl": ttl,
                 "digest": req.meta.digest})
        try:
            result = await self._import_local(path, req, task_id, peer_id)
        except BaseException:
            if persistent:
                try:
                    # A scheduler error here must not mask the import's.
                    await self._persistent_call(
                        "Scheduler.UploadPersistentCacheTaskFailed",
                        task_id, peer_id, {})
                except Exception as notify_err:
                    log.warning("persistent-failed notify failed",
                                error=str(notify_err))
            raise
        if persistent:
            await self._persistent_call(
                "Scheduler.UploadPersistentCacheTaskFinished", task_id, peer_id,
                {"content_length": result["content_length"],
                 "piece_size": result.get("piece_size", 0),
                 "total_piece_count": result.get("total_piece_count", -1)})
        return result

    async def _persistent_call(self, method: str, task_id: str, peer_id: str,
                               extra: dict) -> None:
        if self.scheduler_client is None:
            raise DfError(Code.BadRequest,
                          "persistent import needs a scheduler connection")
        host_info = dict(self.host_wire()) if self.host_wire is not None \
            else {}
        host_info.pop("telemetry", None)
        await self.scheduler_client.unary(
            task_id, method,
            {"task_id": task_id, "peer_id": peer_id,
             "host": host_info, **extra})

    async def _import_local(self, path: str, req: FileTaskRequest,
                            task_id: str, peer_id: str) -> dict:
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
                    self._pex_announce(task_id)
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
            # A miss: the ranged task fetches its slice below, and with
            # prefetch the whole task starts in the background.
            self._maybe_prefetch(req.parent_task_id(), req)

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
            self.flight.finish_task(task_id, "done")
            self._pex_announce(task_id)
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
                       DfError(Code.UnknownError, describe(e)),
                       note=describe(e))
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
              run: _RunningTask, error: DfError, note: str = "") -> None:
        """A task's failure: the sink discarded, the store invalid, the
        flight finished as failed (``note``: the error's text), waiters
        told."""
        self._discard_sink(req, task_id)
        store.mark_invalid()
        run.error = error
        self.flight.finish_task(task_id, "failed", note=note or str(error))
        self.broker.publish(task_id, PieceEvent([], failed=True))

    # -- delta task (delta/resolver.py) -------------------------------------

    async def start_delta_task(self, req: FileTaskRequest, base_task_id: str,
                               *, device=None
                               ) -> AsyncIterator[FileTaskProgress]:
        """Land ``req`` as a delta against the local base task: chunks the
        base holds are copied (and digest-checked) locally, only changed
        chunks cross the wire as ranged tasks. Degrades to a plain
        ``start_file_task`` when the delta path is not viable (no base, no
        published manifest, no overlap). A base manifest that was never
        published is built on ``device`` (``default_device``: the card
        unless the caller asks for the CPU)."""
        from dragonfly2_tpu_torch.delta.resolver import run_delta_task

        # aclosing: an early close reaches the delta's own cleanup at once.
        async with contextlib.aclosing(run_delta_task(
                self, req, base_task_id, device=device)) as it:
            async for p in it:
                yield p

    # -- seed task (a scheduler's trigger) ---------------------------------

    async def start_seed_task(self, spec: dict) -> None:
        """Seed this daemon with a task, as a scheduler's
        ``Peer.TriggerDownloadTask`` asks. Runs inline: callers spawn it."""
        try:
            # The canonical range before anything hashes it, so that the
            # warmed store has the task id of a client's pull of the span.
            # It runs spawned, where an escape would go unretrieved.
            norm_range = Range.normalize_header(spec.get("range", ""))
        except ValueError as e:
            log.warning("seed trigger with malformed range dropped",
                        range=str(spec.get("range"))[:64], error=str(e)[:100])
            return
        meta = UrlMeta(
            digest=spec.get("digest", ""),
            tag=spec.get("tag", ""),
            application=spec.get("application", ""),
            header=spec.get("header") or {},
            filter="&".join(spec.get("filters") or []),
            range=norm_range,
            # A preheat keeps its caller's tenant and priority.
            priority=int(spec.get("priority", 3) or 3),
            tenant=spec.get("tenant", ""),
        )
        # seed=False: run as a normal peer that pulls from peers (the
        # replication of a persistent cache task, which has no origin).
        is_seed = spec.get("seed", True)
        req = FileTaskRequest(url=spec.get("url", ""), output="", meta=meta,
                              disable_back_source=bool(
                                  spec.get("disable_back_source")),
                              device=spec.get("device", ""),
                              pod_broadcast=bool(spec.get("pod_broadcast")))
        if meta.range:
            req.range = Range.parse_http(meta.range)
        task_id = spec.get("task_id") or req.task_id()
        running = self._running.get(task_id)
        if running is not None:
            # Already seeding. The device is not part of the task's
            # identity, so a device trigger waits for the running seed
            # and then lands its content in the sink.
            if req.device != DEVICE_SINK:
                return
            await running.done.wait()
            if running.error is None:
                store = self.storage.find_completed_task(task_id)
                if store is not None:
                    await self._finalize_device_for_seed(req, task_id, store)
            return
        peer_id = (idgen.seed_peer_id_v1(self.host_ip) if is_seed
                   else idgen.peer_id_v1(self.host_ip))
        store = self.storage.register_task(TaskStoreMetadata(
            task_id=task_id, peer_id=peer_id, url=req.url, tag=meta.tag,
            application=meta.application, header=dict(meta.header)))
        run = _RunningTask(store)
        self._running[task_id] = run
        store.pin()
        try:
            await self._run_download(task_id, peer_id, req, store, None,
                                     is_seed=is_seed)
            # The seed anchors the piece-digest chain: its origin pieces
            # carry self-computed digests, so the whole content is proven
            # here, before the announce.
            await self._finalize_content_digest(req, store)
            store.mark_done()
            self.flight.finish_task(task_id, "done")
            # The disk result is final: announce and publish it first (the
            # device copy cannot change it), then land the device copy.
            self._pex_announce(task_id)
            m = store.metadata
            self.broker.publish(task_id, PieceEvent(
                [], m.total_piece_count, m.content_length, m.piece_size,
                done=True))
            device_verified = await self._finalize_device_for_seed(
                req, task_id, store)
            log.info("seed task complete", task_id=task_id[:16],
                     pieces=len(store.metadata.pieces),
                     **({"device_verified": device_verified}
                        if req.device else {}))
        except Exception as e:
            log.error("seed task failed", error=describe(e))
            self._fail(req, task_id, store, run,
                       e if isinstance(e, DfError)
                       else DfError(Code.UnknownError, describe(e)),
                       note=describe(e))
        finally:
            store.unpin()
            run.done.set()
            self._running.pop(task_id, None)

    async def _finalize_device_for_seed(self, req: FileTaskRequest,
                                        task_id: str, store) -> bool:
        """``_finalize_device`` for a seed: a device fault must not fail
        the task, whose disk store is digest-checked and served to peers
        (a preheat has no requesting stream to fail). The partial sink is
        discarded, the warm-up stays disk-only, and the fault is counted
        in ``peer_seed_device_failures_total`` (``kernel`` for a
        ``KernelError``)."""
        try:
            with store:   # pinned: the finalize reads run in a worker
                return await self._finalize_device(req, task_id, store)
        except Exception as e:
            if self.device_sinks is not None:
                self.device_sinks.discard(task_id)
            reason = "kernel" if isinstance(e, KernelError) else "device"
            SEED_DEVICE_FAILURES.labels(reason).inc()
            log.error("device sink finalize failed; disk warm-up stands",
                      task_id=task_id[:16], reason=reason, error=describe(e))
            return False

    # -- stream task ---------------------------------------------------------

    class _StreamBody:
        """An ordered stream body that releases its broker subscription
        even when closed before its first iteration (the ``finally`` of
        an unstarted async generator never runs)."""

        def __init__(self, broker, task_id: str, gen, q):
            self._broker = broker
            self._task_id = task_id
            self._gen = gen
            self._q = q

        def __aiter__(self):
            return self

        async def __anext__(self):
            return await self._gen.__anext__()

        async def aclose(self) -> None:
            try:
                await self._gen.aclose()
            finally:
                # Idempotent: a started generator unsubscribes too.
                self._broker.unsubscribe(self._task_id, self._q)

    async def start_stream_task(self, req: StreamTaskRequest):
        """Returns (attrs, body): ``attrs`` carries the task and peer ids,
        ``content_length`` (-1 while an origin of unknown length runs),
        the geometry, ``from_reuse``, the resolved ``range`` and the
        ``local_store`` a gateway can serve a landed window from; ``body``
        yields the ordered bytes as the pieces land."""
        task_id = req.task_id()
        peer_id = req.peer_id or idgen.peer_id_v1(self.host_ip)

        store = self.storage.find_completed_task(task_id)
        if store is not None:
            return self._stream_reuse(store, task_id, peer_id, req.range)

        # A range the landed pieces of a running or partial task cover is
        # served off its store.
        if req.range is not None:
            partial = self.storage.find_partial_completed_task(task_id)
            if partial is not None and partial.metadata.piece_size > 0:
                rng = self._resolve_range(req.range,
                                          partial.metadata.content_length)
                if (rng is not None and rng.length > 0
                        and partial.covers_range(rng.start, rng.length)):
                    attrs = self._stream_attrs(partial, task_id, peer_id,
                                               from_reuse=True)
                    attrs["range"] = rng
                    attrs["local_store"] = partial
                    return attrs, self._stream_from_store(partial, rng)

        q = self.broker.subscribe(task_id)
        run = self._running.get(task_id)
        if run is None:
            # The task may have completed between the reuse check and the
            # subscription.
            store = self.storage.find_completed_task(task_id)
            if store is not None:
                self.broker.unsubscribe(task_id, q)
                return self._stream_reuse(store, task_id, peer_id, req.range)
            file_req = FileTaskRequest(
                url=req.url, output="", meta=req.meta, peer_id=peer_id,
                disable_back_source=req.disable_back_source)
            store = self.storage.register_task(TaskStoreMetadata(
                task_id=task_id, peer_id=peer_id, url=req.url,
                tag=req.meta.tag, application=req.meta.application,
                header=dict(req.meta.header)))
            run = _RunningTask(store)
            self._running[task_id] = run
            store.pin()
            aio.spawn(self._run_background_download(task_id, peer_id,
                                                    file_req, store, run))
        else:
            store = run.store

        # Wait for enough to answer headers: the length, the first piece
        # or the end.
        try:
            while (store.metadata.content_length < 0
                   and not store.has_piece(0)
                   and run.error is None and not run.done.is_set()):
                ev = await q.get()
                if ev.failed:
                    break
        except asyncio.CancelledError:
            self.broker.unsubscribe(task_id, q)
            raise
        if run.error is not None:
            self.broker.unsubscribe(task_id, q)
            raise run.error
        attrs = self._stream_attrs(store, task_id, peer_id)
        rng = self._resolve_range(req.range, attrs["content_length"])
        attrs["range"] = rng
        attrs["local_store"] = store
        return attrs, self._StreamBody(
            self.broker, task_id,
            self._stream_ordered(task_id, store, run, q, rng), q)

    def _stream_reuse(self, store, task_id: str, peer_id: str,
                      rng: Range | None):
        """(attrs, body) of a completed store."""
        attrs = self._stream_attrs(store, task_id, peer_id, from_reuse=True)
        rng = self._resolve_range(rng, attrs["content_length"])
        attrs["range"] = rng
        attrs["local_store"] = store
        return attrs, self._stream_from_store(store, rng)

    @staticmethod
    def _resolve_range(rng: Range | None, content_length: int) -> Range | None:
        """An open range (``bytes=N-``, length -1) ends at the content's
        end once the length is known; before, it means "to EOF"."""
        if rng is not None and rng.length < 0 and content_length >= 0:
            return Range(rng.start, max(0, content_length - rng.start))
        return rng

    def _maybe_prefetch(self, parent_id: str, req: FileTaskRequest) -> None:
        """Start the whole task in the background after a ranged miss."""
        if not self.prefetch or parent_id in self._running:
            return
        if self.storage.find_completed_task(parent_id) is not None:
            return
        meta = dataclasses.replace(req.meta, range="",
                                   header=dict(req.meta.header))
        meta.header.pop("Range", None)
        peer_id = idgen.peer_id_v1(self.host_ip)
        file_req = FileTaskRequest(url=req.url, output="", meta=meta,
                                   peer_id=peer_id)
        store = self.storage.register_task(TaskStoreMetadata(
            task_id=parent_id, peer_id=peer_id, url=req.url, tag=meta.tag,
            application=meta.application, header=dict(meta.header)))
        run = _RunningTask(store)
        self._running[parent_id] = run
        store.pin()
        log.info("prefetching whole task for ranged request",
                 task=parent_id[:16])
        aio.spawn(self._run_background_download(parent_id, peer_id,
                                                file_req, store, run))

    async def _run_background_download(self, task_id: str, peer_id: str,
                                       req: FileTaskRequest, store,
                                       run: _RunningTask) -> None:
        """The download of a stream task or a prefetch: no output, no
        progress; its end is seen through the broker."""
        try:
            await self._run_download(task_id, peer_id, req, store, None)
            await self._finalize_content_digest(req, store)
            store.mark_done()
            self.flight.finish_task(task_id, "done")
            self._pex_announce(task_id)
            m = store.metadata
            self.broker.publish(task_id, PieceEvent(
                [], m.total_piece_count, m.content_length, m.piece_size,
                done=True))
        except DfError as e:
            self._fail(req, task_id, store, run, e)
        except Exception as e:
            log.error("stream download crashed", exc_info=True)
            self._fail(req, task_id, store, run,
                       DfError(Code.UnknownError, describe(e)),
                       note=describe(e))
        finally:
            store.unpin()
            run.done.set()
            self._running.pop(task_id, None)

    def _stream_attrs(self, store, task_id: str, peer_id: str, *,
                      from_reuse: bool = False) -> dict:
        m = store.metadata
        return {
            "task_id": task_id,
            "peer_id": peer_id,
            "content_length": m.content_length,
            "piece_size": m.piece_size,
            "total_piece_count": m.total_piece_count,
            "from_reuse": from_reuse,
        }

    # The most one coalesced read of a stream yields.
    _STREAM_SPAN = 8 << 20

    async def _stream_from_store(self, store,
                                 rng: Range | None) -> AsyncIterator:
        """A landed window off the store in reads of at most a piece (1 MiB
        at least). Each chunk is a pooled view, valid until the consumer
        asks for the next one."""
        store.pin()
        try:
            m = store.metadata
            end = m.content_length if m.content_length >= 0 else \
                store.disk_usage()
            start = 0
            if rng is not None:
                start = min(rng.start, end)
                if rng.length >= 0:
                    end = min(end, rng.start + rng.length)
            span = max(m.piece_size, 1 << 20)
            off = start
            while off < end:
                take = min(span, end - off)
                chunk = await asyncio.to_thread(store.read_range, off, take)
                try:
                    yield chunk
                finally:
                    release_read_buffer(chunk)
                off += take
        finally:
            store.unpin()

    async def _stream_ordered(self, task_id: str, store, run: _RunningTask,
                              q: asyncio.Queue,
                              rng: Range | None) -> AsyncIterator:
        """A running task's pieces in order as they land: adjacent landed
        pieces are read as one span of at most ``_STREAM_SPAN``; a piece
        ahead of the frontier waits until the gap fills. Each chunk is a
        pooled view, valid until the consumer asks for the next one."""
        next_num = 0
        store.pin()
        try:
            while True:
                m = store.metadata
                while store.has_piece(next_num):
                    # Pieces wholly before the range only move the frontier.
                    if (rng is not None and m.piece_size > 0
                            and (next_num + 1) * m.piece_size <= rng.start):
                        next_num += 1
                        continue
                    first = m.pieces[next_num]
                    lo, hi = first.offset, first.offset + first.size
                    last = next_num
                    while hi - lo < self._STREAM_SPAN:
                        nxt = m.pieces.get(last + 1)
                        if nxt is None:
                            break
                        if rng is not None and rng.length >= 0 and \
                                hi >= rng.start + rng.length:
                            break
                        hi = nxt.offset + nxt.size
                        last = nxt.num
                    if rng is not None:
                        lo = max(lo, rng.start)
                        if rng.length >= 0:
                            hi = min(hi, rng.start + rng.length)
                    if hi > lo:
                        chunk = await asyncio.to_thread(
                            store.read_range, lo, hi - lo)
                        try:
                            yield chunk
                        finally:
                            release_read_buffer(chunk)
                    next_num = last + 1
                    # Past the range: nothing more to emit (an open range
                    # runs to the end).
                    if rng is not None and rng.length >= 0 and \
                            m.piece_size > 0 and \
                            next_num * m.piece_size >= rng.start + rng.length:
                        return
                if run.error is not None:
                    raise run.error
                if m.total_piece_count >= 0 and \
                        next_num >= m.total_piece_count:
                    return
                if run.done.is_set() and not store.has_piece(next_num):
                    raise DfError(Code.UnknownError,
                                  "stream task ended short")
                ev = await q.get()
                if ev.failed and run.error is not None:
                    raise run.error
        finally:
            store.unpin()
            self.broker.unsubscribe(task_id, q)

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
            tf = self.flight.task(store.metadata.task_id)
            tf.record(flightlib.EV_VERIFY_START)
            await asyncio.to_thread(store.validate_digest, req.meta.digest)
            tf.record(flightlib.EV_VERIFIED)
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
