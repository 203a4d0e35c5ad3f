"""The daemon's drpc servers: the port's copy of
``dragonfly2_tpu/daemon/rpcserver.py``.

The download service (``serve_download``: the unix socket dfget and
dfcache attach to, or any address):

- ``Daemon.Download`` (a stream): one file task's progress frames; with
  ``delta_base``, a delta task against that local base
  (``TaskManager.start_delta_task``, its base manifest built on the
  server's ``device``). ``output`` may be left out only for a device
  request (``device: "tpu"``); a range is made canonical here, and a bad
  one is refused with ``BadRequest``.
- ``Daemon.StatTask``: a local task's presence and completeness.
- ``Daemon.ImportTask``: a local file as a completed cache task
  (``dfcache://<cache_id>``), persistent when asked.
- ``Daemon.ExportTask`` (a stream): a cache task landed at ``output``,
  pulled over P2P when not local, never from an origin.
- ``Daemon.DeleteTask``: refused while the task runs or its store is
  pinned (a stream or an upload reads it).
- ``Daemon.Health``.

The peer service (``serve_peer``: other daemons and the scheduler):

- ``Peer.SyncPieceTasks`` (a stream): the task's piece map at once (the
  landed pieces, the geometry, ``done``, the piece digests), then one
  message a broker event as pieces land, until the task is done; a failed
  download ends the stream with ``ClientPieceDownloadFail``. The child's
  ``{interested: true}`` keep-alives are read and dropped.
- ``Peer.GetPieceTasks`` (unary): the piece map once.
- ``Peer.TriggerDownloadTask``: a scheduler's seed trigger, checked before
  the answer, then ``start_seed_task`` spawned; the answer is ``{ok,
  already_complete}``.
- ``Peer.StatTask``, ``Peer.DeleteTask`` and ``Daemon.Health``, as on the
  download service.

Not ported yet: ``Daemon.FlightReport`` and ``Daemon.PodTimeline`` (they
come with the flight recorder). Where the JAX ``DeleteTask`` also drops
the task from PEX, the port has no PEX.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    DEVICE_SINK,
    FileTaskRequest,
)
from dragonfly2_tpu_torch.pkg import aio
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.rpc import RpcContext, Server, ServerStream


class DaemonRpcServer:
    """``device``: where a delta task's base manifest is built
    (``default_device`` when it is: the card unless the daemon is asked
    for the CPU)."""

    def __init__(self, task_manager, *, device=None):
        self.task_manager = task_manager
        self.device = device
        self.download_server = Server("daemon.download")
        self.peer_server = Server("daemon.peer")
        d, p = self.download_server, self.peer_server
        d.register_stream("Daemon.Download", self._download)
        d.register_unary("Daemon.StatTask", self._stat_task)
        d.register_unary("Daemon.ImportTask", self._import_task)
        d.register_stream("Daemon.ExportTask", self._export_task)
        d.register_unary("Daemon.DeleteTask", self._delete_task)
        d.register_unary("Daemon.Health", self._health)
        p.register_stream("Peer.SyncPieceTasks", self._sync_piece_tasks)
        p.register_unary("Peer.GetPieceTasks", self._get_piece_tasks)
        p.register_unary("Peer.TriggerDownloadTask", self._trigger_download)
        p.register_unary("Peer.StatTask", self._stat_task)
        p.register_unary("Peer.DeleteTask", self._delete_task)
        p.register_unary("Daemon.Health", self._health)

    async def serve_download(self, addr: NetAddr) -> None:
        await self.download_server.serve(addr)

    async def serve_peer(self, addr: NetAddr) -> None:
        await self.peer_server.serve(addr)

    async def close(self) -> None:
        await self.download_server.close()
        await self.peer_server.close()

    # -- the download service ------------------------------------------------

    async def _download(self, stream: ServerStream, ctx: RpcContext) -> None:
        """One download; its progress frames stream back."""
        body = stream.open_body or {}
        url = body.get("url", "")
        output = body.get("output", "")
        device = body.get("device", "")
        # Only a device request may leave out the output: its result is in
        # device memory.
        if not url or (not output and device != DEVICE_SINK):
            raise DfError(Code.BadRequest, "url and output are required")
        req = FileTaskRequest(
            url=url, output=output, meta=UrlMeta.from_wire(body.get("meta")),
            disable_back_source=body.get("disable_back_source", False),
            device=device, pod_broadcast=bool(body.get("pod_broadcast")))
        if req.meta.range:
            # Canonical at the wire's chokepoint: the header is part of the
            # task's identity.
            try:
                req.meta.range = Range.normalize_header(req.meta.range)
                req.range = Range.parse_http(req.meta.range)
            except ValueError as e:
                raise DfError(Code.BadRequest,
                              f"bad range {req.meta.range!r}: {e}")
        delta_base = body.get("delta_base", "")
        if delta_base:
            progress_iter = self.task_manager.start_delta_task(
                req, delta_base, device=self.device)
        else:
            progress_iter = self.task_manager.start_file_task(req)
        async for progress in progress_iter:
            await stream.send(progress.to_wire())

    async def _stat_task(self, body, ctx: RpcContext):
        """A local task's presence and completeness."""
        task_id = (body or {}).get("task_id", "")
        store = self.task_manager.storage.try_get(task_id)
        if store is None:
            raise DfError(Code.PeerTaskNotFound, f"task {task_id} not found")
        m = store.metadata
        return {
            "task_id": m.task_id,
            "done": m.done,
            "content_length": m.content_length,
            "piece_count": len(m.pieces),
            "total_piece_count": m.total_piece_count,
            "digest": m.digest,
        }

    async def _import_task(self, body, ctx: RpcContext):
        """A local file as a completed cache task, announced."""
        body = body or {}
        path = body.get("path", "")
        if not path:
            raise DfError(Code.BadRequest, "path required")
        req = self._cache_request(body)
        return await self.task_manager.import_task(
            path, req,
            persistent=bool(body.get("persistent")),
            replica_count=int(body.get("replica_count", 1)),
            ttl=float(body.get("ttl", 0)))

    async def _export_task(self, stream: ServerStream, ctx: RpcContext) -> None:
        """A cache task landed at ``output``, pulled over P2P when it is
        not local, never from an origin."""
        body = stream.open_body or {}
        output = body.get("output", "")
        if not output:
            raise DfError(Code.BadRequest, "output required")
        req = self._cache_request(body)
        req.output = output
        req.disable_back_source = True
        async for progress in self.task_manager.start_file_task(req):
            await stream.send(progress.to_wire())

    @staticmethod
    def _cache_request(body: dict) -> FileTaskRequest:
        """A cache entry's task: the ``dfcache://`` URL of its cache id, so
        that import and export agree on the task id across hosts."""
        cache_id = body.get("cache_id", "")
        if not cache_id:
            raise DfError(Code.BadRequest, "cache_id required")
        meta = UrlMeta(tag=body.get("tag", ""),
                       application=body.get("application", ""),
                       digest=body.get("digest", ""))
        return FileTaskRequest(url=f"dfcache://{cache_id}", output="",
                               meta=meta)

    async def _delete_task(self, body, ctx: RpcContext):
        """Refused while the task runs or a stream or an upload pins its
        store, as the storage GC skips pinned stores."""
        task_id = (body or {}).get("task_id", "")
        if self.task_manager.is_task_running(task_id):
            return {"ok": False, "reason": "task running"}
        store = self.task_manager.storage.try_get(task_id)
        if store is not None and store.pinned:
            return {"ok": False, "reason": "task store in use"}
        self.task_manager.storage.delete_task(task_id)
        return {"ok": True}

    async def _health(self, body, ctx: RpcContext):
        return {"ok": True, "version": "0.1.0"}

    # -- the peer service ----------------------------------------------------

    def _piece_snapshot(self, task_id: str) -> dict | None:
        store = self.task_manager.storage.try_get(task_id)
        if store is None:
            return None
        m = store.metadata
        return {
            "pieces": sorted(m.pieces.keys()),
            "total_piece_count": m.total_piece_count,
            "content_length": m.content_length,
            "piece_size": m.piece_size,
            "done": m.done,
            "digests": {n: p.digest for n, p in m.pieces.items() if p.digest},
        }

    async def _sync_piece_tasks(self, stream: ServerStream,
                                ctx: RpcContext) -> None:
        """Serve a child the task's piece availability, pushing updates
        as pieces land."""
        body = stream.open_body or {}
        task_id = body.get("task_id", "")
        snapshot = self._piece_snapshot(task_id)
        running = self.task_manager.is_task_running(task_id)
        if snapshot is None and not running:
            raise DfError(Code.StorageTaskNotFound,
                          f"task {task_id} not on this peer")
        broker = self.task_manager.broker
        q = broker.subscribe(task_id)

        async def drain_keepalives() -> None:
            # Unread, the child's keep-alives would pool in the stream's
            # inbox for the download's lifetime.
            while await stream.recv() is not None:
                pass

        drainer = asyncio.ensure_future(drain_keepalives())
        try:
            if snapshot is not None:
                await stream.send(snapshot)
                if snapshot["done"]:
                    return
            while True:
                event = await q.get()
                if event.failed:
                    raise DfError(Code.ClientPieceDownloadFail,
                                  "parent download failed")
                await stream.send({
                    "pieces": event.piece_nums,
                    "total_piece_count": event.total_piece_count,
                    "content_length": event.content_length,
                    "piece_size": event.piece_size,
                    "done": event.done,
                    "digests": event.digests,
                })
                if event.done:
                    return
        finally:
            drainer.cancel()
            broker.unsubscribe(task_id, q)

    async def _get_piece_tasks(self, body, ctx: RpcContext):
        """One piece listing."""
        task_id = (body or {}).get("task_id", "")
        snapshot = self._piece_snapshot(task_id)
        if snapshot is None:
            raise DfError(Code.StorageTaskNotFound,
                          f"task {task_id} not on this peer")
        return snapshot

    async def _trigger_download(self, body, ctx: RpcContext):
        """A scheduler asks this daemon to seed a task."""
        spec = body or {}
        if not spec.get("url"):
            raise DfError(Code.BadRequest, "url required")
        if spec.get("range"):
            # Checked before the answer: a bad span would otherwise end the
            # spawned seed task while the trigger's caller waits for a
            # task that never existed.
            try:
                spec["range"] = Range.normalize_header(spec["range"])
            except ValueError as e:
                raise DfError(Code.BadRequest,
                              f"bad range {spec.get('range')!r}: {e}")
        task_id = spec.get("task_id", "")
        tm = self.task_manager
        already = bool(task_id and
                       tm.storage.find_completed_task(task_id) is not None)
        if (spec.get("device") == DEVICE_SINK
                or not (task_id and tm.is_task_running(task_id))):
            # Run even when complete: the seed re-reports its pieces so the
            # scheduler can hand it out as a parent. A device trigger always
            # runs: the seed task's dedup waits for a running seed and
            # then lands the device copy.
            aio.spawn(tm.start_seed_task(spec))
        return {"ok": True, "already_complete": already}
