"""The daemon's peer-facing drpc server: the port's copy of the peer
service in ``dragonfly2_tpu/daemon/rpcserver.py``, with the two methods a
child pulling from this daemon calls.

- ``Peer.SyncPieceTasks`` (a stream): the task's piece map at once (the
  landed pieces, the geometry, ``done``, the piece digests), then one
  message a broker event as pieces land, until the task is done; a failed
  download ends the stream with ``ClientPieceDownloadFail``. The
  child's ``{interested: true}`` keep-alives are read and dropped.
- ``Peer.GetPieceTasks`` (unary): the piece map once.

Not ported yet: the download service (``Daemon.*``, the unix socket dfget
attaches to) and the other peer methods (``Peer.TriggerDownloadTask``,
``Peer.StatTask``, ``Peer.DeleteTask``, the flight report). They come
with the daemon.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import RpcContext, Server, ServerStream


class DaemonRpcServer:
    def __init__(self, task_manager):
        self.task_manager = task_manager
        self.peer_server = Server("daemon.peer")
        self.peer_server.register_stream("Peer.SyncPieceTasks",
                                         self._sync_piece_tasks)
        self.peer_server.register_unary("Peer.GetPieceTasks",
                                        self._get_piece_tasks)

    async def serve_peer(self, addr: NetAddr) -> None:
        await self.peer_server.serve(addr)

    async def close(self) -> None:
        await self.peer_server.close()

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
