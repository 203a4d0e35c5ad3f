"""Piece-task synchronizer, one drpc stream a parent announcing its
pieces: the port's copy of ``dragonfly2_tpu/daemon/peer/synchronizer.py``.

One ``SyncPieceTasks`` stream per parent; the piece infos it receives go
into the dispatcher, with the parent's own digests (its certified map once
it says done); a parent whose stream ends early is dropped.

Wire (drpc "Peer.SyncPieceTasks"):
  open_body: {task_id, src_peer_id (requester), dst_peer_id (parent)}
  parent → child: {pieces: [nums], total_piece_count, content_length,
                   piece_size, done}
  child → parent: {interested: true}   (keep-alive / request-more)
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import PieceDispatcher
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client

log = dflog.get("peer.synchronizer")


class PieceTaskSynchronizer:
    """Manages one sync stream per parent for a single conductor."""

    # Idle-stream keep-alive: a parent that announced everything it has
    # goes quiet while the child drains its assignment queue — that is a
    # HEALTHY stream, not a dead one. Instead of one fatal 60 s recv
    # timeout, recv in keep-alive-sized slices and send the documented
    # {interested: true} on each idle slice. Class attrs so tests can
    # shrink the cadence.
    KEEPALIVE_INTERVAL = 15.0

    def __init__(self, task_id: str, peer_id: str, dispatcher: PieceDispatcher,
                 own_slice: str = ""):
        self.task_id = task_id
        self.peer_id = peer_id
        self.dispatcher = dispatcher
        # This host's slice: parents advertising the same tpu_slice are
        # marked same_slice in the dispatcher (the stripe wanted set and
        # the locality byte accounting).
        self.own_slice = own_slice
        self._tasks: dict[str, asyncio.Task] = {}
        self._clients: dict[str, Client] = {}

    def sync_parents(self, parents: list[dict]) -> None:
        """Start or refresh sync streams for the scheduled parent set."""
        for parent in parents:
            peer_id = parent["id"]
            host = parent.get("host") or {}
            ip, port = host.get("ip", ""), host.get("port", 0)
            upload_port = host.get("upload_port", 0)
            if not ip or not port or not upload_port:
                log.warning("parent missing address", parent=peer_id[:24])
                continue
            parent_slice = host.get("tpu_slice", "") or ""
            self.dispatcher.upsert_parent(
                peer_id, ip, upload_port,
                same_slice=bool(self.own_slice)
                and parent_slice == self.own_slice,
                tpu_slice=parent_slice)
            # Seed known pieces from the schedule response, and the
            # relayed digests into the SHARED map only (no parent
            # attribution — relayed digests have no provenance and must
            # not be laundered into a parent's certified map): early
            # assignments then verify at landing, and certification still
            # requires the parent's own announced values to match.
            finished = parent.get("finished_pieces") or []
            if finished:
                self.dispatcher.on_parent_pieces(peer_id, finished)
                self.dispatcher.seed_shared_digests(
                    parent.get("piece_digests"))
            if peer_id not in self._tasks or self._tasks[peer_id].done():
                self._tasks[peer_id] = asyncio.ensure_future(
                    self._sync_one(peer_id, ip, port))

    async def _sync_one(self, parent_peer_id: str, ip: str, port: int) -> None:
        cli = self._clients.get(parent_peer_id)
        if cli is None:
            cli = Client(NetAddr.tcp(ip, port))
            self._clients[parent_peer_id] = cli
        try:
            stream = await cli.open_stream(
                "Peer.SyncPieceTasks",
                {"task_id": self.task_id, "src_peer_id": self.peer_id,
                 "dst_peer_id": parent_peer_id},
            )
            done = False
            while True:
                try:
                    msg = await stream.recv(timeout=self.KEEPALIVE_INTERVAL)
                except DfError as e:
                    if e.code != Code.RequestTimeout:
                        raise
                    # Idle slice, not a dead stream: the parent may simply
                    # have announced everything it holds. Keep the stream
                    # (and the parent) alive while the dispatcher still
                    # considers it usable; a parent the dispatcher blocked
                    # (failures, drop) has nothing left to say.
                    info = self.dispatcher.parents.get(parent_peer_id)
                    if info is None or info.blocked:
                        break
                    await stream.send({"interested": True})
                    continue
                if msg is None:
                    break
                self.dispatcher.on_parent_pieces(
                    parent_peer_id,
                    msg.get("pieces") or [],
                    msg.get("total_piece_count", -1),
                    msg.get("content_length", -1),
                    msg.get("piece_size", 0),
                    digests=msg.get("digests") or {},
                )
                if msg.get("done"):
                    # The parent passed its completion gate (seed: full
                    # digest validated) — its digest map can certify the
                    # child's re-hash-skip decision (provenance-checked).
                    self.dispatcher.note_parent_done(parent_peer_id)
                    done = True
                    break
            if not done:
                # Clean close without done: the parent went away mid-task; it
                # must not linger as an 'active' parent with a stale subset.
                log.info("sync stream closed early", parent=parent_peer_id[:24])
                self.dispatcher.drop_parent(parent_peer_id)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("sync stream lost", parent=parent_peer_id[:24], error=str(e))
            self.dispatcher.drop_parent(parent_peer_id)

    async def close(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        for t in self._tasks.values():
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for cli in self._clients.values():
            await cli.close()
        self._tasks.clear()
        self._clients.clear()
