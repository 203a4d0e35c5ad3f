"""Peer: one (task, host) download with its lifecycle FSM. The port's copy
of ``dragonfly2_tpu/scheduler/resource/peer.py``.

States Pending, Received{Empty,Tiny,Small,Normal}, Running,
BackToSource, Succeeded, Failed and Leave; the finished-piece set; the
piece-cost window that bad-node detection reads; the parents a peer
refuses.
"""

from __future__ import annotations

import time
from collections import deque

from dragonfly2_tpu_torch.pkg.fsm import FSM, EventDesc
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.task import Task


class PeerState:
    PENDING = "pending"
    RECEIVED_EMPTY = "received_empty"
    RECEIVED_TINY = "received_tiny"
    RECEIVED_SMALL = "received_small"
    RECEIVED_NORMAL = "received_normal"
    RUNNING = "running"
    BACK_TO_SOURCE = "back_to_source"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    LEAVE = "leave"


_RECEIVED = (PeerState.RECEIVED_EMPTY, PeerState.RECEIVED_TINY,
             PeerState.RECEIVED_SMALL, PeerState.RECEIVED_NORMAL)

_PEER_EVENTS = [
    EventDesc("register_empty", (PeerState.PENDING,), PeerState.RECEIVED_EMPTY),
    EventDesc("register_tiny", (PeerState.PENDING,), PeerState.RECEIVED_TINY),
    EventDesc("register_small", (PeerState.PENDING,), PeerState.RECEIVED_SMALL),
    EventDesc("register_normal", (PeerState.PENDING,), PeerState.RECEIVED_NORMAL),
    EventDesc("download", _RECEIVED, PeerState.RUNNING),
    EventDesc("download_back_to_source", _RECEIVED + (PeerState.RUNNING,),
              PeerState.BACK_TO_SOURCE),
    EventDesc("download_succeeded",
              (PeerState.RUNNING, PeerState.BACK_TO_SOURCE,
               PeerState.RECEIVED_EMPTY, PeerState.RECEIVED_TINY, PeerState.RECEIVED_SMALL),
              PeerState.SUCCEEDED),
    EventDesc("download_failed", (PeerState.PENDING,) + _RECEIVED +
              (PeerState.RUNNING, PeerState.BACK_TO_SOURCE), PeerState.FAILED),
    EventDesc("leave", (PeerState.PENDING,) + _RECEIVED +
              (PeerState.RUNNING, PeerState.BACK_TO_SOURCE,
               PeerState.SUCCEEDED, PeerState.FAILED), PeerState.LEAVE),
]

# Sliding window size for piece-cost stats (bad-node detection —
# reference evaluator.go keeps the last piece costs on the peer/host).
PIECE_COST_WINDOW = 64


class Peer:
    def __init__(self, peer_id: str, task: Task, host: Host, *,
                 is_seed: bool = False, priority: int = 3, range_header: str = "",
                 disable_back_source: bool = False):
        self.id = peer_id
        self.task = task
        self.host = host
        self.is_seed = is_seed
        self.priority = priority
        self.range_header = range_header
        # Peer refuses origin fetches (dfcache export, --disable-back-source;
        # reference v2 RegisterPeerRequest Download.disableBackToSource).
        self.disable_back_source = disable_back_source
        self.fsm = FSM(PeerState.PENDING, _PEER_EVENTS)
        self.finished_pieces: set[int] = set()
        self.piece_costs: deque[int] = deque(maxlen=PIECE_COST_WINDOW)
        self.block_parents: set[str] = set()      # parents this peer refuses
        self.reschedule_count = 0
        # Striped slice broadcast: registered with the pod_broadcast flag
        # (scheduling/stripe.py), and the last stripe plan pushed to it —
        # membership changes re-push only when the plan differs.
        self.pod_broadcast = False
        self.stripe: dict | None = None
        self.created_at = time.time()
        self.updated_at = time.time()
        # live stream handle for pushing schedule responses (service layer)
        self.announce_stream = None

    @property
    def state(self) -> str:
        return self.fsm.current

    def touch(self) -> None:
        self.updated_at = time.time()

    def add_finished_piece(self, piece_num: int, cost_ms: int = 0) -> None:
        self.finished_pieces.add(piece_num)
        if cost_ms > 0:
            self.piece_costs.append(cost_ms)
        self.touch()

    def finished_piece_count(self) -> int:
        return len(self.finished_pieces)

    def is_done(self) -> bool:
        return self.fsm.current in (PeerState.SUCCEEDED, PeerState.FAILED, PeerState.LEAVE)

    def to_wire(self) -> dict:
        finished_sorted = sorted(self.finished_pieces)
        return {
            "id": self.id,
            "task_id": self.task.id,
            "host": self.host.to_wire(),
            "state": self.state,
            "finished_pieces": finished_sorted,
            # Digests for the LOWEST-numbered advertised pieces (from
            # this task's piece reports): children pull lowest-first, so
            # this covers the window before the parent's sync snapshot
            # arrives — assignments verify at landing instead of pulling
            # digest-blind. Bounded (not the full map): the snapshot
            # delivers the rest moments later, and a 25k-piece task must
            # not re-serialize 25k digests per candidate per reschedule.
            "piece_digests": {
                n: self.task.pieces[n].digest
                for n in finished_sorted[:512]
                if n in self.task.pieces and self.task.pieces[n].digest},
            "is_seed": self.is_seed,
            "priority": self.priority,
        }


class PeerManager:
    """In-memory peer registry with TTL GC (reference peer_manager.go)."""

    def __init__(self, ttl: float = 24 * 3600.0):
        self._peers: dict[str, Peer] = {}
        self._ttl = ttl

    def load(self, peer_id: str) -> Peer | None:
        return self._peers.get(peer_id)

    def load_or_store(self, peer: Peer) -> Peer:
        existing = self._peers.get(peer.id)
        if existing is not None:
            return existing
        self._peers[peer.id] = peer
        peer.task.add_peer(peer)
        peer.host.peer_ids.add(peer.id)
        return peer

    def delete(self, peer_id: str) -> None:
        peer = self._peers.pop(peer_id, None)
        if peer is not None:
            peer.task.delete_peer(peer_id)
            peer.host.peer_ids.discard(peer_id)

    def all(self) -> list[Peer]:
        return list(self._peers.values())

    def gc(self) -> list[str]:
        """TTL + terminal-state sweep (reference peer_manager.go RunGC:
        leave-state peers go immediately, stale peers by TTL)."""
        now = time.time()
        dead = []
        for p in self._peers.values():
            if p.fsm.current == PeerState.LEAVE:
                dead.append(p.id)
            elif (now - p.updated_at) > self._ttl:
                dead.append(p.id)
        for pid in dead:
            self.delete(pid)
        return dead
