"""Task: one content being distributed, holding the peer DAG. The port's
copy of ``dragonfly2_tpu/scheduler/resource/task.py``.

The FSM Pending, Running, Succeeded, Failed and Leave; the peer DAG and
its edges' upload-slot accounting; the size scope; back-to-source
accounting. One divergence: ``Task(rng=)`` hands its DAG the generator
its candidate sampling draws from (``pkg/dag.py``).
"""

from __future__ import annotations

import asyncio
import random
import time

from dragonfly2_tpu_torch.pkg.dag import DAG
from dragonfly2_tpu_torch.pkg.fsm import FSM, EventDesc
from dragonfly2_tpu_torch.pkg.piece import PieceInfo, SizeScope


class TaskState:
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    LEAVE = "leave"


_TASK_EVENTS = [
    EventDesc("download", (TaskState.PENDING, TaskState.FAILED, TaskState.SUCCEEDED), TaskState.RUNNING),
    EventDesc("download_succeeded", (TaskState.RUNNING, TaskState.FAILED), TaskState.SUCCEEDED),
    EventDesc("download_failed", (TaskState.RUNNING,), TaskState.FAILED),
    EventDesc("leave", (TaskState.PENDING, TaskState.RUNNING, TaskState.SUCCEEDED, TaskState.FAILED),
              TaskState.LEAVE),
]


class Task:
    def __init__(self, task_id: str, url: str = "", *, tag: str = "", application: str = "",
                 digest: str = "", filtered_query_params: list[str] | None = None,
                 header: dict | None = None, back_to_source_limit: int = 200,
                 range_header: str = "", tenant: str = "",
                 rng: random.Random | None = None):
        self.id = task_id
        self.url = url
        self.tag = tag
        self.application = application
        # QoS attribution tag (dragonfly2_tpu/qos): who this content is
        # being pulled FOR. Not part of task identity — two tenants
        # pulling the same content share the task; the first registrant's
        # tenant wins attribution (later ones backfill an empty tag).
        self.tenant = tenant
        self.digest = digest
        self.filtered_query_params = filtered_query_params or []
        self.header = header or {}
        # Ranged task (the id encodes it): a triggered seed must fetch
        # exactly this slice, or its store would hold the whole object
        # under the ranged id.
        self.range_header = range_header
        self.content_length = -1
        self.piece_size = 0
        self.total_piece_count = -1
        self.pieces: dict[int, PieceInfo] = {}   # known piece metadata
        # Tiny-task content (≤128 B), inlined in register responses once a
        # finisher uploads it (reference task.go:133 DirectPiece).
        self.direct_piece: bytes = b""
        self.fsm = FSM(TaskState.PENDING, _TASK_EVENTS)
        self.dag: DAG = DAG(rng)                 # peer tree: parent → child
        self.back_to_source_limit = back_to_source_limit
        self.back_to_source_peers: set[str] = set()
        self.created_at = time.time()
        self.updated_at = time.time()
        # Parent-availability wakeup: schedulers waiting for a usable
        # parent block on this instead of poll-sleeping (reference polls
        # at RetryInterval=500ms — scheduler/config/constants.go:68-70;
        # event-driven cuts first-piece latency to the actual arrival).
        self._parents_event = asyncio.Event()
        # ICI locality index: slice name → peer ids on that slice, so
        # candidate sampling can prefer same-slice parents instead of
        # relying on a random DAG sample to contain one (at 16 hosts per
        # slice in a 256-host pod the random base rate is ~6%).
        self.slice_index: dict[str, set[str]] = {}
        # Seed membership index (is_seed is fixed at peer construction):
        # the scheduler's seed-active probe runs inside every schedule
        # loop iteration and must not scan the whole peer DAG for the
        # usually-zero seeds.
        self.seed_peer_ids: set[str] = set()

    def notify_parents_changed(self) -> None:
        """Wake every scheduler retry-loop waiting on this task: a peer
        gained its first piece, finished, or released upload slots."""
        event, self._parents_event = self._parents_event, asyncio.Event()
        event.set()

    async def wait_parents_changed(self, timeout: float) -> None:
        """Wait until parent availability may have changed, at most
        ``timeout`` seconds (the poll interval becomes an upper bound)."""
        event = self._parents_event
        try:
            await asyncio.wait_for(event.wait(), timeout)
        except (asyncio.TimeoutError, TimeoutError):
            pass

    # -- state -------------------------------------------------------------

    @property
    def state(self) -> str:
        return self.fsm.current

    def touch(self) -> None:
        self.updated_at = time.time()

    def size_scope(self) -> str:
        return SizeScope.of(self.content_length, self.piece_size, self.total_piece_count)

    def has_available_peer(self, blocklist: set[str] | None = None) -> bool:
        """Any finished/running peer that could serve pieces
        (reference task.go HasAvailablePeer)."""
        blocklist = blocklist or set()
        from dragonfly2_tpu_torch.scheduler.resource.peer import PeerState

        serving = (PeerState.RUNNING, PeerState.BACK_TO_SOURCE,
                   PeerState.SUCCEEDED)

        def _available(peer) -> bool:
            if peer.id in blocklist:
                return False
            if peer.fsm.current in serving and peer.finished_pieces:
                return True
            return peer.fsm.current == PeerState.SUCCEEDED

        # Early-exit DAG probe: this runs on every register, and the
        # oldest (first-inserted) peers are exactly the finished ones,
        # so the steady-state cost is O(1), not O(peers).
        return self.dag.find_value(_available) is not None

    def can_back_to_source(self) -> bool:
        """Bounded number of peers may hit origin
        (reference task.go CanBackToSource)."""
        return len(self.back_to_source_peers) < self.back_to_source_limit

    # -- peer DAG (reference task.go:154,312-353) --------------------------

    def add_peer(self, peer) -> None:
        if not self.dag.has_vertex(peer.id):
            self.dag.add_vertex(peer.id, peer)
            if peer.host.tpu_slice:
                self.slice_index.setdefault(
                    peer.host.tpu_slice, set()).add(peer.id)
            if peer.is_seed:
                self.seed_peer_ids.add(peer.id)

    def _release_upload_slots(self, peer_id: str, *, parents: bool, children: bool) -> None:
        """Upload-concurrency accounting: each parent→child edge holds one
        upload slot on the parent's host (reference: ConcurrentUploadLimit;
        evaluator free-upload term + scheduling filter read this)."""
        if not self.dag.has_vertex(peer_id):
            return
        v = self.dag.get_vertex(peer_id)
        if parents:
            for p in v.parents.values():
                host = p.value.host
                host.concurrent_upload_count = max(0, host.concurrent_upload_count - 1)
        if children:
            host = v.value.host
            host.concurrent_upload_count = max(
                0, host.concurrent_upload_count - v.out_degree())

    def delete_peer(self, peer_id: str) -> None:
        self._release_upload_slots(peer_id, parents=True, children=True)
        peer = self.load_peer(peer_id)
        if peer is not None and peer.host.tpu_slice:
            members = self.slice_index.get(peer.host.tpu_slice)
            if members is not None:
                members.discard(peer_id)
        self.seed_peer_ids.discard(peer_id)
        self.dag.delete_vertex(peer_id)

    def load_peer(self, peer_id: str):
        if not self.dag.has_vertex(peer_id):
            return None
        return self.dag.get_vertex(peer_id).value

    def peers(self) -> list:
        return list(self.dag.values())

    def peer_count(self) -> int:
        return self.dag.vertex_count()

    def add_peer_edge(self, parent_id: str, child_id: str) -> None:
        self.dag.add_edge(parent_id, child_id)
        self.dag.get_vertex(parent_id).value.host.concurrent_upload_count += 1

    def delete_peer_in_edges(self, peer_id: str) -> None:
        """Detach a peer from its parents before rescheduling
        (reference task.go DeletePeerInEdges)."""
        self._release_upload_slots(peer_id, parents=True, children=False)
        self.dag.delete_vertex_in_edges(peer_id)

    def delete_peer_out_edges(self, peer_id: str) -> None:
        self._release_upload_slots(peer_id, parents=False, children=True)
        self.dag.delete_vertex_out_edges(peer_id)

    def can_add_peer_edge(self, parent_id: str, child_id: str) -> bool:
        return self.dag.can_add_edge(parent_id, child_id)

    def peer_out_degree(self, peer_id: str) -> int:
        return self.dag.get_vertex(peer_id).out_degree()

    # -- piece metadata ----------------------------------------------------

    def store_piece(self, piece: PieceInfo) -> None:
        self.pieces.setdefault(piece.piece_num, piece)

    def update_lengths(self, content_length: int, piece_size: int, total_piece_count: int) -> None:
        if content_length >= 0:
            self.content_length = content_length
        if piece_size > 0:
            self.piece_size = piece_size
        if total_piece_count >= 0:
            self.total_piece_count = total_piece_count
        self.touch()

    def to_wire(self) -> dict:
        return {
            "id": self.id,
            "url": self.url,
            "tag": self.tag,
            "application": self.application,
            "tenant": self.tenant,
            "state": self.state,
            "content_length": self.content_length,
            "piece_size": self.piece_size,
            "total_piece_count": self.total_piece_count,
            "peer_count": self.peer_count(),
            "size_scope": self.size_scope(),
        }


class TaskManager:
    """In-memory task registry with TTL GC (reference task_manager.go:134)."""

    def __init__(self, ttl: float = 24 * 3600.0):
        self._tasks: dict[str, Task] = {}
        self._ttl = ttl

    def load(self, task_id: str) -> Task | None:
        return self._tasks.get(task_id)

    def load_or_store(self, task: Task) -> Task:
        existing = self._tasks.get(task.id)
        if existing is not None:
            existing.touch()
            return existing
        self._tasks[task.id] = task
        return task

    def delete(self, task_id: str) -> None:
        self._tasks.pop(task_id, None)

    def all(self) -> list[Task]:
        return list(self._tasks.values())

    def gc(self) -> list[str]:
        now = time.time()
        dead = [t.id for t in self._tasks.values()
                if t.peer_count() == 0 and (now - t.updated_at) > self._ttl]
        for tid in dead:
            del self._tasks[tid]
        return dead
