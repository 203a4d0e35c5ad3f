"""Piece dispatcher, which decides the (piece, parent) to fetch next: the
port's copy of ``dragonfly2_tpu/daemon/peer/piece_dispatcher.py``.

A smoothed cost per parent, the cheapest holder picked (a random one a
tenth of the time, to explore); pieces already landed are skipped.
Availability arrives from the per-parent synchronizers; the conductor's
workers take assignments here, extended into runs of contiguous pieces a
parent holds. Stripe mode (a pod broadcast's wanted set) and the
per-parent digest maps that certify a child's completion re-hash skip
(``certified_digest_maps``) are the JAX dispatcher's.

``quarantine`` (the daemon-wide ``pkg/quarantine.ParentQuarantine``,
keyed by ``parent_key``) is consulted live: a quarantined parent gets no
assignment and rides the reschedule blocklist until its window lapses.
``flight`` (the task's ``pkg/flight.TaskFlight``) records each parent
dropped (``EV_PARENT_DROP``).

Runs extend over pieces whose digest the store can check in the write
(crc32c, or none) whatever the route: the port fetches a run as one
ranged GET over ``http.client`` (``piece_downloader``), where the JAX
dispatcher extends only when its native library is loaded.
"""

from __future__ import annotations

import asyncio
import heapq
import random
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg.piece import piece_length

EWMA_ALPHA = 0.3
RANDOM_RATIO = 0.1  # reference defaultRandomRatio: explore parents
# Cost EWMAs within this factor of the fastest holder count as tied:
# the tie breaks on current in-flight assignment count, so equally-fast
# holders share load instead of herding onto one.
NEAR_TIE_RATIO = 1.25


@dataclass
class ParentInfo:
    peer_id: str
    ip: str
    upload_port: int
    pieces: set[int] = field(default_factory=set)
    cost_ewma_ms: float = 100.0    # optimistic start
    failures: int = 0
    blocked: bool = False
    # Locality: this parent shares the local host's slice, so pulls from
    # it ride the intra-slice fabric. In stripe mode it is the only class
    # allowed to serve non-stripe pieces.
    same_slice: bool = False
    tpu_slice: str = ""
    # Assignments currently in flight against this parent (tie-breaker).
    inflight: int = 0


@dataclass
class PieceAssignment:
    piece_num: int
    parent: ParentInfo
    expected_size: int = -1
    digest: str = ""   # parent-advertised "algo:encoded"; verified on write


def parent_key(p: ParentInfo) -> str:
    """The daemon-wide quarantine key: the serving endpoint, not the
    per-task peer id (a parent that corrupted task A is not trusted for
    task B, and a restarted peer id must not reset it)."""
    return f"{p.ip}:{p.upload_port}"


# Failures in a row that block a parent.
MAX_PARENT_FAILURES = 3


class PieceDispatcher:
    def __init__(self, *, quarantine=None,
                 flight: "flightlib.TaskFlight | None" = None):
        self.quarantine = quarantine
        self.flight = flight
        self.parents: dict[str, ParentInfo] = {}
        self._total_piece_count = -1
        self.piece_size = 0
        self.content_length = -1
        self._done: set[int] = set()
        self._inflight: set[int] = set()
        self.piece_digests: dict[int, str] = {}
        # Per-parent digest maps + the set of parents whose sync stream
        # reported done (see certified_digest_maps for why provenance,
        # not a merged view, drives the re-hash-skip decision).
        self.parent_digests: dict[str, dict[int, str]] = {}
        self.done_parents: set[str] = set()
        # Incremental ready-tracking: O(1) amortized per assignment instead
        # of rescanning all pieces (a 100 GiB task is ~25k pieces).
        self._needed: set[int] = set()
        self._heap: list[int] = []
        self._wakeup = asyncio.Event()
        # Set whenever the certification picture changes (a parent reports
        # done, or a potential certifier drops): completion-time waiters
        # (conductor._await_certification) re-evaluate on each set.
        self.certified_event = asyncio.Event()
        # Striped slice broadcast wanted-set (scheduler stripe plan):
        # size<=1 = unstriped. In stripe mode only pieces with
        # piece_num % size == rank may be assigned to cross-slice (DCN)
        # parents; every other piece fills intra-slice.
        self._stripe_size = 0
        self._stripe_rank = -1

    # -- stripe mode -------------------------------------------------------

    @property
    def stripe(self) -> "tuple[int, int] | None":
        if self._stripe_size >= 2:
            return (self._stripe_size, self._stripe_rank)
        return None

    def set_stripe(self, slice_size: int, slice_rank: int) -> None:
        """Enter (or reshuffle) stripe mode. Changing the plan re-opens
        pieces whose assignability changed, so reservations waiting on a
        dead mate's stripe release cleanly onto the new plan."""
        if slice_size < 2 or not (0 <= slice_rank < slice_size):
            self.clear_stripe()
            return
        if (slice_size, slice_rank) == (self._stripe_size, self._stripe_rank):
            return
        self._stripe_size, self._stripe_rank = slice_size, slice_rank
        self._wakeup.set()

    def clear_stripe(self) -> None:
        """Unstriped fallback (lone host / scheduler stopped striping):
        every piece becomes DCN-assignable again."""
        if self._stripe_size:
            self._stripe_size, self._stripe_rank = 0, -1
            self._wakeup.set()

    def in_stripe(self, piece_num: int) -> bool:
        """Does this host DCN-fetch ``piece_num`` under the current plan?
        True for everything when unstriped."""
        if self._stripe_size < 2:
            return True
        return piece_num % self._stripe_size == self._stripe_rank

    @property
    def total_piece_count(self) -> int:
        return self._total_piece_count

    @total_piece_count.setter
    def total_piece_count(self, value: int) -> None:
        if value >= 0 and value != self._total_piece_count:
            self._total_piece_count = value
            self._add_needed(range(value))
        elif value >= 0:
            self._total_piece_count = value

    def _add_needed(self, nums) -> None:
        for n in nums:
            if n not in self._done and n not in self._inflight and n not in self._needed:
                self._needed.add(n)
                heapq.heappush(self._heap, n)

    # -- topology updates --------------------------------------------------

    def upsert_parent(self, peer_id: str, ip: str, upload_port: int,
                      *, same_slice: bool = False,
                      tpu_slice: str = "") -> ParentInfo:
        p = self.parents.get(peer_id)
        if p is None:
            p = ParentInfo(peer_id, ip, upload_port,
                           same_slice=same_slice, tpu_slice=tpu_slice)
            self.parents[peer_id] = p
            self._wakeup.set()
        else:
            p.ip, p.upload_port = ip, upload_port
            p.blocked = False
            p.same_slice = p.same_slice or same_slice
            p.tpu_slice = p.tpu_slice or tpu_slice
        return p

    def drop_parent(self, peer_id: str) -> None:
        p = self.parents.get(peer_id)
        if p is not None:
            p.blocked = True
            if self.flight is not None:
                self.flight.record(flightlib.EV_PARENT_DROP, -1, 0.0,
                                   peer_id)
        self._wakeup.set()
        self.certified_event.set()

    def active_parents(self) -> list[ParentInfo]:
        # Consulted live (the penalty decays): a parent whose window lapsed
        # is selectable again with no push from the scheduler.
        q = self.quarantine
        return [p for p in self.parents.values()
                if not p.blocked
                and (q is None or not q.is_quarantined(parent_key(p)))]

    def unusable_parent_ids(self) -> list[str]:
        """Blocked or quarantined parents: the reschedule blocklist (the
        scheduler must not hand these right back)."""
        q = self.quarantine
        return [pid for pid, p in self.parents.items()
                if p.blocked
                or (q is not None and q.is_quarantined(parent_key(p)))]

    def note_parent_done(self, peer_id: str) -> None:
        """The sync stream saw done=True from this parent: its completion
        gate passed (seed: full-digest validation; intermediate peer: its
        own certified chain)."""
        self.done_parents.add(peer_id)
        self.certified_event.set()

    def certified_digest_maps(self) -> "list[dict[int, str]]":
        """EVERY done parent's non-empty digest map. Provenance matters:
        a still-downloading back-sourcing parent's announced digests are
        self-computed and uncertified — the re-hash-skip decision must
        compare the digests pieces were actually verified against to a
        VALIDATED parent's map, never to the merged view (a corrupt
        parent's entries would otherwise be laundered by an honest
        parent's done). The consumer (store.apply_certification) tries
        each map: a corrupt parent that happens to complete first must
        not mask an honest completed parent's certification."""
        return [m for pid in self.done_parents
                if (m := self.parent_digests.get(pid))]

    def pending_certifiers(self) -> bool:
        """Could a certification still arrive? True while some unblocked
        parent's sync stream has not yet reported done — its completion
        gate may pass any moment and its digest map would then certify
        this peer's re-hash skip."""
        return any(not p.blocked and pid not in self.done_parents
                   for pid, p in self.parents.items())

    def seed_shared_digests(self, digests: "dict[int, str] | None") -> None:
        """Merge scheduler-RELAYED digests into the shared map only:
        they inform landing verification for assignments made before the
        parent's own sync snapshot arrives, but they carry no provenance
        — they must never enter parent_digests (a first-reporter-poisoned
        relay attributed to an honest parent would be laundered into its
        certified map)."""
        for n, d in (digests or {}).items():
            if d:
                self.piece_digests.setdefault(int(n), d)

    def on_parent_pieces(self, peer_id: str, piece_nums: list[int],
                         total_piece_count: int = -1, content_length: int = -1,
                         piece_size: int = 0,
                         digests: dict[int, str] | None = None) -> None:
        p = self.parents.get(peer_id)
        if p is None:
            return
        p.pieces.update(piece_nums)
        if digests:
            per_parent = self.parent_digests.setdefault(peer_id, {})
            for n, d in digests.items():
                if d:
                    self.piece_digests[int(n)] = d
                    per_parent[int(n)] = d
        if total_piece_count >= 0:
            self.total_piece_count = total_piece_count
        if self._total_piece_count < 0:
            # Unknown total: advertised pieces define the known universe.
            self._add_needed(piece_nums)
        if content_length >= 0:
            self.content_length = content_length
        if piece_size > 0:
            self.piece_size = piece_size
        self._wakeup.set()

    # -- results -----------------------------------------------------------

    def mark_downloaded(self, piece_num: int) -> None:
        self._done.add(piece_num)
        self._inflight.discard(piece_num)
        self._needed.discard(piece_num)
        self._wakeup.set()

    def mark_known_downloaded(self, piece_nums) -> None:
        self._done.update(piece_nums)
        self._needed -= set(piece_nums)

    def report_success(self, assignment: PieceAssignment, cost_ms: int) -> None:
        p = assignment.parent
        p.cost_ewma_ms = (1 - EWMA_ALPHA) * p.cost_ewma_ms + EWMA_ALPHA * cost_ms
        p.failures = 0
        p.inflight = max(0, p.inflight - 1)
        self.mark_downloaded(assignment.piece_num)

    def report_failure(self, assignment: PieceAssignment, *, parent_gone: bool = False) -> None:
        p = assignment.parent
        p.failures += 1
        p.inflight = max(0, p.inflight - 1)
        p.cost_ewma_ms *= 2  # punish
        if parent_gone or p.failures >= MAX_PARENT_FAILURES:
            p.blocked = True
        self._inflight.discard(assignment.piece_num)
        self._add_needed([assignment.piece_num])
        self._wakeup.set()

    # -- completion --------------------------------------------------------

    def is_complete(self) -> bool:
        return self.total_piece_count >= 0 and len(self._done) >= self.total_piece_count

    def no_usable_parents(self) -> bool:
        return not self.active_parents()

    def downloaded_count(self) -> int:
        return len(self._done)

    # -- assignment (reference getDesiredReq :104-168) ---------------------

    def _holders(self, piece_num: int) -> list[ParentInfo]:
        """Eligible holders under the stripe wanted-set: non-stripe pieces
        may ONLY come from same-slice parents (never DCN-assigned); stripe
        pieces prefer a same-slice holder when one exists (a mate that
        already has the piece beats re-crossing the DCN for it)."""
        holders = [p for p in self.active_parents() if piece_num in p.pieces]
        if self._stripe_size < 2:
            return holders
        intra = [p for p in holders if p.same_slice]
        if not self.in_stripe(piece_num):
            return intra
        return intra or holders

    def _pick_parent(self, piece_num: int) -> ParentInfo | None:
        holders = self._holders(piece_num)
        if not holders:
            return None
        if random.random() < RANDOM_RATIO:
            return random.choice(holders)
        best = min(p.cost_ewma_ms for p in holders)
        near = [p for p in holders if p.cost_ewma_ms <= best * NEAR_TIE_RATIO]
        # Near-ties break on current in-flight load, so equally-fast
        # holders share assignments instead of the min() herding every
        # piece onto the single lowest-EWMA parent.
        return min(near, key=lambda p: (p.inflight, p.cost_ewma_ms))

    def has_assignable(self) -> bool:
        """Non-mutating peek: could try_get() return an assignment now?"""
        return any(self._holders(n) for n in self._needed)

    def try_get(self) -> PieceAssignment | None:
        """Lowest-numbered needed piece with a live holder; unheld pieces go
        back on the heap (O(log n) amortized)."""
        deferred: list[int] = []
        found: PieceAssignment | None = None
        while self._heap:
            n = heapq.heappop(self._heap)
            if n not in self._needed:
                continue  # stale entry (downloaded meanwhile)
            parent = self._pick_parent(n)
            if parent is None:
                deferred.append(n)
                continue
            self._needed.discard(n)
            self._inflight.add(n)
            parent.inflight += 1
            expected = -1
            if self.piece_size > 0 and self.content_length >= 0:
                expected = piece_length(n, self.piece_size, self.content_length)
            found = PieceAssignment(n, parent, expected,
                                    digest=self.piece_digests.get(n, ""))
            break
        for n in deferred:
            heapq.heappush(self._heap, n)
        return found

    def extend_run(self, a: PieceAssignment,
                   max_len: int) -> list[PieceAssignment]:
        """Greedily extend ``a`` into a CONTIGUOUS run of needed pieces the
        same parent already advertises, for one coalesced ranged fetch.
        Only pieces whose digest the store checks in the write (crc32c or
        none) extend the run, so a mixed-digest task does not bounce
        between span attempts and per-piece pulls. Extended pieces are
        reserved (inflight) exactly like try_get's."""
        run = [a]
        p = a.parent
        if (self.piece_size <= 0 or self.content_length < 0
                or p.blocked or max_len <= 1):
            return run
        if a.digest and not a.digest.startswith("crc32c:"):
            # The head piece itself would make the span ineligible: don't
            # reserve extras just to release them (a 25k-piece sha256 task
            # would churn reserve/release on every piece).
            return run
        n = a.piece_num + 1
        while len(run) < max_len and n in self._needed and n in p.pieces:
            if self._stripe_size >= 2 and not p.same_slice \
                    and not self.in_stripe(n):
                # Wanted-set boundary: a DCN parent's span must not spill
                # into a mate's stripe (stripes interleave mod S, so cross
                # runs naturally cap at one piece — intra runs stay long).
                break
            digest = self.piece_digests.get(n, "")
            if digest and not digest.startswith("crc32c:"):
                break
            self._needed.discard(n)
            self._inflight.add(n)
            p.inflight += 1
            run.append(PieceAssignment(
                n, p, piece_length(n, self.piece_size, self.content_length),
                digest=digest))
            n += 1
        return run

    def release_assignment(self, a: PieceAssignment) -> None:
        """Hand an unfetched reservation back (span fallback): no failure
        accounting — the piece simply becomes assignable again."""
        a.parent.inflight = max(0, a.parent.inflight - 1)
        self._inflight.discard(a.piece_num)
        self._add_needed([a.piece_num])
        self._wakeup.set()

    async def get(self, timeout: float = 30.0) -> PieceAssignment | None:
        """Next assignment; None when the task is complete or no parents can
        serve anything new within ``timeout`` (caller decides to reschedule)."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            if self.is_complete():
                return None
            assignment = self.try_get()
            if assignment is not None:
                return assignment
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0 or self.no_usable_parents():
                return None
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), min(remaining, 1.0))
            except asyncio.TimeoutError:
                pass
