"""The scheduling core, the retry loop that assigns candidate parents: the
port's copy of ``dragonfly2_tpu/scheduler/scheduling/scheduling.py``.

``schedule_candidate_parents`` loops up to the retry limit: find
candidates (a random sample of the task DAG merged with the peer's
same-slice peers, filtered and scored) and hand them out, or fall back
to the origin after the back-to-source limit. ``wire_qos`` narrows a
burning tenant's handouts; ``wire_fleet`` (``pkg/fleet.py``) records each
handout and throttle in the fleet's decision log and drops the hosts its
scorecards flag as stragglers from the candidates. A
``scheduling.algorithm`` other than ``"default"`` names an evaluator
plugin of the plugin registry (``pkg/dfplugin.py``), created with the
scheduling config; an unknown name raises ``LookupError``.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.scheduler.config import SchedulingConfig
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerState
from dragonfly2_tpu_torch.scheduler.scheduling.evaluator import Evaluator

log = dflog.get("scheduler.scheduling")


class ScheduleResult:
    """What the service layer should tell the peer."""

    CANDIDATES = "candidates"
    NEED_BACK_SOURCE = "need_back_source"
    FAILED = "failed"

    def __init__(self, kind: str, parents: list[Peer] | None = None, reason: str = ""):
        self.kind = kind
        self.parents = parents or []
        self.reason = reason


class Scheduling:
    def __init__(self, config: SchedulingConfig | None = None, evaluator: Evaluator | None = None):
        self.config = config or SchedulingConfig()
        if evaluator is None:
            algo = getattr(self.config, "algorithm", "default")
            if algo and algo != "default":
                from dragonfly2_tpu_torch.pkg import dfplugin

                evaluator = dfplugin.registry().create(
                    dfplugin.TYPE_EVALUATOR, algo, config=self.config)
            else:
                evaluator = Evaluator(self.config)
        self.evaluator = evaluator
        # Fleet observatory handle (pkg/fleet), wired by the service when
        # the advisory straggler filter is enabled: flagged hosts drop out
        # of candidate sets and every handout/filter lands in the
        # decision audit log (/debug/fleet/decisions). ``wire_fleet``
        # also binds the scorecards and the (in-place-updated) straggler
        # set directly — ``_is_candidate`` runs per candidate per
        # schedule attempt and must not pay an attribute chain there.
        self.fleet = None
        self._scorecards = None
        self._stragglers: "set[str] | None" = None
        self._recompute_tick = 63   # first attempt after wiring recomputes
        # QoS admission hook: a callable returning the tenants currently
        # burning past their error budget. A throttled tenant's handouts
        # shrink to half the candidate limit (at least 1): it keeps making
        # progress but stops fanning wide while it burns. The service
        # wires it to its burn book.
        self._throttled_tenants = None

    def wire_fleet(self, fleet) -> None:
        self.fleet = fleet
        self._scorecards = fleet.scorecards
        self._stragglers = fleet.scorecards._stragglers

    def wire_qos(self, throttled_fn) -> None:
        self._throttled_tenants = throttled_fn

    # -- v2-style scheduling (reference :85-213) ---------------------------

    async def schedule_candidate_parents(self, peer: Peer,
                                         blocklist: set[str] | None = None,
                                         allow_back_source: bool = True) -> ScheduleResult:
        """Retry loop: find parents for ``peer`` or fall back to source.

        Parents are checked FIRST each attempt — the back-to-source demotion
        only fires when an attempt at/after RetryBackToSourceLimit found
        nothing (a fresh seed's pieces must win over a redundant origin
        fetch). ``allow_back_source=False`` lets the service hold a peer in
        the retry loop while a seed is known to be actively seeding.
        """
        blocklist = set(blocklist or ())
        blocklist |= peer.block_parents
        cfg = self.config
        task = peer.task

        # Event-driven retry with a DUAL budget: each wakeup (a parent's
        # first piece, a finish, freed slots) re-checks immediately, but
        # demotion needs BOTH enough elapsed retry intervals (a burst of
        # unrelated notifies must not burn the budget in milliseconds) AND
        # enough actual find attempts (a stalled event loop accumulates
        # wall time without ever really looking for parents — premature
        # origin demotions showed up as 18 fetches in the churn test).
        loop = asyncio.get_running_loop()
        start = loop.time()
        back_source_after = (cfg.retry_back_to_source_limit - 1) * cfg.retry_interval
        give_up_after = (cfg.retry_limit - 1) * cfg.retry_interval
        attempts = 0
        while True:
            parents = self.find_candidate_parents(peer, blocklist)
            attempts += 1
            if parents:
                return ScheduleResult(ScheduleResult.CANDIDATES, parents)
            elapsed = loop.time() - start
            if (allow_back_source
                    and elapsed >= back_source_after
                    and attempts >= cfg.retry_back_to_source_limit
                    and task.can_back_to_source()
                    and peer.fsm.can("download_back_to_source")):
                return ScheduleResult(
                    ScheduleResult.NEED_BACK_SOURCE,
                    reason=f"no parents after {elapsed:.1f}s"
                           f"/{attempts} attempts")
            if elapsed >= give_up_after and attempts >= cfg.retry_limit:
                break
            # Sleep to the end of the current interval slice unless a
            # parent-availability event wakes us first.
            remaining = cfg.retry_interval - (elapsed % cfg.retry_interval)
            await task.wait_parents_changed(remaining)

        if allow_back_source and task.can_back_to_source() \
                and peer.fsm.can("download_back_to_source"):
            return ScheduleResult(ScheduleResult.NEED_BACK_SOURCE,
                                  reason="retry limit reached")
        return ScheduleResult(ScheduleResult.FAILED,
                              reason=f"no candidate parents after {cfg.retry_limit} tries")

    # -- candidate selection (reference :384-423 + :500-577) ---------------

    def find_candidate_parents(self, peer: Peer, blocklist: set[str] | None = None) -> list[Peer]:
        task = peer.task
        blocklist = blocklist or set()
        sc = self._scorecards
        if sc is not None:
            # Refresh the straggler flag set: this path only exists to
            # end a flagged host's probation when serve traffic stopped
            # reaching it (under traffic, note_pieces drives the
            # recompute cadence), so even the clock read is throttled to
            # every 64th schedule attempt — recompute_s still bounds the
            # actual recompute rate.
            self._recompute_tick = (self._recompute_tick + 1) & 63
            if self._recompute_tick == 0:
                sc.maybe_recompute(sc._clock())
        sample = {v.id: v.value
                  for v in task.dag.random_vertices(
                      self.config.filter_parent_limit)}
        # ICI locality: merge same-slice peers into the sample so the
        # evaluator's slice-affinity term has intra-slice candidates to
        # prefer — a uniform random sample of a 256-host pod rarely
        # contains one (~6% per candidate at 16 hosts/slice), which caps
        # intra-slice scheduling no matter how the scorer weighs it.
        my_slice = peer.host.tpu_slice
        if my_slice:
            added = 0
            for pid in task.slice_index.get(my_slice, ()):
                if added >= self.config.filter_parent_limit:
                    break
                # Cap AFTER skipping self/duplicates/blocked — truncating
                # the raw member list could drop the one same-slice peer
                # that actually has pieces.
                if pid == peer.id or pid in sample or pid in blocklist:
                    continue
                v = task.load_peer(pid)
                if v is not None:
                    sample[pid] = v
                    added += 1
        candidates = [
            p for p in sample.values()
            if self._is_candidate(p, peer, blocklist)
        ]
        if not candidates:
            return []
        ranked = self.evaluator.evaluate_parents(candidates, peer, task.total_piece_count)
        if my_slice:
            # ICI-lexicographic rule: ANY serving slice-mate outranks ANY
            # cross-slice parent. Intra-slice traffic rides ICI (hundreds
            # of GB/s, no NIC involvement); cross-slice rides the DCN NIC
            # — an order-of-magnitude gap no weighted-sum edge can
            # express, so it is a partition, not a weight. Candidates are
            # serving parents OR warming slice-mates (_is_candidate's
            # 0-piece relay rule), so the head of the list is intra but
            # not necessarily producing yet — the all-warming guard
            # below is load-bearing. The stable partition keeps the
            # evaluator's order inside each group: slice-mates spread by
            # free-upload/piece score (warming mates score last), and
            # cross-slice ingress remains the fallback when the slice has
            # no serving member yet (its first arrival). This is what
            # builds the broadcast tree — ~1 DCN ingress per slice, ICI
            # fan-out inside — that the pod-sim's intra_slice_frac gauges.
            ranked.sort(key=lambda p: p.host.tpu_slice != my_slice)
        limit = self.config.candidate_parent_limit
        if self._throttled_tenants is not None and task.tenant:
            throttled = self._throttled_tenants()
            if throttled and task.tenant in throttled:
                # Burn-rate deprioritization: the throttled tenant's
                # handouts narrow instead of vanishing — admission at the
                # manager stops NEW work, this bounds in-flight fan-out.
                limit = max(1, limit // 2)
                if self.fleet is not None:
                    self.fleet.note_throttle(
                        task.tenant, task_id=task.id, host_id=peer.host.id,
                        reason="burn_rate_handout", limit=limit)
        out = ranked[:limit]
        # A handout must contain ≥1 parent that serves NOW (succeeded,
        # piece-holding, or back-sourcing). Warming slice-mates may fill
        # the list in a registration storm, and a handout of only those
        # leaves the child's first piece hostage to the relay chain's own
        # schedule — swap the tail slot for the best serving candidate.
        if out and all(p.fsm.current == PeerState.RUNNING
                       and p.finished_piece_count() == 0 for p in out):
            serving = next(
                (p for p in ranked[limit:]
                 if p.fsm.current != PeerState.RUNNING
                 or p.finished_piece_count() > 0), None)
            if serving is not None:
                out[-1] = serving
        if self.fleet is not None and out:
            # Audit: the handout plus the top rejected alternatives, so
            # "why did host X get parent Y (and not Z)" is answerable
            # after the fact. Once per handout — not a per-piece path.
            taken = {id(p) for p in out}
            rejected = []
            for p in ranked:
                if id(p) not in taken:
                    rejected.append(p.host.id)
                    if len(rejected) == 3:
                        break
            self.fleet.note_handout(
                task.id, peer.id, peer.host.id,
                chosen=tuple(p.host.id for p in out),
                rejected=tuple(rejected))
        return out

    def _is_candidate(self, parent: Peer, child: Peer, blocklist: set[str]) -> bool:
        """Filter rules (reference filterCandidateParents :500-577)."""
        if parent.id == child.id or parent.id in blocklist:
            return False
        if parent.host.id == child.host.id:
            return False  # same host serves via local reuse, not P2P
        if parent.fsm.current not in (PeerState.RUNNING, PeerState.BACK_TO_SOURCE,
                                      PeerState.SUCCEEDED):
            return False
        if parent.fsm.current != PeerState.SUCCEEDED and parent.finished_piece_count() == 0:
            # Zero-piece parents are usually useless — EXCEPT one that is
            # actively producing bytes (a back-sourcing peer, typically
            # the just-triggered seed). The daemon's sync stream accepts a
            # running pieceless task and pushes pieces as they land
            # (rpcserver SyncPieceTasks), so handing it out at
            # registration removes a report+wakeup round trip from every
            # waiting child's time-to-first-piece. Allowed producers:
            #   - BACK_TO_SOURCE: actively pulling from origin (the
            #     just-triggered seed);
            #   - a WARMING SLICE-MATE: RUNNING in the child's own slice
            #     with its parent edges already wired. Its pieces relay
            #     down the intra-slice chain (ICI) moments later, and the
            #     child keeps any serving parents in the same handout, so
            #     this builds the slice's pipelined broadcast chain
            #     instead of a 3rd-4th cross-slice (DCN) stream. A
            #     RUNNING peer with no parents wired (e.g. a seed-host
            #     replication pull still waiting for its own schedule)
            #     stays excluded — it produces nothing yet and would burn
            #     the child's starvation window.
            if parent.fsm.current != PeerState.BACK_TO_SOURCE:
                warming_slice_mate = (
                    parent.fsm.current == PeerState.RUNNING
                    and bool(parent.host.tpu_slice)
                    and parent.host.tpu_slice == child.host.tpu_slice
                    and child.task.dag.has_vertex(parent.id)
                    and len(child.task.dag.get_vertex(parent.id).parents) > 0
                )
                if not warming_slice_mate:
                    return False
        if parent.host.free_upload_count() <= 0:
            return False
        if parent.host.quarantined():
            # Pod-wide demotion: typed piece_failed reports (corrupt /
            # truncated / stalled serving) quarantined this host; it stays
            # out of EVERY peer's candidate set until the penalty decays.
            return False
        if self._stragglers and parent.host.id in self._stragglers:
            # Advisory fleet-wide demotion: the cross-task scorecard says
            # this host serves slowly EVERYWHERE (robust z over serve
            # EWMAs — the per-task PodAggregator cannot see this). Safe by
            # construction: flagging needs min_population scored hosts,
            # so small pods never lose their only parent to it. Each drop
            # is explained in the decision log.
            self.fleet.note_straggler_filter(child.task.id, child.id,
                                             parent.host.id)
            return False
        if self.evaluator.is_bad_node(parent):
            return False
        # DAG sanity: adding child under parent must not create a cycle or a
        # duplicate edge (edge add happens on piece download start).
        if not child.task.can_add_peer_edge(parent.id, child.id):
            # Allow re-offering an existing parent (edge already present).
            vertex_ok = (
                child.task.dag.has_vertex(parent.id)
                and child.id in child.task.dag.get_vertex(parent.id).children
            )
            if not vertex_ok:
                return False
        return True

    # -- edge bookkeeping on reschedule (reference :164-208) ---------------

    def reattach_peer(self, peer: Peer, new_parents: list[Peer]) -> None:
        """Replace the peer's parent edges with the newly scheduled set."""
        task = peer.task
        task.delete_peer_in_edges(peer.id)
        for parent in new_parents:
            if task.can_add_peer_edge(parent.id, peer.id):
                task.add_peer_edge(parent.id, peer.id)
