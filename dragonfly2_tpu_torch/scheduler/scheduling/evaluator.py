"""The parent evaluator, which ranks candidate parents for a downloading
peer: the port's copy of
``dragonfly2_tpu/scheduler/scheduling/evaluator.py``.

A weighted score: finished pieces 0.2, upload success 0.2, free upload
0.15, host type 0.15, IDC affinity 0.15, location affinity 0.15; the
location term matches a ``|``-separated prefix of at most 5 elements.
When both hosts carry TPU coordinates, a topology distance replaces the
IDC and location terms: same slice (ICI) over same pod over same zone
over the rest. Bad-node detection: the last piece cost above mean + 3
sigma (30 samples or more) or above 20 x the mean.
"""

from __future__ import annotations

import statistics

from dragonfly2_tpu_torch.pkg.types import AFFINITY_SEPARATOR, HostType
from dragonfly2_tpu_torch.scheduler.config import SchedulingConfig
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer

MAX_AFFINITY_ELEMENTS = 5  # reference evaluator_base.go:159-188

# Host-type score (reference evaluator_base.go hostTypeAffinity: seeds score
# highest for children, normal peers mid).
_HOST_TYPE_SCORE = {
    HostType.SUPER_SEED: 1.0,
    HostType.STRONG_SEED: 0.9,
    HostType.WEAK_SEED: 0.8,
    HostType.NORMAL: 0.5,
}


class Evaluator:
    def __init__(self, config: SchedulingConfig | None = None):
        self.config = config or SchedulingConfig()

    # -- scoring (reference evaluator_base.go:71-83) -----------------------

    def evaluate(self, parent: Peer, child: Peer, total_piece_count: int) -> float:
        c = self.config
        score = (
            c.weight_finished_pieces * self._finished_piece_score(parent, total_piece_count)
            + c.weight_upload_success * parent.host.upload_success_rate()
            + c.weight_free_upload * self._free_upload_score(parent.host)
            + c.weight_host_type * self._host_type_score(parent)
        )
        topo = self._topology_score(parent.host, child.host)
        if topo is not None:
            score += (c.weight_idc_affinity + c.weight_location_affinity) * topo
        else:
            score += c.weight_idc_affinity * self._idc_score(parent.host, child.host)
            score += c.weight_location_affinity * self._location_score(parent.host, child.host)
        return score

    def evaluate_parents(self, parents: list[Peer], child: Peer,
                         total_piece_count: int) -> list[Peer]:
        """Sort descending by score (reference EvaluateParents :59)."""
        return sorted(
            parents,
            key=lambda p: self.evaluate(p, child, total_piece_count),
            reverse=True,
        )

    @staticmethod
    def _finished_piece_score(parent: Peer, total_piece_count: int) -> float:
        if total_piece_count <= 0:
            return 1.0 if parent.fsm.current == "succeeded" else 0.0
        return min(1.0, parent.finished_piece_count() / total_piece_count)

    @staticmethod
    def _free_upload_score(host: Host) -> float:
        limit = host.concurrent_upload_limit
        if limit <= 0:
            return 0.0
        return host.free_upload_count() / limit

    @staticmethod
    def _host_type_score(parent: Peer) -> float:
        return _HOST_TYPE_SCORE.get(parent.host.type, 0.5)

    @staticmethod
    def _idc_score(a: Host, b: Host) -> float:
        if not a.idc or not b.idc:
            return 0.0
        return 1.0 if a.idc.lower() == b.idc.lower() else 0.0

    @staticmethod
    def _location_score(a: Host, b: Host) -> float:
        """'|'-separated element prefix match, max 5 elements
        (reference evaluator_base.go:159-188)."""
        if not a.location or not b.location:
            return 0.0
        ea = a.location.lower().split(AFFINITY_SEPARATOR)[:MAX_AFFINITY_ELEMENTS]
        eb = b.location.lower().split(AFFINITY_SEPARATOR)[:MAX_AFFINITY_ELEMENTS]
        matched = 0
        for x, y in zip(ea, eb):
            if x != y:
                break
            matched += 1
        return matched / MAX_AFFINITY_ELEMENTS

    @staticmethod
    def _topology_score(a: Host, b: Host) -> float | None:
        """ICI/DCN distance when TPU coordinates are known; None otherwise.

        same slice  → 1.0  (piece rides ICI / stays inside the slice)
        same idc(pod) → 0.6 (one DCN hop inside the pod network)
        same zone (location first element) → 0.3
        else → 0.1
        """
        if not a.tpu_slice or not b.tpu_slice:
            # Mixed fleets score on the classic idc/location scale; the
            # topology scale only applies when BOTH ends have coordinates.
            return None
        if a.tpu_slice and a.tpu_slice == b.tpu_slice:
            return 1.0
        if a.idc and a.idc == b.idc:
            return 0.6
        la = a.location.split(AFFINITY_SEPARATOR)[0] if a.location else ""
        lb = b.location.split(AFFINITY_SEPARATOR)[0] if b.location else ""
        if la and la == lb:
            return 0.3
        return 0.1

    # -- bad-node detection (reference evaluator.go:88-124) ----------------

    @staticmethod
    def is_bad_node(peer: Peer) -> bool:
        """Piece-cost outlier rule: with ≥30 samples, last cost > mean+3σ;
        with fewer, last cost > 20×mean."""
        costs = list(peer.piece_costs)
        if len(costs) < 2:
            return False
        last = costs[-1]
        history = costs[:-1]
        mean = statistics.fmean(history)
        if len(costs) >= 30:
            sigma = statistics.pstdev(history)
            return last > mean + 3 * sigma
        return mean > 0 and last > 20 * mean
