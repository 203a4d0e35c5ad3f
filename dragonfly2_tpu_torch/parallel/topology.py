"""Pod topology for the scheduler and the daemon's announcer.

The port's own copy of ``dragonfly2_tpu/parallel/topology.py``. It feeds
the scheduler's evaluator (collective distance vs data-centre network
distance) and the daemon announcer (slice/worker detection). A "slice"
is one domain whose devices talk through device collectives: on a TPU
pod an ICI domain, on GPUs one NVLink domain, which is one host on
standard H100 nodes. Transfers between slices cross the network.

Detection sources, in order: explicit env (``DF_TPU_SLICE``,
``DF_TPU_WORKER``; the scheduler keys on these names), GCE TPU VM env
(``TPU_NAME``, ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``), and, opted in
with ``DF_DETECT_TORCH=1``, torchrun's node variables (``GROUP_RANK``,
the node's index, and ``GROUP_WORLD_SIZE``, the node count: torchrun
sets these, not ``NNODES``) with ``torch.cuda.device_count()``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass
class TpuTopology:
    slice_name: str = ""        # collective domain identifier
    worker_index: int = -1      # host index within the slice
    num_workers: int = 0        # hosts in the slice
    chips_per_host: int = 0
    pod_name: str = ""          # network cluster (fills Host.idc)
    zone: str = ""

    @property
    def present(self) -> bool:
        return bool(self.slice_name)

    def location_path(self) -> str:
        """'|'-separated affinity path for the evaluator's location term:
        zone|pod|slice|worker (most-significant first)."""
        parts = [self.zone or "zone", self.pod_name or "pod",
                 self.slice_name or "slice", f"w{self.worker_index}"]
        return "|".join(parts)


def _torchrun_node(topo: TpuTopology) -> None:
    """One torchrun node is one NVLink domain: its own slice, of one
    host, with this host's cards."""
    node = os.environ.get("GROUP_RANK", "")
    nodes = os.environ.get("GROUP_WORLD_SIZE", "")
    cards = torch.cuda.device_count()
    if not (node and nodes and cards):
        return
    try:
        index, count = int(node), int(nodes)
    except ValueError:
        return
    topo.slice_name = f"torch-node-{index}-of-{count}"
    topo.worker_index = 0
    topo.num_workers = 1
    topo.chips_per_host = cards


def detect_topology() -> TpuTopology:
    topo = TpuTopology()
    topo.slice_name = (os.environ.get("DF_TPU_SLICE", "")
                       or os.environ.get("TPU_NAME", ""))
    worker = (os.environ.get("DF_TPU_WORKER", "")
              or os.environ.get("TPU_WORKER_ID", ""))
    if worker:
        try:
            topo.worker_index = int(worker)
        except ValueError:
            pass
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if hostnames:
        topo.num_workers = len(hostnames.split(","))
    topo.pod_name = os.environ.get("DF_TPU_POD", "")
    topo.zone = os.environ.get("DF_ZONE", "")
    if not topo.present and os.environ.get("DF_DETECT_TORCH", "") == "1":
        # Opt-in: the daemon should not touch the cards by default.
        _torchrun_node(topo)
    return topo


def apply_to_host_config(host_cfg, topo: TpuTopology | None = None) -> None:
    """Fill a daemon ``HostOption`` from detected topology."""
    topo = topo or detect_topology()
    if not topo.present:
        return
    if not host_cfg.tpu_slice:
        host_cfg.tpu_slice = topo.slice_name
    if host_cfg.tpu_worker_index < 0:
        host_cfg.tpu_worker_index = topo.worker_index
    if not host_cfg.idc:
        host_cfg.idc = topo.pod_name or topo.slice_name
    if not host_cfg.location:
        host_cfg.location = topo.location_path()
