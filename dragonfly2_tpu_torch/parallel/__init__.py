"""Device-mesh placement: pod topology, process groups and shard
redistribution on ``torch.distributed`` (the port of
``dragonfly2_tpu/parallel``). Once one rank holds a piece in device
memory, spreading it inside an NVLink domain rides NCCL collectives
instead of the NIC.
"""

from dragonfly2_tpu_torch.parallel.ici import (
    all_gather_shards,
    make_mesh,
    replicate_to_mesh,
    ring_all_gather,
    scatter_shards,
)
from dragonfly2_tpu_torch.parallel.topology import TpuTopology, detect_topology

__all__ = [
    "TpuTopology",
    "detect_topology",
    "make_mesh",
    "scatter_shards",
    "all_gather_shards",
    "ring_all_gather",
    "replicate_to_mesh",
]
