"""dragonfly2_tpu_torch — the PyTorch/CUDA port of the device plane.

The JAX package (``dragonfly2_tpu``) lands verified pieces in TPU memory
through two Pallas kernels. This package does the same on an NVIDIA
Hopper card with two hand-written CUDA C++ kernels, and imports nothing
from the JAX package (nor JAX itself):

- ``pkg/``     own copies of the logger, a stdlib registry of counters
               and gauges, the piece-size math and ``Range``, task ids,
               coded errors and the span-buffer pool.
- ``proto/``   ``UrlMeta``, the request metadata the daemon reads.
- ``csrc/``    the CUDA C++ kernels (``sm_90a``), built by nvcc at first use.
- ``ops/``     checksum wrappers, the device sink (``HBMSink``), the
               hot-swap's ``assemble_delta_u8`` and ``DoubleBuffer``,
               safetensors views over the landed bytes, and JAX-state and
               ``PartitionSpec`` conversion.
- ``daemon/``  ``DeviceSinkManager``, the terminal store the reference
               daemon's task manager drives through a duck-typed surface,
               and ``FileTaskRequest``, the request it accepts.
- ``delta/``   chunk manifests and the delta plan of a hot-swap.
- ``client/``  the user's entry points: ``download_to_device``,
               ``download_sharded``, ``download_global``,
               ``download_delta``; and ``Dfstore``, the object gateway's
               HTTP client (standard library only).
- ``dataset/`` webdataset tar shards into record batches on the card: the
               tar index, sample-ranged reads, the pod-sharded loader and
               ``DeviceFeed``.
- ``parallel/`` placement on a device mesh over ``torch.distributed``
               (one rank per card; NCCL, or gloo on a ``cpu`` mesh):
               process groups, ``DeviceMesh``es, ``DTensor`` placements,
               scatter, gathers and rings, and the pod topology.
- ``entry``    the top-level entry points (``__graft_entry__.py``'s twin):
               ``entry()``, the verify+land step through K2, and
               ``dryrun_multichip(n)``, the fabric + dp×tp train step,
               one process per rank.
- ``bench``    the device bench (``bench.py``'s device section): one JSON
               line of verify+land, staging and swap-verify rates on a
               CUDA card, and its own history of verified runs.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), which is what the CPU tests do. Importing the package
does not import ``torch``: the modules that use it do, so the CLI's client
commands (``dfget``, ``dfcache``, ``dfstore``) start without it.
"""

from __future__ import annotations

__version__ = "0.1.0"


def default_device(device=None) -> "torch.device":  # noqa: F821
    """The device a port entry point runs on. ``None`` means the current
    CUDA device; with no CUDA device this raises instead of quietly
    running on the CPU (a caller who wants the CPU says ``device="cpu"``).
    A CUDA device always carries its index, so devices compare equal to
    a tensor's ``.device``."""
    import torch

    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {dev} requested but CUDA is not available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
