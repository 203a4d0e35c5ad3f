"""dragonfly2_tpu_torch — the PyTorch/CUDA port of the device plane.

The JAX package (``dragonfly2_tpu``) lands verified pieces in TPU memory
through two Pallas kernels. This package does the same on an NVIDIA
Hopper card with two hand-written CUDA C++ kernels, and imports nothing
from the JAX package (nor JAX itself):

- ``pkg/``     own copies of the logger, a stdlib counter registry and the
               piece-size math.
- ``csrc/``    the CUDA C++ kernels (``sm_90a``), built by nvcc at first use.
- ``ops/``     checksum wrappers, the device sink (``HBMSink``), safetensors
               views over the landed bytes, and JAX-state conversion.
- ``daemon/``  ``DeviceSinkManager``, the terminal store the reference
               daemon's task manager drives through a duck-typed surface.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device a port entry point runs on. ``None`` means the current
    CUDA device; with no CUDA device this raises instead of quietly
    running on the CPU (a caller who wants the CPU says ``device="cpu"``)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
