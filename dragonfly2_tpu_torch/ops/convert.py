"""Carry a JAX sink's state into the port.

The device sink's "weights" are the landed bytes themselves. A JAX
``HBMSink``'s landed content (``np.asarray(sink._assemble())``, uint32
words) and its ``host_checksums`` become a port ``HBMSink`` in the
verified state, checked on the target device by the same checksum kernel
the port's own landings use. Inputs cross as numpy arrays, so this module
needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.ops.checksum import chunk_checksums
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink


def words_to_torch(np_u32: np.ndarray) -> torch.Tensor:
    """uint32 words as a CPU int32 tensor with the same bits."""
    arr = np.require(np.asarray(np_u32, dtype=np.uint32),
                     requirements=["C", "W"])   # copies a read-only array
    return torch.from_numpy(arr.view(np.int32))


def sink_state_from_numpy(flat_u32: np.ndarray,
                          host_checksums: "dict[int, tuple[int, int]]", *,
                          content_length: int, piece_size: int,
                          device=None) -> HBMSink:
    """A verified port ``HBMSink`` holding ``flat_u32`` (the padded landed
    words) with ``host_checksums`` for its landed pieces. Raises ValueError
    naming the first piece whose device checksum disagrees."""
    sink = HBMSink(content_length, piece_size, device=device)
    flat = np.asarray(flat_u32, dtype=np.uint32).reshape(-1)
    if flat.size != sink.padded_words:
        raise ValueError(f"{flat.size} words given for a sink of "
                         f"{sink.padded_words} padded words")
    bad = [n for n in host_checksums if not 0 <= n < sink.total_pieces]
    if bad:
        raise ValueError(f"pieces {bad} out of range for "
                         f"{sink.total_pieces}-piece sink")
    sink._buffer.copy_(words_to_torch(flat))
    sink._dev_sums, sink._dev_xors = chunk_checksums(sink._buffer,
                                                     sink.piece_words)
    sink.host_checksums = {int(n): (int(s), int(x))
                           for n, (s, x) in host_checksums.items()}
    sink.landed = set(sink.host_checksums)
    sink._mark_ready()
    sink.verify()
    return sink
