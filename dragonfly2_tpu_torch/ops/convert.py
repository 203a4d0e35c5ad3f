"""Carry a JAX sink's state and a JAX sharding into the port.

The device sink's "weights" are the landed bytes themselves. A JAX
``HBMSink``'s landed content (``np.asarray(sink._assemble())``, uint32
words) and its ``host_checksums`` become a port ``HBMSink`` in the
verified state, checked on the target device by the same checksum kernel
the port's own landings use. A ``PartitionSpec``, described as a plain
tuple, becomes DTensor placements (``placements_from_spec``). Inputs
cross as numpy arrays and tuples, so this module needs neither JAX nor
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

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


def placements_from_spec(mesh_dim_names, spec) -> list:
    """DTensor placements for a ``PartitionSpec`` described as a tuple with
    one entry per tensor dimension: ``None``, a mesh axis name, or a tuple
    of names (the dimension split over those axes, major first). On mesh
    ``("dp", "tp")``: ``("d",)`` on ``("d",)`` -> ``[Shard(0)]``, ``()``
    -> ``[Replicate(), Replicate()]``, ``(None, "tp")`` ->
    ``[Replicate(), Shard(1)]``. An axis used twice or unknown raises, and
    so do several axes on one dimension out of mesh order (placements
    split a dimension in mesh-dimension order only)."""
    names = tuple(mesh_dim_names)
    out = [Replicate()] * len(names)
    used: set = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = []
        for axis in axes:
            if axis not in names:
                raise ValueError(f"axis {axis!r} not in mesh {names}")
            if axis in used:
                raise ValueError(f"axis {axis!r} used twice in {spec!r}")
            used.add(axis)
            pos.append(names.index(axis))
            out[names.index(axis)] = Shard(dim)
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} split dimension {dim} out of mesh "
                             f"order {names}")
    return out
