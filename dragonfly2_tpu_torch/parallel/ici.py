"""Shard redistribution over a device mesh, on ``torch.distributed``.

The port of ``dragonfly2_tpu/parallel/ici.py``. There, XLA collectives
(``device_put`` to a ``NamedSharding``, ``all_gather`` and ``ppermute``
under ``shard_map``) spread landed bytes across the devices of a TPU
slice. Here NCCL does it across the cards of an NVLink domain (gloo on a
``cpu`` mesh), driven through ``torch.distributed``.

**The contract (SPMD).** A JAX function runs in one process that drives
every device of the mesh. Its port is a collective: every rank of the
mesh calls it, in the same order.

- *Bytes that one process holds in JAX* (a host array to scatter or
  replicate, a landed sink to spread, a striped chunk): a source rank
  ``src`` (default 0) holds them and every other rank passes ``None``.
  Their shape and dtype reach the others first, in one broadcast of a
  small CPU tensor (≤ 88 bytes) on the group's CPU backend. With
  ``src=None`` every rank holds the same bytes and keeps its own block:
  no collective and no copy.
- *Data already in place on every process* (``global_replicated``,
  ``global_from_local_shards``, ``parallel/multihost.py``): wrapped with
  ``DTensor.from_local``, no collective, no copy.
- *Cross-device bytes* move only through ``torch.distributed`` calls on
  device tensors, never through host memory, and always as a ``uint8``
  view of the contiguous bytes (gloo refuses ``uint32`` and ``uint16``;
  a view is bit-identical, never a cast). Every call goes through
  ``_call``, which counts it per function and operation
  (``collective_counts``).
- An axis of one rank sends nothing: a ring has no hops and never posts
  a send to itself, and ``scatter_shards`` keeps the tensor itself (a
  view). Every other call is made whatever the axis size.

Output layouts follow the JAX package: ``scatter_shards`` gives
``Shard(0)`` on the axis (a ``DTensor``), the gathers give ``Replicate()``,
and ``ring_all_gather`` gives ``Shard(0)`` whose every local block is the
full gather (``ici.py:104-107``).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from dragonfly2_tpu_torch.parallel.multihost import (
    from_local,
    _world,
    global_replicated,
    mesh_device,
    mesh_for,
)

# (function, torch.distributed operation) -> calls, since the last reset.
COLLECTIVES: Counter = Counter()

# Dtypes a metadata broadcast can name, by index.
_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16,
           torch.int32, torch.uint32, torch.int64, torch.uint64,
           torch.float16, torch.bfloat16, torch.float32, torch.float64)
_MAX_DIMS = 8


def collective_counts() -> dict[str, int]:
    """``{"function.operation": calls}`` since the last reset."""
    return {f"{who}.{op}": n for (who, op), n in sorted(COLLECTIVES.items())}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _call(who: str, op: str, *args, **kwargs):
    COLLECTIVES[(who, op)] += 1
    return getattr(dist, op)(*args, **kwargs)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as a flat uint8 view (contiguous tensors only:
    a collective writes through it)."""
    if not t.is_contiguous():
        raise ValueError("collective buffers must be contiguous")
    return t.reshape(-1).view(torch.uint8)


class _Axis(NamedTuple):
    group: object
    ranks: list          # global ranks along the axis, in coordinate order
    idx: int             # this rank's coordinate along the axis
    dim: int             # the axis's mesh dimension

    @property
    def n(self) -> int:
        return len(self.ranks)


def _axis(mesh: DeviceMesh, axis_name: str) -> _Axis:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    dim = mesh.mesh_dim_names.index(axis_name)
    row = mesh.mesh[tuple(slice(None) if i == dim else c
                          for i, c in enumerate(coord))]
    return _Axis(mesh.get_group(axis_name), row.tolist(), coord[dim], dim)


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def make_mesh(n_devices: int | None = None, axis_name: str = "d", *,
              device=None) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default): the
    NVLink domain's ring. Runs on the card unless ``device="cpu"``; more
    devices than ranks raise."""
    if n_devices is None:
        n_devices = _world(device)
    return mesh_for(device, (n_devices,), (axis_name,))


def _host_tensor(a, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(dev)


def _share_meta(who: str, ax: _Axis, src: int, t: torch.Tensor | None,
                extra: int = 0) -> tuple[torch.Size, torch.dtype, int]:
    """The source's shape, dtype and one extra integer, to every rank of
    the axis: one broadcast of a small CPU tensor."""
    meta = torch.zeros(3 + _MAX_DIMS, dtype=torch.int64)
    if t is not None:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"{t.dim()}-D tensor: at most {_MAX_DIMS}")
        meta[0] = _DTYPES.index(t.dtype)
        meta[1] = t.dim()
        meta[2] = extra
        meta[3:3 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    _call(who, "broadcast", meta, src=src, group=ax.group)
    ndim = int(meta[1])
    return (torch.Size(meta[3:3 + ndim].tolist()), _DTYPES[int(meta[0])],
            int(meta[2]))


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended up to a multiple of ``n``."""
    short = -t.shape[0] % n
    return torch.cat([t, t.new_zeros((short,) + t.shape[1:])]) if short else t


def _scatter(who: str, mesh: DeviceMesh, ax: _Axis, host_array, src,
             pad: bool) -> tuple[torch.Tensor, torch.Size, int]:
    """This rank's block of ``host_array`` along ``ax``: (block, global
    shape, rows before padding). With ``pad`` the source pads the leading
    dimension up to a multiple of the axis size with zeros; else it must
    divide."""
    dev = mesh_device(mesh)
    n = ax.n
    if src is None or n == 1:
        if host_array is None:
            raise ValueError("this rank holds no data and no source rank "
                             "was named")
        t = _host_tensor(host_array, dev)
        rows = t.shape[0]
        if pad:
            t = _pad_rows(t, n)
        if t.shape[0] % n:
            raise ValueError(f"leading dimension {t.shape[0]} does not "
                             f"divide over {n} ranks")
        per = t.shape[0] // n
        return t[ax.idx * per:(ax.idx + 1) * per], t.shape, rows
    if mesh.ndim != 1:
        raise ValueError("one source rank feeds a 1-D mesh; pass src=None "
                         "when every rank holds the data")
    me = dist.get_rank()
    t = None
    if me == src:
        if host_array is None:
            raise ValueError(f"rank {src} is the source and holds no data")
        t = _host_tensor(host_array, dev)
        rows = t.shape[0]
        if pad:
            t = _pad_rows(t, n)
    elif host_array is not None:
        raise ValueError(f"rank {me} holds data but rank {src} is the "
                         "source")
    shape, dtype, rows = _share_meta(who, ax, src, t, 0 if t is None else rows)
    if shape[0] % n:
        raise ValueError(f"leading dimension {shape[0]} does not divide "
                         f"over {n} ranks")
    per = shape[0] // n
    out = torch.empty((per,) + tuple(shape[1:]), dtype=dtype, device=dev)
    parts = None
    if me == src:                       # block j goes to coordinate j
        parts = [None] * n
        for j, r in enumerate(ax.ranks):
            parts[dist.get_group_rank(ax.group, r)] = _bytes(
                t[j * per:(j + 1) * per])
    _call(who, "scatter", _bytes(out), parts, src=src, group=ax.group)
    return out, shape, rows


def scatter_shards(mesh: DeviceMesh, host_array, axis_name: str = "d", *,
                   src: int | None = 0) -> DTensor:
    """Host buffer -> device-sharded tensor: the rank at coordinate i of
    ``axis_name`` holds block i (``Shard(0)``; other axes replicate). The
    leading dimension must divide by the axis size. ``src`` holds the
    data (other ranks pass ``None``) and scatters it; with ``src=None``
    every rank holds it and keeps its block, a view."""
    ax = _axis(mesh, axis_name)
    local, shape, _ = _scatter("scatter_shards", mesh, ax, host_array, src,
                               pad=False)
    placements = [Replicate()] * mesh.ndim
    placements[ax.dim] = Shard(0)
    return from_local(local, mesh, placements, shape)


def replicate_to_mesh(mesh: DeviceMesh, host_array, *,
                      src: int | None = 0) -> DTensor:
    """Host buffer -> replicated on every rank of a 1-D mesh: ``src``
    holds it and broadcasts it; with ``src=None`` every rank holds it
    already (``global_replicated``: no transfer)."""
    if src is None:
        return global_replicated(mesh, host_array)
    if mesh.ndim != 1:
        raise ValueError("one source rank feeds a 1-D mesh")
    ax = _axis(mesh, mesh.mesh_dim_names[0])
    dev = mesh_device(mesh)
    t = None
    if dist.get_rank() == src:
        if host_array is None:
            raise ValueError(f"rank {src} is the source and holds no data")
        t = _host_tensor(host_array, dev).contiguous()
    if ax.n > 1:
        shape, dtype, _ = _share_meta("replicate_to_mesh", ax, src, t)
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
    _call("replicate_to_mesh", "broadcast", _bytes(t), src=src,
          group=ax.group)
    return from_local(t, mesh, [Replicate()], t.shape)


def _axis_block(sharded: DTensor, ax: _Axis, who: str) -> torch.Tensor:
    """The local block of a tensor sharded evenly on dim 0 along ``ax``."""
    if sharded.placements[ax.dim] != Shard(0):
        raise ValueError(f"{who}: input must be Shard(0) on the axis, got "
                         f"{sharded.placements[ax.dim]}")
    if sharded.shape[0] % ax.n:
        raise ValueError(f"{who}: {sharded.shape[0]} rows do not divide "
                         f"over {ax.n} ranks")
    return sharded.to_local().contiguous()


def all_gather_shards(mesh: DeviceMesh, sharded: DTensor,
                      axis_name: str = "d") -> DTensor:
    """Every rank ends with the full content along ``axis_name`` (one
    ``all_gather_into_tensor``; NCCL rings it over NVLink)."""
    ax = _axis(mesh, axis_name)
    local = _axis_block(sharded, ax, "all_gather_shards")
    out = torch.empty((ax.n,) + tuple(local.shape), dtype=local.dtype,
                      device=local.device)
    _call("all_gather_shards", "all_gather_into_tensor", _bytes(out),
          _bytes(local), group=ax.group)
    order = [dist.get_group_rank(ax.group, r) for r in ax.ranks]
    if order != list(range(ax.n)):      # group-rank order -> coordinate order
        out = out[order]
    placements = list(sharded.placements)
    placements[ax.dim] = Replicate()
    full = out.reshape((ax.n * local.shape[0],) + tuple(local.shape[1:]))
    return from_local(full, mesh, placements, sharded.shape)


def _ring(who: str, blocks: torch.Tensor, ax: _Axis, bounds) -> list:
    """Complete ``blocks`` ([n, rows, ...], this rank's own block already
    at ``ax.idx``) with one ring of n-1 hops to the right neighbour per
    row slice ``(r0, r1)`` of ``bounds``, receiving straight into place.
    Every rank posts the same ring in the same order. A hop waits for the
    previous hop's receive, whose block it forwards (on NCCL a wait only
    orders the current stream); the last hop's works are returned
    unwaited."""
    n, idx = ax.n, ax.idx
    if n == 1:
        return []
    right, left = ax.ranks[(idx + 1) % n], ax.ranks[(idx - 1) % n]
    pending = []
    for r0, r1 in bounds:
        if r1 <= r0:
            continue
        works: list = []
        for hop in range(1, n):
            for w in works:
                w.wait()
            send = _bytes(blocks[(idx - hop + 1) % n, r0:r1])
            recv = _bytes(blocks[(idx - hop) % n, r0:r1])
            works = _call(who, "batch_isend_irecv", [
                dist.P2POp(dist.isend, send, right, ax.group),
                dist.P2POp(dist.irecv, recv, left, ax.group)])
        pending += works
    return pending


def _wait(works) -> None:
    for w in works:
        w.wait()


def ring_all_gather(mesh: DeviceMesh, sharded: DTensor,
                    axis_name: str = "d") -> DTensor:
    """Ring all-gather, hop by hop (``batch_isend_irecv``): n-1 hops to
    the right neighbour. Returns a ``Shard(0)`` stack whose every local
    block is the full gather, as the JAX package's ``ppermute`` ring
    does."""
    ax = _axis(mesh, axis_name)
    local = _axis_block(sharded, ax, "ring_all_gather")
    rows = local.shape[0]
    blocks = torch.empty((ax.n,) + tuple(local.shape), dtype=local.dtype,
                         device=local.device)
    blocks[ax.idx].copy_(local)
    _wait(_ring("ring_all_gather", blocks, ax, [(0, rows)]))
    full = blocks.reshape((ax.n * rows,) + tuple(local.shape[1:]))
    placements = list(sharded.placements)
    placements[ax.dim] = Shard(0)
    return from_local(full, mesh, placements,
                      (ax.n * ax.n * rows,) + tuple(local.shape[1:]))


def _chunk_bounds(rows: int, n_chunks: int) -> list[tuple[int, int]]:
    return [(rows * c // n_chunks, rows * (c + 1) // n_chunks)
            for c in range(n_chunks)]


def chunked_ring_all_gather(mesh: DeviceMesh, sharded: DTensor,
                            axis_name: str = "d",
                            n_chunks: int = 4) -> DTensor:
    """Every rank ends with the full content (replicated), gathered as
    ``n_chunks`` row slices, each its own ring (an empty slice, when
    ``n_chunks`` exceeds the rows, is skipped). The same result as
    ``all_gather_shards``; the chunks bound each hop's message."""
    n_chunks = max(1, int(n_chunks))
    ax = _axis(mesh, axis_name)
    local = _axis_block(sharded, ax, "chunked_ring_all_gather")
    blocks = torch.empty((ax.n,) + tuple(local.shape), dtype=local.dtype,
                         device=local.device)
    blocks[ax.idx].copy_(local)
    _wait(_ring("chunked_ring_all_gather", blocks, ax,
                _chunk_bounds(local.shape[0], n_chunks)))
    placements = list(sharded.placements)
    placements[ax.dim] = Replicate()
    full = blocks.reshape((ax.n * local.shape[0],) + tuple(local.shape[1:]))
    return from_local(full, mesh, placements, sharded.shape)


class StripedBroadcast:
    """Pipelined striped broadcast: landing overlapped with the spread.

    Per landed stripe chunk the source rank ``feed``s the host bytes
    (every other rank calls ``feed(None)``): the chunk is scattered over
    the axis, its leading dimension padded up to a multiple of the axis
    size, and its chunked ring posted. The last hop of each ring is left
    in flight (``async_op`` work handles): on NCCL, feed queues work on
    the card and returns while the bytes move; on gloo the host waits for
    every hop but the last. ``result()`` waits for every feed's work,
    trims the padding and concatenates, in feed order, on every rank."""

    def __init__(self, mesh: DeviceMesh, axis_name: str = "d",
                 n_chunks: int = 1, *, src: int = 0):
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_chunks = max(1, int(n_chunks))
        self.src = src
        self._parts: list[tuple] = []   # (blocks, valid rows, works)

    def feed(self, host_chunk) -> None:
        ax = _axis(self.mesh, self.axis_name)
        local, shape, rows = _scatter("StripedBroadcast.feed", self.mesh,
                                      ax, host_chunk, self.src, pad=True)
        blocks = torch.empty((ax.n,) + tuple(local.shape), dtype=local.dtype,
                             device=local.device)
        blocks[ax.idx].copy_(local)
        works = _ring("StripedBroadcast.feed", blocks, ax,
                      _chunk_bounds(local.shape[0], self.n_chunks))
        self._parts.append((blocks.reshape(shape), rows, works))

    def result(self) -> DTensor:
        """The replicated content, rows in feed order."""
        if not self._parts:
            raise ValueError("StripedBroadcast.result() before any feed()")
        for _, _, works in self._parts:
            _wait(works)
        trimmed = [blocks[:rows] for blocks, rows, _ in self._parts]
        out = torch.cat(trimmed) if len(trimmed) > 1 else trimmed[0]
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return from_local(out, self.mesh, [Replicate()] * self.mesh.ndim,
                          out.shape)


def bitcast_landed_bytes(buffer: torch.Tensor, dtype, shape) -> torch.Tensor:
    """Landed uint8 device bytes as a checkpoint tensor (e.g. bf16
    weights): a view, no copy."""
    from dragonfly2_tpu_torch.ops.hbm_sink import torch_dtype

    target = torch_dtype(dtype)
    n = int(np.prod(shape)) if len(shape) else 1
    flat = buffer.reshape(-1)[: n * target.itemsize]
    if flat.storage_offset() % target.itemsize:
        raise ValueError(f"bytes at offset {flat.storage_offset()} cannot "
                         f"view as {target}")
    return flat.view(target).reshape(shape)
