"""Process groups, device meshes and global tensors on ``torch.distributed``.

The port of ``dragonfly2_tpu/parallel/multihost.py``. The JAX package runs
one process over every device of a host and stitches per-host landings
into one global ``jax.Array``. The port runs PyTorch's SPMD idiom: one
process (rank) per device, a ``DeviceMesh`` in place of a
``jax.sharding.Mesh``, and a ``DTensor`` with ``Shard``/``Replicate``
placements in place of a sharded ``jax.Array``. A process group created
here carries NCCL for CUDA tensors and gloo for CPU tensors
(``"cuda:nccl,cpu:gloo"``), or gloo alone where there is no NCCL.

Every function here is called by every rank of the mesh, in the same
order. ``global_replicated``, ``global_from_local_shards`` and ``place``
wrap data that every rank already holds: they make no collective and no
copy (``DTensor.from_local``). The collectives that move bytes live in
``parallel/ici.py``.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("parallel.multihost")

DEFAULT_TIMEOUT_S = 300.0


def _backend(device: torch.device) -> str:
    if (device.type == "cuda" and torch.cuda.is_available()
            and dist.is_nccl_available()):
        return "cuda:nccl,cpu:gloo"
    return "gloo"


def _set_cuda_device(backend: str, rank: int) -> None:
    """One rank, one card: the card of this rank's local index."""
    if "nccl" in backend:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Create the default process group, once.

    - A second call is a no-op.
    - Explicit arguments (``"host:port"``, world size, rank) must all be
      given and consistent; a group that cannot form raises.
    - With no arguments, torchrun's ``env://`` variables (``MASTER_ADDR``,
      ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read. Where there are
      none, a world of one forms on a local store, logged, so that
      single-process use still has a mesh (the JAX package needs no group
      there).

    ``device`` picks the backend: NCCL for CUDA tensors (with gloo for CPU
    tensors) where CUDA and NCCL are present, else gloo. ``timeout_s``
    bounds the rendezvous and every collective, so a rank that never
    joins fails the others instead of hanging them."""
    if dist.is_initialized():
        return
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    backend = _backend(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError(
                "explicit initialization needs coordinator_address, "
                f"num_processes and process_id, got {explicit!r}")
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} outside a world of "
                             f"{num_processes}")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group(backend, init_method=addr, timeout=timeout,
                                world_size=num_processes, rank=process_id)
        _set_cuda_device(backend, process_id)
        return
    if all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK")):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        _set_cuda_device(backend, dist.get_rank())
        return
    # Nothing to detect: on a real job this means the launcher's variables
    # are missing, so say so.
    log.warning("no coordinator and no torchrun variables; running a "
                "world of one", backend=backend)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timeout)
    _set_cuda_device(backend, 0)


def mesh_for(device, shape, names) -> DeviceMesh:
    """A ``DeviceMesh`` over ranks ``0 .. prod(shape)-1`` of ``device``'s
    type, initializing the process group first if needed. A CUDA mesh
    needs NCCL: over a group without it, this raises."""
    dev = default_device(device)
    initialize_distributed(device=dev)
    if dev.type == "cuda" and "cuda:nccl" not in dist.get_backend_config():
        raise RuntimeError(
            f"a cuda mesh needs NCCL; the process group has "
            f"{dist.get_backend_config()!r}")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n < 1 or n > world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} devices, "
                         f"job has {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def global_mesh(axis_shapes: dict[str, int] | None = None, *,
                device=None) -> DeviceMesh:
    """Mesh over every rank of the job. Default: one 1-D ``"d"`` axis;
    pass ``{"dp": 4, "tp": 8}``-style shapes to factor it."""
    if not axis_shapes:
        return mesh_for(device, (_world(device),), ("d",))
    names = tuple(axis_shapes)
    shape = tuple(axis_shapes[n] for n in names)
    world = _world(device)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {axis_shapes} needs {int(np.prod(shape))} "
                         f"devices, job has {world}")
    return mesh_for(device, shape, names)


def _world(device) -> int:
    initialize_distributed(device=default_device(device))
    return dist.get_world_size()


def local_mesh(mesh_shape=None, *, device=None) -> DeviceMesh:
    """Mesh over this host's ranks: ``LOCAL_WORLD_SIZE`` consecutive
    ranks (the counterpart of ``jax.local_devices()``; every rank when the
    variable is unset). ``mesh_shape`` factors them into axes ``d0``,
    ``d1``, ...; without it, one ``"d"`` axis. Every rank of the job calls
    this: it builds the job-wide ``("host", ...)`` mesh and returns this
    host's slice of it."""
    world = _world(device)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"{per_host} ranks a host do not divide a world of "
                         f"{world}")
    if mesh_shape:
        shape = tuple(int(s) for s in mesh_shape)
        names = tuple(f"d{i}" for i in range(len(shape)))
    else:
        shape, names = (per_host,), ("d",)
    if int(np.prod(shape)) != per_host:
        raise ValueError(f"mesh shape {list(shape)} needs "
                         f"{int(np.prod(shape))} ranks, this host has "
                         f"{per_host}")
    full = mesh_for(device, (world // per_host,) + shape, ("host",) + names)
    return full[names if len(names) > 1 else names[0]]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(1, int(d))
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh: DeviceMesh, placements,
               shape) -> DTensor:
    """``local`` as this rank's block of a global tensor of ``shape``:
    no collective, no copy."""
    shape = torch.Size(tuple(int(d) for d in shape))
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _to_mesh_device(local_array, mesh: DeviceMesh) -> torch.Tensor:
    """A tensor on this rank's mesh device: a tensor already there stays
    itself; host data moves once (JAX's ``device_put`` from the host)."""
    t = local_array if isinstance(local_array, torch.Tensor) else (
        torch.from_numpy(np.ascontiguousarray(local_array)))
    return t.to(mesh_device(mesh))


def global_replicated(mesh: DeviceMesh, local_array) -> DTensor:
    """Each rank's full local copy (a landed checkpoint after a pod-wide
    preheat) as one globally replicated tensor: no transfer, the fabric
    already broadcast the bytes host by host."""
    local = _to_mesh_device(local_array, mesh)
    return from_local(local, mesh, [Replicate()] * mesh.ndim, local.shape)


def global_from_local_shards(mesh: DeviceMesh, local_shard, *,
                             axis_name: str = "d") -> DTensor:
    """Stitch per-rank shards (each rank fetched its own byte range) into
    one tensor sharded over ``axis_name``'s leading dimension; on a
    factored mesh the other axes hold replicated copies, as
    ``P(axis_name)`` demands. Rank at coordinate i along ``axis_name``
    holds rows block i; every rank's block has the same row count (the
    fabric's ranged fan-out contract, as in the JAX package). One rank
    drives one device, so this rank has one block and any row count
    splits into it: the JAX package's divisibility check over a process's
    several devices has nothing left to check."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    axis = mesh.mesh_dim_names.index(axis_name)
    local = _to_mesh_device(local_shard, mesh)
    if local.dim() == 0:
        raise ValueError("a local shard needs a leading dimension")
    placements = [Replicate()] * mesh.ndim
    placements[axis] = Shard(0)
    shape = (local.shape[0] * mesh.size(axis),) + tuple(local.shape[1:])
    return from_local(local, mesh, placements, shape)


# ---------------------------------------------------------------------- #
# Shardings: ``(mesh, placements)`` pairs, the port's ``jax.sharding``
# ---------------------------------------------------------------------- #

def check_shardings(shardings) -> None:
    """Each value of ``shardings`` must be ``(DeviceMesh, placements)``,
    one ``Shard(d)`` or ``Replicate()`` per mesh dimension. Raised before
    anything is pulled."""
    for name, value in (shardings or {}).items():
        if (not isinstance(value, tuple) or len(value) != 2
                or not isinstance(value[0], DeviceMesh)):
            raise TypeError(f"sharding of {name!r} must be (DeviceMesh, "
                            f"placements), got {value!r}")
        mesh, placements = value
        if (len(placements) != mesh.ndim
                or not all(isinstance(p, (Shard, Replicate))
                           for p in placements)):
            raise TypeError(f"sharding of {name!r}: placements "
                            f"{placements!r} need one Shard or Replicate "
                            f"per dimension of a {mesh.ndim}-D mesh")


def block_index(shape, mesh_shape, coord, placements) -> tuple:
    """The block of a tensor of ``shape`` that the rank at ``coord`` of a
    mesh of ``mesh_shape`` holds under ``placements``: one slice per
    tensor dimension, ``slice(None)`` where it holds the whole dimension.
    ``Shard(d)`` follows ``torch.chunk``: ceil-sized chunks, the last
    ones short or empty (10 rows over 4 ranks: 3, 3, 3, 1). Several mesh
    dimensions sharding one tensor dimension split it in mesh-dimension
    order. A pure function: the ``download_global`` planner runs it for
    any coordinate."""
    shape = tuple(int(d) for d in shape)
    bounds: list = [None] * len(shape)
    for mesh_dim, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = p.dim + len(shape) if p.dim < 0 else p.dim
        if not 0 <= d < len(shape):
            raise ValueError(f"Shard({p.dim}) of a {len(shape)}-D tensor")
        lo, hi = bounds[d] or (0, shape[d])
        k = int(mesh_shape[mesh_dim])
        chunk = -(-(hi - lo) // k) if hi > lo else 0
        i = int(coord[mesh_dim])
        bounds[d] = (min(lo + i * chunk, hi), min(lo + (i + 1) * chunk, hi))
    return tuple(slice(None) if b is None else slice(*b) for b in bounds)


def place(tensor: torch.Tensor, sharding) -> DTensor:
    """``tensor``, which every rank of the sharding's mesh holds whole
    (as after a pod-wide landing), as a global ``DTensor`` under the
    sharding: each rank keeps its own block, a view where the block is
    contiguous (a copy only for a block across a non-leading dimension).
    No collective: the JAX package's ``device_put`` moves blocks between
    devices of one process, which one rank per device has no need of."""
    mesh, placements = sharding
    if tensor.device.type != mesh.device_type:
        raise ValueError(f"tensor on {tensor.device}, mesh on "
                         f"{mesh.device_type}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    idx = block_index(tensor.shape, tuple(mesh.mesh.shape), coord, placements)
    return from_local(tensor[idx].contiguous(), mesh, placements,
                      tensor.shape)
