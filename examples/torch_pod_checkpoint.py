"""Pod checkpoint consumption on the card: fabric-landed safetensors → mesh.

The PyTorch/CUDA twin of ``examples/pod_checkpoint.py``. A checkpoint
lands in the port's device sink (in production: a preheat lands it on
every host), then the training side loads named tensors straight onto a
factored ``("dp", "tp")`` device mesh and runs a forward pass on them.
The second half pulls a tensor through a real fabric in this process
(origin, the reference scheduler, and a reference daemon whose device
sink is the port's ``DeviceSinkManager``) with ``download_global``.

    python examples/torch_pod_checkpoint.py [--device cpu] [--no-fabric]
    torchrun --nproc-per-node N examples/torch_pod_checkpoint.py

Without a launcher it is a world of one; under ``torchrun`` every rank
runs it (each lands the checkpoint, keeps its blocks and runs its own
fabric half). The fabric half needs ``aiohttp``; ``--no-fabric`` leaves
it out on a machine without it. It imports no JAX.
"""

import argparse
import asyncio
import json
import os
import socket
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.distributed.tensor import Replicate

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops.convert import placements_from_spec
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink
from dragonfly2_tpu_torch.ops.safetensors import load_from_sink
from dragonfly2_tpu_torch.parallel import multihost

AXES = ("dp", "tp")


def make_checkpoint() -> tuple[bytes, dict[str, np.ndarray]]:
    rng = np.random.RandomState(0)
    tensors = {"w1": rng.randn(64, 128).astype(np.float32),
               "w2": rng.randn(128, 32).astype(np.float32)}
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        raw = arr.tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hjson = json.dumps(header).encode()
    return struct.pack("<Q", len(hjson)) + hjson + b"".join(blobs), tensors


def mesh_shape(world: int) -> dict[str, int]:
    """The example's 2 x 4 mesh where the job has 8 ranks: tp takes the
    largest of 4, 2, 1 that divides the world, dp the rest."""
    tp = next(t for t in (4, 2, 1) if world % t == 0)
    return {"dp": world // tp, "tp": tp}


def sharding(mesh, *spec):
    return mesh, placements_from_spec(AXES, spec)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--no-fabric", action="store_true",
                    help="leave out the fabric half (needs aiohttp)")
    args = ap.parse_args()
    device = default_device(args.device)
    multihost.initialize_distributed(device=device)  # torchrun or a world of one
    content, ref = make_checkpoint()

    # The fabric's device sink (what a preheat lands on every host).
    piece = 4096
    sink = HBMSink(len(content), piece, batch_pieces=4, device=device)
    for n in range((len(content) + piece - 1) // piece):
        sink.land_piece(n, content[n * piece:(n + 1) * piece])
    assert sink.complete() and sink.verify()

    # Training side: tensors straight onto the job-wide mesh. Every rank
    # landed the checkpoint, so each keeps its own block (no transfer).
    world = torch.distributed.get_world_size()
    mesh = multihost.global_mesh(mesh_shape(world), device=device)
    params = load_from_sink(sink, shardings={
        "w1": sharding(mesh, None, "tp"),
        "w2": sharding(mesh, "tp", None),
    })
    for name in ("w1", "w2"):
        block = multihost.block_index(ref[name].shape, tuple(mesh.mesh.shape),
                                      mesh.get_coordinate(),
                                      params[name].placements)
        assert np.array_equal(params[name].to_local().cpu().numpy(),
                              ref[name][block]), name
    x = multihost.from_local(torch.ones((8, 64), device=device), mesh,
                             [Replicate(), Replicate()], (8, 64))
    out = (x @ params["w1"] @ params["w2"]).full_tensor()
    want = np.ones((8, 64), np.float32) @ ref["w1"] @ ref["w2"]
    np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-4)
    print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
          f"w1.placements={params['w1'].placements} on {device.type} "
          f"forward-pass exact: OK")

    if not args.no_fabric:
        asyncio.run(fabric_global_load(content, ref, mesh, device))
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules


async def fabric_global_load(content: bytes, ref, mesh, device) -> None:
    """Global sharded load through a real fabric in this process: an
    origin, the reference scheduler and a reference daemon whose device
    sink is the port's (``torch_fabric``); ``download_global`` pulls only
    the byte ranges this rank's blocks hold."""
    from dragonfly2_tpu.pkg.testing import start_range_origin
    from dragonfly2_tpu_torch.client import device as device_lib
    from torch_fabric import start_daemon, start_scheduler, stop_daemon

    runner, url, served = await start_range_origin(content)
    sched = await start_scheduler()
    daemon = await start_daemon(sched, socket.gethostname(), device=device)
    try:
        params = await device_lib.download_global(
            daemon, url, {"w2": sharding(mesh, "tp", None)})
        got = params["w2"].full_tensor().cpu().numpy()
        np.testing.assert_array_equal(got, ref["w2"])
        print(f"download_global: w2 pulled as per-rank row ranges "
              f"({served['bytes']} origin bytes for a "
              f"{len(content)}-byte checkpoint), placements "
              f"{params['w2'].placements} — bit-exact: OK")
    finally:
        await stop_daemon(daemon)
        await sched.stop()
        await runner.cleanup()


if __name__ == "__main__":
    main()
