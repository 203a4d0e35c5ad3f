"""Checkpoint-delta hot-swap on the card, end to end on one machine.

The PyTorch/CUDA twin of ``examples/checkpoint_hotswap.py``. Serve
version N of a checkpoint from the card's buffer, publish version N+1 (a
few scattered tensor updates), watch the delta land — unchanged chunks
copied device to device out of version N, only changed chunks fetched —
and the tensors flip atomically to the new generation without a serving
gap. The fabric is the reference scheduler and daemons with the port's
device sink (``torch_fabric``); it needs ``aiohttp``. It imports no JAX.

    python examples/torch_checkpoint_hotswap.py [--device cpu]
"""

import argparse
import asyncio
import hashlib
import json
import os
import struct
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from dragonfly2_tpu_torch import default_device


def make_checkpoint(step: int) -> bytes:
    """A small safetensors checkpoint; version `step+1` is version
    `step` with a few scattered tensor updates (the realistic edit
    pattern — not one contiguous blob)."""
    rng = np.random.RandomState(0)
    tensors = {
        "w1": rng.randn(256, 256).astype(np.float32),
        "w2": rng.randn(256, 128).astype(np.float32),
        "bias": rng.randn(1024).astype(np.float32),
        "step": np.array([0], dtype=np.int32),
    }
    tensors["step"][0] = step
    if step > 1:       # scattered updates on top of version 1
        tensors["bias"][::97] += 0.5
        tensors["w2"][5, :16] *= 1.25
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        raw = arr.tobytes()
        dt = {"float32": "F32", "int32": "I32"}[str(arr.dtype)]
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hjson = json.dumps(header).encode()
    return struct.pack("<Q", len(hjson)) + hjson + b"".join(blobs)


async def serve_blobs(blobs: dict):
    from aiohttp import web

    from dragonfly2_tpu_torch.pkg.piece import Range

    async def handler(request):
        content = blobs[request.match_info["name"]]
        hdr = request.headers.get("Range")
        if hdr:
            r = Range.parse_http(hdr, len(content))
            data = content[r.start:r.start + r.length]
            return web.Response(status=206, body=data, headers={
                "Content-Range": f"bytes {r.start}-"
                f"{r.start + len(data) - 1}/{len(content)}",
                "Accept-Ranges": "bytes"})
        return web.Response(body=content,
                            headers={"Accept-Ranges": "bytes"})

    app = web.Application()
    app.router.add_get("/{name}", handler)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


async def main(device) -> int:
    from torch_fabric import start_daemon, start_scheduler, stop_daemon

    from dragonfly2_tpu_torch.client import device as device_lib
    from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest
    from dragonfly2_tpu_torch.delta import CDCParams, publish_manifest_for
    from dragonfly2_tpu_torch.ops.hbm_sink import DoubleBuffer
    from dragonfly2_tpu_torch.proto.common import UrlMeta

    v1, v2 = make_checkpoint(1), make_checkpoint(2)
    sha1 = "sha256:" + hashlib.sha256(v1).hexdigest()
    sha2 = "sha256:" + hashlib.sha256(v2).hexdigest()
    params = CDCParams(mask_bits=12, min_size=2 << 10, max_size=32 << 10)

    workdir = tempfile.mkdtemp(prefix="hotswap-example-")
    origin, base_url = await serve_blobs({"v1": v1, "v2": v2})
    sched = await start_scheduler()
    daemons = []
    try:
        seed = await start_daemon(sched, "seed", seed=True, workdir=workdir)
        daemons.append(seed)
        pod = await start_daemon(sched, "pod", device=device, workdir=workdir)
        daemons.append(pod)

        # The publisher side: land both versions on the seed and publish
        # their chunk manifests into the fabric.
        async def land(url, digest):
            final = None
            async for p in seed.task_manager.start_file_task(
                    FileTaskRequest(url=url, output="",
                                    meta=UrlMeta(digest=digest))):
                if p.state == "done":
                    final = p
            return final

        r1 = await land(f"{base_url}/v1", sha1)
        await publish_manifest_for(seed.task_manager, r1.task_id,
                                   params=params, device=device)

        # Serve version N from the device buffer.
        result = await device_lib.download_to_device(
            pod, f"{base_url}/v1", digest=sha1)
        hot = DoubleBuffer()
        hot.flip(result.as_bytes_array(), result.load_safetensors())
        step = int(hot.tensors()["step"][0])
        print(f"serving generation {hot.generation} "
              f"(checkpoint step {step}, {len(v1)} bytes on {device})")

        # Version N+1 appears: publish + manifest.
        r2 = await land(f"{base_url}/v2", sha2)
        await publish_manifest_for(seed.task_manager, r2.task_id,
                                   params=params, device=device)

        # The hot swap: delta transfer + device-side reuse + atomic flip.
        swap = await device_lib.download_delta(
            pod, f"{base_url}/v2", base=result.task_id, hot=hot,
            digest=sha2, device=device)
        step = int(hot.tensors()["step"][0])
        st = swap.stats
        print(f"flipped to generation {hot.generation} "
              f"(checkpoint step {step})")
        print(f"  wire:   reused {st['reused_bytes']}B locally, "
              f"fetched {st['fetched_bytes']}B "
              f"({100 * st['fetched_bytes'] / len(v2):.1f}% of the bytes)")
        print(f"  device: {swap.reused_device_bytes}B copied device to "
              f"device, {swap.staged_bytes}B staged host->device")
        if step != 2 or hot.buffer().cpu().numpy().tobytes() != v2:
            raise AssertionError("generation 2 did not go live intact")
        return 0
    finally:
        for d in daemons:
            await stop_daemon(d)
        await sched.stop()
        await origin.cleanup()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    rc = asyncio.run(main(default_device(ap.parse_args().device)))
    assert "jax" not in sys.modules
    sys.exit(rc)
