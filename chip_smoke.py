#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device-sink path on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``dragonfly2_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes and at odd shapes, and times both;
4. lands one checkpoint shard the size of Llama-3.1-8B's
   ``model-00001-of-00004.safetensors`` (~4.98 GB: the embedding and
   layers 0-8 at the published widths, random bf16 from ``--seed``)
   through ``DeviceSinkManager.on_piece`` in shuffled piece order, then
   ``finalize`` -> ``take`` -> ``verify_u8_against_host`` ->
   ``load_from_sink``; checks every landed byte and tensor, and that the
   path launched both kernels; splits the landing's host time and the
   verify gate's time into their parts; then checks that a corrupt piece
   fails verification by name;
5. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dragonfly2_tpu_torch.daemon.peer.device_sink import (
    DeviceSinkError,
    DeviceSinkManager,
    TaskDeviceSink,
)
from dragonfly2_tpu_torch.ops import _build, checksum
from dragonfly2_tpu_torch.ops.hbm_sink import verify_u8_against_host
from dragonfly2_tpu_torch.ops.safetensors import load_from_sink
from dragonfly2_tpu_torch.pkg.piece import compute_piece_count, compute_piece_size

# Llama-3.1-8B (meta-llama/Llama-3.1-8B config.json): hidden 4096,
# intermediate 14336, 32 heads / 8 KV heads of 128, vocab 128256.
LLAMA_8B = {"hidden": 4096, "kv": 1024, "inter": 14336, "vocab": 128256}
SHARD_LAYERS = 9          # shard 1 of 4 holds the embedding and layers 0-8
BATCH_PIECES = 8
ITERS = 20                # timed runs of each kernel


def card_bandwidth(name: str) -> float:
    """Peak memory rate in bytes/s by card name (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in name else 3.35e12   # PCIe, else SXM (HBM3)


def bound_ms(nbytes: int, bandwidth: float) -> float:
    """The bytes bound. Both kernels do two 32-bit integer operations per
    4-byte word, so their operations bound (tens of TOPS) stays below a
    fortieth of this one: every kernel here is ``bound_by`` bytes."""
    return nbytes / bandwidth * 1e3


def time_ms(fn, iters: int) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``iters`` runs after
    one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int) -> float:
    """Median host-clock milliseconds of ``fn``, which must synchronise."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def random_words(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n random int32 words covering every bit pattern."""
    return torch.randint(0, 256, (n * 4,), dtype=torch.uint8, device=device,
                         generator=gen).view(torch.int32)


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def check_equal(what: str, pairs) -> None:
    for i, (a, b) in enumerate(pairs):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 "version")


# --------------------------------------------------------------------- #
# Kernel phases
# --------------------------------------------------------------------- #

def phase_chunk_checksums(n: int, pw: int, gen, device, bw: float) -> dict:
    """K1 against its plain version over n pieces of pw words, timed."""
    words = random_words(n * pw, gen, device)
    got = checksum.chunk_checksums(words, pw)
    want = checksum.chunk_checksums_torch(words, pw)
    check_equal("chunk_checksums", zip(got, want))
    err = max_abs_err(zip(got, want))
    ms = time_ms(lambda: checksum.chunk_checksums(words, pw), ITERS)
    plain = time_ms(lambda: checksum.chunk_checksums_torch(words, pw), 2)
    dst = torch.empty_like(words)
    copy = time_ms(lambda: dst.copy_(words), ITERS)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms(n * pw * 4 + 8 * n, bw), "bound_by": "bytes",
            "library_ms": None, "copy_ms": copy, "shape": f"n={n} pw={pw}"}


def phase_land_and_checksum(k: int, n_slots: int, pw: int, gen, device,
                            bw: float) -> dict:
    """K2 against its plain version: k pieces into shuffled slots of a
    n_slots-slot buffer whose other slots must keep their bytes, timed;
    and the pinned host-to-device copy of one such batch, the landing's
    other device work."""
    buf_a = random_words(n_slots * pw, gen, device)
    buf_b = buf_a.clone()
    pieces = random_words(k * pw, gen, device).view(k, pw)
    perm = torch.randperm(n_slots, generator=torch.Generator().manual_seed(k))
    slots = perm[:k].to(torch.int32).to(device)
    _, s_a, x_a = checksum.land_and_checksum(buf_a, pieces, slots)
    _, s_b, x_b = checksum.land_and_checksum_torch(buf_b, pieces, slots)
    check_equal("land_and_checksum", [(buf_a, buf_b), (s_a, s_b), (x_a, x_b)])
    err = max_abs_err([(s_a, s_b), (x_a, x_b)])
    del buf_b
    ms = time_ms(lambda: checksum.land_and_checksum(buf_a, pieces, slots),
                 ITERS * 5)
    plain = time_ms(
        lambda: checksum.land_and_checksum_torch(buf_a, pieces, slots), 10)
    dst = torch.empty_like(pieces)
    copy = time_ms(lambda: dst.copy_(pieces), ITERS * 5)
    pinned = torch.empty((k, pw), dtype=torch.int32, pin_memory=True)
    h2d = time_ms(lambda: dst.copy_(pinned, non_blocking=True), ITERS)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms(2 * k * pw * 4 + 12 * k, bw),
            "bound_by": "bytes", "library_ms": None, "copy_ms": copy,
            "h2d_batch_ms": h2d, "shape": f"k={k} slots={n_slots} pw={pw}"}


def phase_odd_shapes(gen, device) -> None:
    """Both kernels at shapes the TPU kernels refused: odd piece sizes,
    piece counts that are not multiples of 8, a word buffer that does not
    start on a 16-byte boundary, and all-ones words that wrap the sum."""
    for n, pw in ((13, 1001), (9, 7), (3, 1)):
        words = random_words(n * pw + 1, gen, device)
        for w in (words[:-1], words[1:]):   # aligned and 4-byte offset start
            check_equal(f"chunk_checksums n={n} pw={pw}",
                        zip(checksum.chunk_checksums(w, pw),
                            checksum.chunk_checksums_torch(w, pw)))
    ones = torch.full((9 * 7,), -1, dtype=torch.int32, device=device)
    s, x = checksum.chunk_checksums(ones, 7)
    if not (checksum.to_u32(s).cpu().numpy() == (7 * 0xFFFFFFFF) % (1 << 32)).all():
        raise AssertionError("all-ones sum does not wrap mod 2^32")
    if not (checksum.to_u32(x).cpu().numpy() == 0xFFFFFFFF).all():
        raise AssertionError("all-ones xor wrong")
    for k, n_slots, pw in ((13, 29, 1001), (3, 5, 7)):
        buf = random_words(n_slots * pw, gen, device)
        ref = buf.clone()
        pieces = random_words(k * pw, gen, device).view(k, pw)
        slots = torch.randperm(n_slots, generator=torch.Generator().manual_seed(pw))
        slots = slots[:k].to(torch.int32).to(device)
        _, s_a, x_a = checksum.land_and_checksum(buf, pieces, slots)
        _, s_b, x_b = checksum.land_and_checksum_torch(ref, pieces, slots)
        check_equal(f"land_and_checksum k={k} pw={pw}",
                    [(buf, ref), (s_a, s_b), (x_a, x_b)])


# --------------------------------------------------------------------- #
# Main path: one checkpoint shard through the device sink
# --------------------------------------------------------------------- #

def shard_layout(widths: dict, layers: int) -> list[tuple[str, tuple]]:
    h, kv, inter = widths["hidden"], widths["kv"], widths["inter"]
    out = [("model.embed_tokens.weight", (widths["vocab"], h))]
    for i in range(layers):
        p = f"model.layers.{i}."
        out += [(p + "self_attn.q_proj.weight", (h, h)),
                (p + "self_attn.k_proj.weight", (kv, h)),
                (p + "self_attn.v_proj.weight", (kv, h)),
                (p + "self_attn.o_proj.weight", (h, h)),
                (p + "mlp.gate_proj.weight", (inter, h)),
                (p + "mlp.up_proj.weight", (inter, h)),
                (p + "mlp.down_proj.weight", (h, inter)),
                (p + "input_layernorm.weight", (h,)),
                (p + "post_attention_layernorm.weight", (h,))]
    return out


def make_shard(layout, gen, device) -> tuple[np.ndarray, dict]:
    """A safetensors file of random bf16 tensors, as host bytes. The
    values are drawn on the card; the header is padded to 8 bytes, as the
    safetensors library writes it. Returns (content, {name: (begin, end)})
    with absolute byte spans."""
    header, off = {}, 0
    for name, shape in layout:
        nbytes = int(np.prod(shape)) * 2
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    start = 8 + len(hjson)
    content = np.empty(start + off, dtype=np.uint8)
    content[:8] = np.frombuffer(len(hjson).to_bytes(8, "little"), np.uint8)
    content[8:start] = np.frombuffer(hjson, np.uint8)
    spans = {}
    for name, shape in layout:
        b, e = header[name]["data_offsets"]
        t = torch.randn(shape, dtype=torch.bfloat16, device=device,
                        generator=gen)
        content[start + b:start + e] = t.view(-1).view(torch.uint8).cpu().numpy()
        spans[name] = (start + b, start + e)
    return content, spans


class _PieceRec:
    __slots__ = ("num", "digest")

    def __init__(self, num: int):
        self.num = num
        self.digest = ""


class _StoreMeta:
    def __init__(self, content_length: int, piece_size: int, pieces: dict):
        self.content_length = content_length
        self.piece_size = piece_size
        self.pieces = pieces


class ShardStore:
    """The surface of the daemon's task store that the device sink
    manager uses, over bytes held in host memory."""

    def __init__(self, content: np.ndarray, piece_size: int):
        self._content = content
        n = compute_piece_count(content.size, piece_size)
        self.metadata = _StoreMeta(content.size, piece_size,
                                   {i: _PieceRec(i) for i in range(n)})

    def read_piece(self, num: int):
        ps = self.metadata.piece_size
        return memoryview(self._content[num * ps:(num + 1) * ps])

    def get_pieces(self):
        return list(self.metadata.pieces.values())


def gate_breakdown(u8: torch.Tensor, piece_size: int, host_checksums) -> dict:
    """Where the verify gate's time goes once warm: the whole gate on the
    host clock; its device parts by CUDA events (K1 over the whole pieces,
    then zero-padding the short last piece and K1 over it); and the
    read-back of the checksums to the host, on the host clock."""
    pw = piece_size // 4
    full = u8.numel() // piece_size
    head = u8[:full * piece_size].view(torch.int32)
    rest = u8[full * piece_size:]

    def last_piece():
        t = torch.zeros(piece_size, dtype=torch.uint8, device=u8.device)
        t[:rest.numel()] = rest
        return checksum.chunk_checksums(t.view(torch.int32), pw)

    parts = [checksum.chunk_checksums(head, pw), last_piece()]

    def readback():
        torch.cat([s for s, _ in parts]).cpu()
        torch.cat([x for _, x in parts]).cpu()

    return {"warm_ms": host_ms(lambda: verify_u8_against_host(
                u8, piece_size, host_checksums), 5),
            "k1_pieces_ms": time_ms(
                lambda: checksum.chunk_checksums(head, pw), 5),
            "last_piece_ms": time_ms(last_piece, 5),
            "readback_ms": host_ms(readback, 5)}


def drive_main_path(content: np.ndarray, spans: dict, layout, piece_size: int,
                    seed: int, device: torch.device) -> dict:
    """Land ``content`` through the port's entry points and check it."""
    store = ShardStore(content, piece_size)
    n_pieces = len(store.metadata.pieces)
    order = list(range(n_pieces))
    np.random.default_rng(seed).shuffle(order)
    mgr = DeviceSinkManager(batch_pieces=BATCH_PIECES, device=device)
    task_id = f"chip-smoke-{seed}"
    times = {}

    async def land_and_finalize():
        t0 = time.perf_counter()
        for num in order:
            await mgr.on_piece(task_id, store, store.metadata.pieces[num])
        t1 = time.perf_counter()
        sink = await mgr.finalize(task_id, store)
        t2 = time.perf_counter()
        times["land_s"], times["finalize_s"] = t1 - t0, t2 - t1
        return sink

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    checksum.chunk_checksums.launches = 0
    checksum.land_and_checksum.launches = 0
    try:
        sink = asyncio.run(land_and_finalize())
        if sink is None:
            raise AssertionError("finalize returned None: the landing "
                                 "degraded to disk-only")
        taken = mgr.take(task_id)
        if taken is not sink or not taken.verified:
            raise AssertionError("take() did not return the verified sink")
        t0 = time.perf_counter()
        u8 = taken.as_bytes_array()
        verify_u8_against_host(u8, taken.sink.piece_size,
                               taken.sink.host_checksums)
        t1 = time.perf_counter()
        tensors = load_from_sink(taken)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        mgr.close()
    launches = {"chunk_checksums": checksum.chunk_checksums.launches,
                "land_and_checksum": checksum.land_and_checksum.launches}
    times["verify_gate_s"], times["load_s"] = t1 - t0, t2 - t1
    # The landing's host time by share, accumulated inside land_piece and
    # flush while the pieces landed.
    for key in ("host_checksum_s", "stage_s", "stage_wait_s"):
        times[key] = getattr(taken.sink, key)
    peak = torch.cuda.max_memory_allocated()

    # What came out: every byte, and every tensor by name, shape and value.
    host = torch.from_numpy(content).to(device)
    if not torch.equal(u8, host):
        raise AssertionError("landed bytes differ from the shard")
    if set(tensors) != {name for name, _ in layout}:
        raise AssertionError("tensor names differ from the header")
    for name, shape in layout:
        t = tensors[name]
        b, e = spans[name]
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"{name}: {t.dtype} {tuple(t.shape)}")
        if not torch.equal(t.reshape(-1).view(torch.uint8), host[b:e]):
            raise AssertionError(f"{name}: bytes differ from the shard")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite values")
    want_k2 = -(-n_pieces // BATCH_PIECES)
    if launches["land_and_checksum"] != want_k2:
        raise AssertionError(f"land_and_checksum launched "
                             f"{launches['land_and_checksum']} times, "
                             f"want {want_k2}")
    if launches["chunk_checksums"] < 1:
        raise AssertionError("chunk_checksums never launched on the path")
    gate = gate_breakdown(u8, taken.sink.piece_size, taken.sink.host_checksums)
    return {"pieces": n_pieces, "piece_size": piece_size, "times": times,
            "verify_gate_warm": gate, "launches": launches,
            "peak_device_bytes": peak, "tensors": len(tensors)}


def phase_corruption(device: torch.device) -> str:
    """A piece whose host checksum disagrees must fail verify, by name."""
    piece = 1 << 20
    data = np.random.default_rng(7).integers(0, 256, 4 * piece, np.uint8)
    sink = TaskDeviceSink("chip-smoke-corrupt", data.size, piece,
                          device=device, batch_pieces=BATCH_PIECES)
    for n in range(4):
        sink.land(n, memoryview(data[n * piece:(n + 1) * piece]))
    s, x = sink.sink.host_checksums[2]
    sink.sink.host_checksums[2] = (s ^ 1, x)
    try:
        sink.verify()
    except DeviceSinkError as e:
        if "piece 2" not in str(e):
            raise AssertionError(f"corruption reported without its piece: {e}")
        return str(e)
    raise AssertionError("a corrupt piece passed verification")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    bw = card_bandwidth(name)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound at "
          f"{bw / 1e12:.2f} TB/s")

    _build.library()
    print(f"kernels built in {_build.build_seconds:.1f} s "
          f"({_build.library_path()})")
    if _build.build_log:
        print(_build.build_log)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    layout = shard_layout(LLAMA_8B, SHARD_LAYERS)
    content_length = 8 + sum(int(np.prod(s)) * 2 for _, s in layout)
    piece_size = compute_piece_size(content_length)
    n_pieces = compute_piece_count(content_length, piece_size)
    pw = piece_size // 4

    k1 = phase_chunk_checksums(n_pieces, pw, gen, device, bw)
    print("kernel chunk_checksums:", json.dumps(k1))
    torch.cuda.empty_cache()
    k2 = phase_land_and_checksum(BATCH_PIECES, n_pieces, pw, gen, device, bw)
    print("kernel land_and_checksum:", json.dumps(k2))
    torch.cuda.empty_cache()
    phase_odd_shapes(gen, device)
    print("odd shapes: both kernels match their plain versions")

    t0 = time.perf_counter()
    content, spans = make_shard(layout, gen, device)
    print(f"shard: {content.size} bytes, {len(layout)} tensors, "
          f"{n_pieces} pieces of {piece_size}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    main_path = drive_main_path(content, spans, layout, piece_size, args.seed,
                                device)
    t = main_path["times"]
    landed_s = t["land_s"] + t["finalize_s"]
    print("main path:", json.dumps(main_path))
    print(f"main path: landed and verified {content.size / 1e9:.3f} GB in "
          f"{landed_s:.3f} s ({content.size / landed_s / 1e9:.2f} GB/s), "
          f"verify gate {content.size / t['verify_gate_s'] / 1e9:.2f} GB/s, "
          f"peak device memory {main_path['peak_device_bytes'] / 1e9:.2f} GB "
          f"on {smi}")
    launches_k2 = main_path["launches"]["land_and_checksum"]
    device_s = launches_k2 * (k2["h2d_batch_ms"] + k2["ms"]) / 1e3
    print(f"landing: land_s {t['land_s']:.4f} s = host checksum "
          f"{t['host_checksum_s']:.4f} s + staging copy {t['stage_s']:.4f} s "
          f"+ waits on the card {t['stage_wait_s']:.4f} s + the rest; device "
          f"work, estimated as {launches_k2} x (one pinned batch copy + one "
          f"K2) = {device_s:.4f} s")
    print("corruption:", phase_corruption(device))

    kernels = []
    for kname, res, replaces in (
            ("chunk_checksums", k1, "dragonfly2_tpu/ops/checksum.py:67"),
            ("land_and_checksum", k2, "dragonfly2_tpu/ops/checksum.py:133")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "dragonfly2_tpu_torch/csrc/checksum.cu",
            "replaces": replaces,
            "launches": main_path["launches"][kname],
            **{key: res[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms",
                                         "copy_ms", "shape")},
            "match": True})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
