#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device-sink path on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--parent DIR]

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``dragonfly2_tpu_torch/csrc`` with nvcc
   and prints each kernel's registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, at the feed's shape (K2: 64 token
   records into 64 slots) and at odd shapes (K2 also: one piece, a piece
   count that is not a multiple of its cluster, pieces smaller than one
   stage, source and slot at different 16-byte phases, the sink's
   per-slot outputs, a slot out of range), and times each kernel by its
   device time (``device_time``: events around many back-to-back calls
   with the host running ahead, over their count; at the feed's shape
   over 16 input sets in turn, more than the L2 holds) beside the host's
   microseconds per call, the plain version, a ``copy_`` of the same
   bytes and, for K2, its register path alone and its other launch
   plans; with ``--parent DIR`` also times the kernels of the checkout in
   DIR against this tree's, in turns;
4. lands one checkpoint shard the size of Llama-3.1-8B's
   ``model-00001-of-00004.safetensors`` (~4.98 GB: the embedding and
   layers 0-8 at the published widths, random bf16 from ``--seed``)
   through ``DeviceSinkManager.on_piece`` in shuffled piece order, then
   ``finalize`` -> ``take`` -> ``verify_u8_against_host`` ->
   ``load_from_sink``; checks every landed byte and tensor, and that the
   path launched both kernels; splits the landing's host time and the
   verify gate's time into their parts; then checks that a corrupt piece
   fails verification by name;
5. hot-swaps the landed shard to a second generation (the last two
   layers redrawn and every RMSNorm weight perturbed, from ``--seed``)
   through ``swap_generation``, the device half of ``download_delta``:
   reused 1.25 MiB chunks copy out of the live buffer, the changed ones
   stage from the host, the verify gate checks the spare buffer, and a
   ``DoubleBuffer`` flips while a reader thread takes snapshots; checks
   every byte and tensor, the byte accounting against the plan, and that
   a wrong host checksum fails the gate by piece and does not flip;
6. spreads the main path's verified sink over a device mesh (the
   ``mesh`` path, a world of one rank over NCCL: the card holds one
   GPU): ``initialize_distributed`` with explicit arguments,
   ``make_mesh`` and a manager's ``default_mesh``; ``shard_to_mesh``
   (its shard the sink's own buffer), ``ici_broadcast`` (bytes equal,
   device time beside a ``copy_``), ``all_gather_shards``,
   ``replicate_to_mesh``, ``load_from_sink(shardings=...)`` on a
   ``("dp", "tp")`` mesh, ``global_replicated`` and
   ``global_from_local_shards`` (no copy), and a ``StripedBroadcast``
   fed in 32 MiB host chunks; prints the phase's peak device memory and
   its ``torch.distributed`` calls per function;
7. feeds 64 batches of 64 token records (8192 int32 ids each) and a
   short batch of 17 through ``DeviceFeed``, some records zero-padded,
   and checks every batch against the host records; then runs a short
   feed window under ``torch.profiler`` and prints the device operations
   it queued and K2's kernel time by name;
8. checks each kernel's launches on each path (main, hot_swap, mesh,
   feed), prints one ``{"kernels": [...]}`` line with them and, last,
   one ``{"ok": true, "device": {...}}`` line.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_tpu_torch.client.device import swap_generation
from dragonfly2_tpu_torch.daemon.peer.device_sink import (
    DeviceSinkError,
    DeviceSinkManager,
    TaskDeviceSink,
)
from dragonfly2_tpu_torch.dataset.device_feed import DEVICE_BATCHES, DeviceFeed
from dragonfly2_tpu_torch.delta.manifest import CDCParams, Chunk, DeltaManifest
from dragonfly2_tpu_torch.ops import _build, checksum
from dragonfly2_tpu_torch.ops.convert import placements_from_spec
from dragonfly2_tpu_torch.ops.hbm_sink import DoubleBuffer, verify_u8_against_host
from dragonfly2_tpu_torch.ops.safetensors import load_from_sink
from dragonfly2_tpu_torch.parallel import ici, multihost
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import compute_piece_count, compute_piece_size

# Llama-3.1-8B (meta-llama/Llama-3.1-8B config.json): hidden 4096,
# intermediate 14336, 32 heads / 8 KV heads of 128, vocab 128256.
LLAMA_8B = {"hidden": 4096, "kv": 1024, "inter": 14336, "vocab": 128256}
SHARD_LAYERS = 9          # shard 1 of 4 holds the embedding and layers 0-8
BATCH_PIECES = 8
# The delta chunk: the default CDC geometry's expected size (CDCParams,
# ~1.25 MiB), cut at fixed offsets here.
CHUNK = 1280 << 10
# Dataset feed: sequences of 8192 int32 token ids (the pre-training
# context of "The Llama 3 Herd of Models", section 3.4), 64 per batch.
SEQ_TOKENS = 8192
FEED_BATCH = 64
FEED_BATCHES = 64
FEED_TAIL = 17            # the short final batch


def card_bandwidth(name: str) -> float:
    """Peak memory rate in bytes/s by card name (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in name else 3.35e12   # PCIe, else SXM (HBM3)


def bound_ms(nbytes: int, bandwidth: float) -> float:
    """The bytes bound. Both kernels do two 32-bit integer operations per
    4-byte word, so their operations bound (tens of TOPS) stays below a
    fortieth of this one: every kernel here is ``bound_by`` bytes."""
    return nbytes / bandwidth * 1e3


# Clock of the card's spin (torch.cuda._sleep counts SM cycles; an H100's
# SM clock is at most 1.98 GHz, so this overstates the spin's length).
SPIN_HZ = 2.0e9


def device_time(fn, n: int, windows: int = 3) -> tuple[float, float]:
    """(ms, call_us) of ``fn(j)``, j = 0 .. n-1, called back to back.

    ``ms`` is the device time per call: CUDA events around all n calls,
    over n. A spin of the card (``torch.cuda._sleep``) is queued first,
    longer than the host takes to queue the n calls, so the host runs
    ahead and the card never waits on it inside the window. ``call_us``
    is the host's microseconds per call over the same n calls, taken
    without a sync. A first untimed pass warms up and sizes the spin;
    both numbers are the median of ``windows`` timed passes."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(n):
        fn(j)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ms, us = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((3 * host_s + 1e-3) * SPIN_HZ))
        start.record()
        t0 = time.perf_counter()
        for j in range(n):
            fn(j)
        call_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / n)
        us.append(call_s / n * 1e6)
    return statistics.median(ms), statistics.median(us)


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
    ms, call_us = device_time(
        lambda j: checksum.chunk_checksums(words, pw), 10)
    plain, _ = device_time(
        lambda j: checksum.chunk_checksums_torch(words, pw), 2, windows=1)
    dst = torch.empty_like(words)
    copy, _ = device_time(lambda j: dst.copy_(words), 10)
    return {"max_abs_err": err, "ms": ms, "call_us": call_us,
            "plain_ms": plain,
            "bound_ms": bound_ms(n * pw * 4 + 8 * n, bw), "bound_by": "bytes",
            "library_ms": None, "copy_ms": copy, "shape": f"n={n} pw={pw}"}


def land_sets(k: int, n_slots: int, pw: int, sets: int, gen, device):
    """``sets`` distinct (buffer, pieces, slots) triples: k random pieces
    for shuffled slots of a random n_slots-slot buffer."""
    out = []
    for r in range(sets):
        buf = random_words(n_slots * pw, gen, device)
        pieces = random_words(k * pw, gen, device).view(k, pw)
        perm = torch.randperm(n_slots,
                              generator=torch.Generator().manual_seed(k + r))
        out.append((buf, pieces, perm[:k].to(torch.int32).to(device)))
    return out


def phase_land_and_checksum(k: int, n_slots: int, pw: int, gen, device,
                            bw: float, sets: int = 1, n: int = 40) -> dict:
    """K2 against its plain version: k pieces into shuffled slots of a
    n_slots-slot buffer whose other slots must keep their bytes. Then
    timed over ``sets`` distinct inputs taken in turn (enough that the
    card's 50 MB L2 holds none of them from one call to its next), beside
    the same launch with the register path only, a ``copy_`` of the same
    bytes, the plain version, and the pinned host-to-device copy of one
    batch, the landing's other device work."""
    data = land_sets(k, n_slots, pw, sets, gen, device)
    buf_a, pieces, slots = data[0]
    buf_b = buf_a.clone()
    _, s_a, x_a = checksum.land_and_checksum(buf_a, pieces, slots)
    _, s_b, x_b = checksum.land_and_checksum_torch(buf_b, pieces, slots)
    check_equal("land_and_checksum", [(buf_a, buf_b), (s_a, s_b), (x_a, x_b)])
    err = max_abs_err([(s_a, s_b), (x_a, x_b)])
    del buf_b
    plan = checksum._land_plan(k, pw, checksum._phase(pieces),
                               checksum._phase(buf_a))
    registers = plan._replace(stage_words=0, stages=0, threads=1024)

    def land(j, p=None):
        checksum.land_and_checksum(*data[j % sets], plan=p)

    ms, call_us = device_time(land, n)
    reg_ms, _ = device_time(lambda j: land(j, registers), n)
    dsts = [torch.empty_like(p) for _, p, _ in data]
    copy, _ = device_time(lambda j: dsts[j % sets].copy_(data[j % sets][1]), n)
    plain, _ = device_time(
        lambda j: checksum.land_and_checksum_torch(*data[j % sets]),
        max(2, n // 20), windows=1)
    pinned = torch.empty((k, pw), dtype=torch.int32, pin_memory=True)
    h2d, _ = device_time(lambda j: dsts[0].copy_(pinned, non_blocking=True),
                         10)
    return {"max_abs_err": err, "ms": ms, "call_us": call_us,
            "plain_ms": plain,
            "bound_ms": bound_ms(2 * k * pw * 4 + 12 * k, bw),
            "bound_by": "bytes", "library_ms": None, "copy_ms": copy,
            "register_path_ms": reg_ms, "plan": plan._asdict(),
            "l2_rotation_sets": sets, "h2d_batch_ms": h2d,
            "shape": f"k={k} slots={n_slots} pw={pw}"}


def land_case(gen, device, k: int, n_slots: int, pw: int, src_off: int = 0,
              dst_off: int = 0, per_slot: bool = False,
              out_of_range: bool = False) -> None:
    """K2 against its plain version at one shape: pieces and buffer
    starting ``src_off`` and ``dst_off`` words past a random word buffer's
    start; with ``per_slot``, the sink's per-slot output arrays; with
    ``out_of_range``, piece 0 aimed past the last slot, which must leave
    the buffer untouched and (without per-slot arrays) give 0, 0."""
    buf = random_words(n_slots * pw + dst_off, gen, device)[dst_off:]
    pieces = random_words(k * pw + src_off, gen, device)[src_off:].view(k, pw)
    perm = torch.randperm(n_slots, generator=torch.Generator().manual_seed(pw))
    slots = perm[:k].to(torch.int32).to(device)
    if out_of_range:
        slots[0] = n_slots
    ref = buf.clone()
    keep = slice(1 if out_of_range else 0, k)
    what = (f"land_and_checksum k={k} slots={n_slots} pw={pw} offsets "
            f"{src_off}/{dst_off} per_slot={per_slot} "
            f"out_of_range={out_of_range}")
    if per_slot:
        outs = [random_words(n_slots, gen, device) for _ in range(2)]
        want = [t.clone() for t in outs]
        checksum.land_and_checksum(buf, pieces, slots, *outs)
        checksum.land_and_checksum_torch(ref, pieces[keep],
                                         slots[keep].clone(), *want)
        check_equal(what, [(buf, ref), *zip(outs, want)])
        return
    _, s_a, x_a = checksum.land_and_checksum(buf, pieces, slots)
    _, s_b, x_b = checksum.land_and_checksum_torch(ref, pieces[keep],
                                                   slots[keep].clone())
    zero = torch.zeros(k - s_b.numel(), dtype=torch.int32, device=device)
    check_equal(what, [(buf, ref), (s_a, torch.cat([zero, s_b])),
                       (x_a, torch.cat([zero, x_b]))])


def phase_odd_shapes(gen, device) -> None:
    """Both kernels at shapes the TPU kernels refused: odd piece sizes,
    piece counts that are not multiples of 8, a word buffer that does not
    start on a 16-byte boundary, and all-ones words that wrap the sum; K2
    also at one piece (a sink's last flush), a piece count that is not a
    multiple of its cluster, pieces smaller than one stage of its ring,
    pieces whose source and slot differ in 16-byte phase, the sink's
    per-slot outputs, and a slot out of range."""
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
    for k, n_slots, pw, src_off, dst_off in (
            (13, 29, 1001, 0, 0), (3, 5, 7, 0, 0),
            (1, 4, 1 << 20, 0, 0),       # one piece of 4 MiB
            (13, 40, 70_000, 0, 0),      # 13 pieces, clusters of 8
            (4, 8, 2048, 0, 0),          # pieces smaller than one stage
            (8, 16, 65536, 1, 0),        # 16-byte phases differ
            (8, 16, 65536, 2, 2),        # both off a 16-byte boundary
            (9, 20, 3001, 1, 3)):
        for per_slot in (False, True):
            land_case(gen, device, k, n_slots, pw, src_off, dst_off, per_slot)
    if _on_card(device):   # the plain version refuses a slot out of range
        for per_slot in (False, True):
            land_case(gen, device, 6, 12, 65536, per_slot=per_slot,
                      out_of_range=True)


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
        self.total_piece_count = len(pieces)
        self.pieces = pieces


class ShardStore:
    """The surface of the daemon's completed task store that the device
    sink manager and the hot-swap use, over bytes held in host memory."""

    def __init__(self, content: np.ndarray, piece_size: int):
        self._content = content
        n = compute_piece_count(content.size, piece_size)
        self.metadata = _StoreMeta(content.size, piece_size,
                                   {i: _PieceRec(i) for i in range(n)})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read_piece(self, num: int):
        ps = self.metadata.piece_size
        return memoryview(self._content[num * ps:(num + 1) * ps])

    def read_into(self, offset: int, length: int, buf) -> None:
        memoryview(buf)[:length] = memoryview(
            self._content[offset:offset + length])

    def get_pieces(self):
        return list(self.metadata.pieces.values())


class CorruptPiece(ShardStore):
    """A store whose piece ``bad`` reads with one bit flipped, so its host
    checksum disagrees with the landed bytes."""

    def __init__(self, store: ShardStore, bad: int):
        self._content = store._content
        self.metadata = store.metadata
        self.bad = bad

    def read_piece(self, num: int):
        data = super().read_piece(num)
        if num != self.bad:
            return data
        out = bytearray(data)
        out[0] ^= 1
        return out


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
            "k1_pieces_ms": device_time(
                lambda j: checksum.chunk_checksums(head, pw), 5)[0],
            "last_piece_ms": device_time(lambda j: last_piece(), 5)[0],
            "readback_ms": host_ms(readback, 5)}


def drive_main_path(content: np.ndarray, spans: dict, layout, piece_size: int,
                    seed: int, device: torch.device):
    """Land ``content`` through the port's entry points and check it.
    Returns the report and the verified sink the caller took."""
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
            "peak_device_bytes": peak, "tensors": len(tensors)}, taken


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


# --------------------------------------------------------------------- #
# Hot swap: the landed shard to its next generation, through the device
# half of download_delta
# --------------------------------------------------------------------- #

def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def make_generation2(content: np.ndarray, spans: dict, layout, gen,
                     device) -> tuple[np.ndarray, list, dict]:
    """The same layout after a fine-tune of the last two blocks plus
    every RMSNorm: the last two layers redrawn (one contiguous run) and
    both norm weights of every other layer redrawn (small, scattered).
    Returns (content, changed byte spans, counts)."""
    out = content.copy()
    layers = sorted({int(n.split(".")[2]) for n, _ in layout
                     if n.startswith("model.layers.")})
    last_two = {f"model.layers.{i}." for i in layers[-2:]}
    redrawn = [(n, s) for n, s in layout
               if any(n.startswith(p) for p in last_two)]
    norms = [(n, s) for n, s in layout if n.endswith("layernorm.weight")
             and not any(n.startswith(p) for p in last_two)]
    for name, shape in redrawn + norms:
        b, e = spans[name]
        t = torch.randn(shape, dtype=torch.bfloat16, device=device,
                        generator=gen)
        out[b:e] = t.view(-1).view(torch.uint8).cpu().numpy()
        if np.array_equal(out[b:e], content[b:e]):
            raise AssertionError(f"{name}: redraw left the bytes unchanged")
    run = (spans[redrawn[0][0]][0], spans[redrawn[-1][0]][1])
    if run[1] - run[0] != sum(spans[n][1] - spans[n][0] for n, _ in redrawn):
        raise AssertionError("the redrawn layers are not one contiguous run")
    changed = [run] + [spans[n] for n, _ in norms]
    return out, changed, {
        "redrawn_tensors": len(redrawn), "redrawn_bytes": run[1] - run[0],
        "perturbed_tensors": len(norms),
        "perturbed_bytes": sum(spans[n][1] - spans[n][0] for n, _ in norms)}


def fixed_manifest(content: np.ndarray, name: str,
                   chunk: int = CHUNK) -> DeltaManifest:
    """A manifest of fixed-size chunks, hashed with sha256 over the host
    bytes in parallel threads (hashlib releases the interpreter lock)."""
    mv = memoryview(content)
    offsets = range(0, content.size, chunk)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4,
                            thread_name_prefix="df-chip-sha") as ex:
        digests = list(ex.map(
            lambda o: hashlib.sha256(mv[o:o + chunk]).hexdigest(), offsets))
    m = DeltaManifest(name=name, content_length=content.size, params=CDCParams(),
                      chunks=[Chunk(o, min(chunk, content.size - o), d)
                              for o, d in zip(offsets, digests)])
    m.validate()
    return m


def planned_bytes(total: int, changed, chunk: int = CHUNK) -> tuple[int, int]:
    """(reused, staged) bytes the delta must come to: every chunk that
    holds a changed byte is staged, every other chunk reused."""
    hit = set()
    for b, e in changed:
        hit.update(range(b // chunk, (e - 1) // chunk + 1))
    staged = sum(min(chunk, total - i * chunk) for i in hit)
    return total - staged, staged


def phase_hot_swap(content: np.ndarray, spans: dict, layout, taken,
                   piece_size: int, gen, device: torch.device,
                   chunk: int = CHUNK) -> dict:
    """Generation 1 (the main path's verified sink) goes live in a
    DoubleBuffer; generation 2 swaps in through swap_generation while a
    reader thread takes snapshots across the flip."""
    live = taken.as_bytes_array()
    hot = DoubleBuffer()
    hot.flip(live, load_from_sink(taken))
    t0 = time.perf_counter()
    gen2, changed, counts = make_generation2(content, spans, layout, gen,
                                             device)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base_m = fixed_manifest(content, "generation-1", chunk)
    new_m = fixed_manifest(gen2, "generation-2", chunk)
    manifest_s = time.perf_counter() - t0
    store = ShardStore(gen2, piece_size)
    want_reused, want_staged = planned_bytes(content.size, changed, chunk)

    mixed: list = []
    seen: dict = {}
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            g, buf, tensors = hot.snapshot()
            ptr = buf.untyped_storage().data_ptr()
            if any(t.untyped_storage().data_ptr() != ptr
                   for t in tensors.values()):
                mixed.append(g)
            seen[g] = seen.get(g, 0) + 1
            time.sleep(50e-6)

    if _on_card(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    checksum.chunk_checksums.launches = 0
    checksum.land_and_checksum.launches = 0
    thread = threading.Thread(target=reader, name="df-chip-reader")
    thread.start()
    try:
        t0 = time.perf_counter()
        result = swap_generation(store, live_u8=live, new_m=new_m,
                                 base_m=base_m, hot=hot, device=device,
                                 task_id="chip-smoke-generation-2")
        if _on_card(device):
            torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        launches = {"chunk_checksums": checksum.chunk_checksums.launches,
                    "land_and_checksum": checksum.land_and_checksum.launches}
        peak = torch.cuda.max_memory_allocated() if _on_card(device) else 0
        time.sleep(0.05)               # snapshots of the new generation
    finally:
        stop.set()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("snapshot reader did not stop")

    # What came out: the flip, every byte, every tensor, the accounting.
    buf = hot.buffer()
    if not (result.flipped and result.on_device and hot.generation == 2
            and buf is result.buffer):
        raise AssertionError(f"no flip to generation 2: {result.generation}")
    if mixed:
        raise AssertionError(f"mixed-generation snapshots: {mixed[:3]}")
    if set(seen) != {1, 2}:
        raise AssertionError(f"reader saw generations {sorted(seen)}")
    if not equal_in_steps(buf, gen2):
        raise AssertionError("flipped buffer differs from generation 2")
    tensors = hot.tensors()
    if set(tensors) != {name for name, _ in layout}:
        raise AssertionError("tensor names differ from the header")
    for name, shape in layout:
        t = tensors[name]
        b, e = spans[name]
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"{name}: {t.dtype} {tuple(t.shape)}")
        if not torch.equal(t.reshape(-1).view(torch.uint8), buf[b:e]):
            raise AssertionError(f"{name}: bytes differ from generation 2")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite values")
    got = (result.reused_device_bytes, result.staged_bytes)
    if got != (want_reused, want_staged):
        raise AssertionError(f"reused/staged {got} != plan "
                             f"{(want_reused, want_staged)}")
    if _on_card(device) and launches["chunk_checksums"] < 1:
        raise AssertionError("chunk_checksums never launched on the swap")

    # Warm gate, on the flipped buffer.
    checks = {rec.num: checksum.checksum_numpy(store.read_piece(rec.num))
              for rec in store.get_pieces()}
    gate_warm_ms = host_ms(
        lambda: verify_u8_against_host(buf, piece_size, checks), 5)

    # A generation 2 whose host checksum of one piece is wrong fails the
    # gate by piece number, and the live generation stays.
    bad = store.metadata.total_piece_count // 2
    try:
        swap_generation(CorruptPiece(store, bad), live_u8=live, new_m=new_m,
                        base_m=base_m, hot=hot, device=device)
    except DfError as e:
        if e.code != Code.ClientPieceDownloadFail or f"piece {bad} " not in str(e):
            raise AssertionError(f"wrong gate failure: {e!r}")
        refused = str(e)
    else:
        raise AssertionError("a wrong host checksum passed the gate")
    if hot.generation != 2 or hot.buffer() is not buf:
        raise AssertionError("the refused generation flipped")
    return {"content_bytes": content.size, "chunk": chunk,
            "chunks": new_m.num_chunks, **counts,
            "reused_device_bytes": result.reused_device_bytes,
            "staged_bytes": result.staged_bytes, "copies": result.copies,
            "timings": result.timings, "swap_s": swap_s,
            "gate_warm_ms": gate_warm_ms, "made_s": made_s,
            "manifest_s": manifest_s, "peak_device_bytes": peak,
            "snapshots": seen, "launches": launches, "refused": refused}


# --------------------------------------------------------------------- #
# The mesh path: the verified sink spread over a device mesh
# --------------------------------------------------------------------- #

STRIPE_CHUNK = 32 << 20


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def equal_in_steps(dev_u8: torch.Tensor, host_u8: np.ndarray,
                   step: int = 256 << 20) -> bool:
    """``dev_u8`` equals the host bytes, compared a step at a time."""
    if dev_u8.numel() != host_u8.size:
        return False
    return all(torch.equal(dev_u8[o:o + step], torch.from_numpy(
        host_u8[o:o + step]).to(dev_u8.device))
        for o in range(0, host_u8.size, step))


def phase_mesh(content: np.ndarray, layout, taken,
               device: torch.device) -> dict:
    """The verified sink through the port's mesh layer in a world of one
    rank over NCCL: every placement checked against the landed bytes, the
    zero-copy ones by ``data_ptr``. The caller zeroes nothing: the counts
    are set to 0 here, just before the path, and read just after it."""
    multihost.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                     device=device, timeout_s=120)
    try:
        backend = dist.get_backend_config()
        if "cuda:nccl" not in backend:
            raise AssertionError(f"process group without NCCL: {backend}")
        buf = taken.sink._buffer
        u8 = taken.as_bytes_array()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        checksum.chunk_checksums.launches = 0
        checksum.land_and_checksum.launches = 0
        ici.reset_collective_counts()
        t0 = time.perf_counter()
        mesh = ici.make_mesh()
        mgr = DeviceSinkManager(device=device)
        try:
            host_mesh = mgr.default_mesh()
        finally:
            mgr.close()
        if (mesh.device_type, tuple(mesh.mesh.shape)) != ("cuda", (1,)) or (
                host_mesh.mesh_dim_names, tuple(host_mesh.mesh.shape)) != (
                ("d",), (1,)):
            raise AssertionError(f"meshes {mesh} and {host_mesh}")
        no_copy = {}
        sharded = taken.shard_to_mesh(mesh)
        no_copy["shard_to_mesh"] = sharded.to_local().data_ptr() == \
            buf.data_ptr()
        replicated = taken.ici_broadcast(mesh, n_chunks=4)
        if not torch.equal(replicated.to_local(), buf):
            raise AssertionError("ici_broadcast bytes differ from the sink")
        del replicated
        gathered = ici.all_gather_shards(mesh, sharded)
        if not torch.equal(gathered.to_local(), buf):
            raise AssertionError("all_gather_shards differs from the sink")
        del gathered
        head = content[:STRIPE_CHUNK]
        rep = ici.replicate_to_mesh(mesh, head)
        if not equal_in_steps(rep.to_local(), head):
            raise AssertionError("replicate_to_mesh differs from the host")
        del rep
        names = ("dp", "tp")
        first = "model.layers.0."
        specs = {"model.embed_tokens.weight": ("dp",),
                 first + "self_attn.q_proj.weight": (None, "tp"),
                 first + "input_layernorm.weight": (),
                 first + "post_attention_layernorm.weight": ()}
        mesh2 = multihost.global_mesh({"dp": 1, "tp": 1})
        shardings = {n: (mesh2, placements_from_spec(names, spec))
                     for n, spec in specs.items()}
        placed = load_from_sink(taken, shardings=shardings)
        plain = load_from_sink(taken)
        if set(placed) != {name for name, _ in layout}:
            raise AssertionError("load_from_sink(shardings=) lost tensors")
        for n in specs:
            local = placed[n].to_local()
            if not torch.equal(local, plain[n]):
                raise AssertionError(f"{n}: placed block differs")
            no_copy[f"load_from_sink {n}"] = (local.data_ptr()
                                              == plain[n].data_ptr())
        del placed, plain
        g = multihost.global_replicated(mesh, u8)
        no_copy["global_replicated"] = g.to_local().data_ptr() == u8.data_ptr()
        g = multihost.global_from_local_shards(mesh, u8)
        no_copy["global_from_local_shards"] = (g.to_local().data_ptr()
                                               == u8.data_ptr())
        del g
        t1 = time.perf_counter()
        sb = ici.StripedBroadcast(mesh, n_chunks=4)
        for o in range(0, content.size, STRIPE_CHUNK):
            sb.feed(content[o:o + STRIPE_CHUNK])
        striped = sb.result().to_local()
        striped_s = time.perf_counter() - t1
        if not equal_in_steps(striped, content):
            raise AssertionError("StripedBroadcast differs from the content")
        del striped, sb
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {"chunk_checksums": checksum.chunk_checksums.launches,
                    "land_and_checksum": checksum.land_and_checksum.launches}
        calls = ici.collective_counts()
        peak = torch.cuda.max_memory_allocated()
        if not all(no_copy.values()):
            raise AssertionError(f"placements that copied: {no_copy}")

        # Device time of the spread beside a copy_ of the same bytes.
        dst = torch.empty_like(buf)
        ici_ms, ici_us = device_time(
            lambda j: taken.ici_broadcast(mesh, n_chunks=4), 5)
        copy_ms, _ = device_time(lambda j: dst.copy_(buf), 5)
        del dst
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "ranks": 1, "bytes": buf.numel() * 4,
            "no_copy": no_copy, "collective_calls": calls,
            "launches": launches, "peak_device_bytes": peak,
            "path_s": path_s, "striped_feeds": -(-content.size
                                                // STRIPE_CHUNK),
            "striped_s": striped_s, "ici_broadcast_ms": ici_ms,
            "ici_broadcast_call_us": ici_us, "copy_ms": copy_ms}


# --------------------------------------------------------------------- #
# Dataset feed: token records into device batches
# --------------------------------------------------------------------- #

def token_records(seed: int, vocab: int, tokens: int = SEQ_TOKENS,
                  batches: int = FEED_BATCHES, batch: int = FEED_BATCH,
                  tail: int = FEED_TAIL) -> tuple[list, np.ndarray]:
    """``batches`` full batches and a ``tail`` of int32 token sequences;
    every seventh is cut short (a document end) and must be zero-padded.
    Returns (sample dicts, the padded records as uint8 rows)."""
    rng = np.random.default_rng(seed)
    n = batches * batch + tail
    ids = rng.integers(0, vocab, (n, tokens), dtype=np.int32)
    lengths = np.full(n, tokens)
    lengths[::7] = rng.integers(1, tokens, lengths[::7].size)
    for i in np.flatnonzero(lengths < tokens):
        ids[i, lengths[i]:] = 0
    samples = [{"__key__": f"seq-{i:06d}",
                "tokens": ids[i, :lengths[i]].tobytes()} for i in range(n)]
    return samples, ids.view(np.uint8)


def phase_feed(seed: int, vocab: int, device: torch.device, **shape) -> dict:
    """The records through DeviceFeed (pad=True), every batch checked
    against the host records."""
    samples, want = token_records(seed, vocab, **shape)
    record_bytes = want.shape[1]
    batch = shape.get("batch", FEED_BATCH)

    async def stream():
        for s in samples:
            yield s

    async def collect(feed):
        return [b async for b in feed.batches(stream())]

    feed = DeviceFeed("tokens", record_bytes, batch, pad=True, device=device)
    hbm, numpy_ = DEVICE_BATCHES.value("hbm"), DEVICE_BATCHES.value("numpy")
    if _on_card(device):
        torch.cuda.synchronize()
    checksum.chunk_checksums.launches = 0
    checksum.land_and_checksum.launches = 0
    t0 = time.perf_counter()
    batches = asyncio.run(collect(feed))
    if _on_card(device):
        torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    launches = {"chunk_checksums": checksum.chunk_checksums.launches,
                "land_and_checksum": checksum.land_and_checksum.launches}
    paths = {"hbm": DEVICE_BATCHES.value("hbm") - hbm,
             "numpy": DEVICE_BATCHES.value("numpy") - numpy_}

    sizes = [len(b.keys) for b in batches]
    want_sizes = [batch] * (len(samples) // batch) + (
        [len(samples) % batch] if len(samples) % batch else [])
    if sizes != want_sizes:
        raise AssertionError(f"batch sizes {sizes} != {want_sizes}")
    row = 0
    for b in batches:
        if not b.on_device or b.array.device.type != device.type:
            raise AssertionError("a batch did not land on the device")
        got = b.array.cpu().numpy()
        if not np.array_equal(got, want[row:row + len(b.keys)]):
            raise AssertionError(f"batch at record {row} differs from the "
                                 "host records")
        row += len(b.keys)
    if _on_card(device) and launches["land_and_checksum"] != len(batches):
        raise AssertionError(f"land_and_checksum launched "
                             f"{launches['land_and_checksum']} times for "
                             f"{len(batches)} batches")
    if paths != {"hbm": len(batches), "numpy": 0}:
        raise AssertionError(f"batches by path {paths}")
    nbytes = len(samples) * record_bytes
    return {"batches": len(batches), "records": len(samples),
            "record_bytes": record_bytes,
            "padded_records": int(sum(len(s["tokens"]) < record_bytes
                                      for s in samples)),
            "feed_s": feed_s, "batches_per_s": len(batches) / feed_s,
            "gb_per_s": nbytes / feed_s / 1e9, "paths": paths,
            "launches": launches}


def profile_feed(seed: int, vocab: int, device: torch.device,
                 batches: int = 4) -> dict:
    """A short feed window under ``torch.profiler``: the device
    operations the window queued, by name and count (each batch is one
    sink flush), and K2's kernel time by name, a cross-check of
    ``device_time`` at the feed's shape."""
    from torch.profiler import ProfilerActivity, profile

    samples, _ = token_records(seed, vocab, batches=batches, tail=0)
    feed = DeviceFeed("tokens", SEQ_TOKENS * 4, FEED_BATCH, pad=True,
                      device=device)

    async def run():
        async def stream():
            for s in samples:
                yield s
        return [b async for b in feed.batches(stream())]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        asyncio.run(run())
        torch.cuda.synchronize()
    ops: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = e.name[:60]
            ops[name] = ops.get(name, 0) + 1
    k2 = [e for e in prof.key_averages() if "land_checksum_kernel" in e.key]
    launches = sum(e.count for e in k2)
    device_us = sum(getattr(e, "device_time_total", 0) for e in k2)
    return {"batches": batches, "device_ops": ops, "k2_launches": launches,
            "k2_kernel_us": device_us / launches if launches else None}


def check_launches(paths: dict, want_k2_main: int, want_k2_feed: int) -> None:
    """Each path's launches, counted from 0 just before it: K2 once per
    flushed batch of the main path and once per feed batch, never on the
    hot swap; K1 twice in each verify gate (whole pieces, then the short
    last piece), never in the feed; neither on the mesh path, which moves
    verified bytes and folds nothing."""
    want = {"main": {"chunk_checksums": 2, "land_and_checksum": want_k2_main},
            "hot_swap": {"chunk_checksums": 2, "land_and_checksum": 0},
            "mesh": {"chunk_checksums": 0, "land_and_checksum": 0},
            "feed": {"chunk_checksums": 0, "land_and_checksum": want_k2_feed}}
    if paths != want:
        raise AssertionError(f"launches by path {paths}, want {want}")


def compare_parent(root: str, n_pieces: int, pw: int, gen, device) -> dict:
    """The kernels of another checkout (``root``, the parent commit)
    against this tree's, timed by ``device_time`` in turns (parent, this,
    this, parent): K1 over the shard's pieces, K2 at the main path's
    shape and at the feed's (16 input sets in turn). The parent's
    wrappers zeroed both outputs before each launch, so its times hold
    those two memsets, as its calls did. Each pair's results are checked
    equal first."""
    src = os.path.join(root, "dragonfly2_tpu_torch", "csrc", "checksum.cu")
    path = _build.library_path(src)
    log = _build.compile_source(path, src) if not os.path.exists(path) else ""
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.df_chunk_checksums.argtypes = [p, i64, i64, p, p, p]
    lib.df_land_and_checksum.argtypes = [p, i64, p, p, i64, i64, p, p, p]

    def zeros(k):
        return (torch.zeros(k, dtype=torch.int32, device=device),
                torch.zeros(k, dtype=torch.int32, device=device))

    def old_k1(words):
        sums, xors = zeros(n_pieces)
        code = lib.df_chunk_checksums(
            words.data_ptr(), n_pieces, pw, sums.data_ptr(), xors.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise AssertionError(f"parent chunk_checksums: CUDA error {code}")
        return sums, xors

    def old_k2(buf, pieces, slots):
        k, piece_words = pieces.shape
        sums, xors = zeros(k)
        code = lib.df_land_and_checksum(
            buf.data_ptr(), buf.numel() // piece_words, pieces.data_ptr(),
            slots.data_ptr(), k, piece_words, sums.data_ptr(), xors.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise AssertionError(
                f"parent land_and_checksum: CUDA error {code}")
        return buf, sums, xors

    def turns(old, new, n):
        a1, b1 = device_time(old, n)[0], device_time(new, n)[0]
        b2, a2 = device_time(new, n)[0], device_time(old, n)[0]
        return {"parent_ms": (a1 + a2) / 2, "this_ms": (b1 + b2) / 2,
                "turns_ms": [a1, b1, b2, a2]}

    out = {"parent": root, "built": bool(log)}
    main = land_sets(BATCH_PIECES, n_pieces, pw, 1, gen, device)
    words = main[0][0]
    check_equal("parent chunk_checksums",
                zip(old_k1(words), checksum.chunk_checksums(words, pw)))
    out["chunk_checksums"] = turns(
        lambda j: old_k1(words),
        lambda j: checksum.chunk_checksums(words, pw), 10)
    for name, data, n in (
            ("land_and_checksum", main, 40),
            ("land_and_checksum_feed",
             land_sets(FEED_BATCH, FEED_BATCH, SEQ_TOKENS, 16, gen, device),
             320)):
        a = [t.clone() for t in data[0]]
        check_equal(f"parent {name}",
                    zip(old_k2(*a), checksum.land_and_checksum(*data[0])))
        out[name] = turns(lambda j: old_k2(*data[j % len(data)]),
                          lambda j: checksum.land_and_checksum(
                              *data[j % len(data)]), n)
        del a
    return out


# K2's launch plans timed at the main path's shape: (name,
# cluster, stage words, stages, threads); stages 0 is the register path.
SWEEP_PLANS = (("ring 16 KiB x 2 (the plan)", 16, 4096, 2, 256),
               ("ring 8 KiB x 4", 16, 2048, 4, 256),
               ("ring 16 KiB x 4", 16, 4096, 4, 256),
               ("ring 32 KiB x 2", 16, 8192, 2, 256),
               ("ring 32 KiB x 4", 16, 8192, 4, 256),
               ("ring 32 KiB x 6", 16, 8192, 6, 256),
               ("ring 16 KiB x 2, clusters of 8", 8, 4096, 2, 256),
               ("registers, 1024 threads", 16, 0, 0, 1024),
               ("registers, 512 threads", 16, 0, 0, 512),
               ("registers, clusters of 8", 8, 0, 0, 1024))


def sweep_plans(n_pieces: int, pw: int, gen, device) -> dict:
    """K2 at the main path's shape under each of ``SWEEP_PLANS``, by
    ``device_time``, between two timings of a ``copy_`` of the same
    bytes, each with the number of its clusters the card holds at once;
    each plan's result is checked against the first's."""
    (buf, pieces, slots), = land_sets(BATCH_PIECES, n_pieces, pw, 1, gen,
                                      device)
    dst = torch.empty_like(pieces)
    out = {"copy_ms_before": device_time(lambda j: dst.copy_(pieces), 40)[0]}
    lib = _build.library()
    first = None
    for name, cluster, stage_words, stages, threads in SWEEP_PLANS:
        plan = checksum.LandPlan(cluster, BATCH_PIECES, stage_words, stages,
                                 threads)
        got = checksum.land_and_checksum(buf, pieces, slots, plan=plan)[1:]
        first = first or [t.clone() for t in got]
        check_equal(f"land_and_checksum plan {name}", zip(got, first))
        out[name] = {
            "ms": device_time(lambda j: checksum.land_and_checksum(
                buf, pieces, slots, plan=plan), 40)[0],
            "clusters_at_once": lib.df_land_max_active_clusters(
                cluster, threads, stages * stage_words * 4)}
    out["copy_ms_after"] = device_time(lambda j: dst.copy_(pieces), 40)[0]
    return out


def ptxas_lines(log: str) -> list[str]:
    """Each kernel's registers, shared memory and spills from nvcc's
    ``-Xptxas -v`` output."""
    out, kernel = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = next((k for k in ("chunk_checksums_kernel",
                                       "land_checksum_kernel") if k in line),
                          line.split()[-1])
        elif kernel and ("spill" in line or "Used" in line):
            out.append(f"{kernel}: {line.split(' : ')[-1].strip()}")
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", metavar="DIR",
                    help="also time this checkout's kernels against those "
                    "of the checkout in DIR (the parent commit), in turns")
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
    for line in ptxas_lines(_build.build_log):
        print("ptxas", line)

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
    # K2 at the feed's shape: one batch of FEED_BATCH token records, one
    # record (SEQ_TOKENS int32 ids) per slot, every slot landed.
    # 16 input sets of 4 MiB in turn: more than the 50 MB L2 holds.
    k2_feed = phase_land_and_checksum(FEED_BATCH, FEED_BATCH, SEQ_TOKENS, gen,
                                      device, bw, sets=16, n=320)
    print("kernel land_and_checksum at the feed's shape:",
          json.dumps(k2_feed))
    phase_odd_shapes(gen, device)
    print("odd shapes: both kernels match their plain versions")
    if args.parent:
        print("against the parent:", json.dumps(compare_parent(
            args.parent, n_pieces, pw, gen, device)))
        torch.cuda.empty_cache()
    print("land_and_checksum plans:", json.dumps(sweep_plans(
        n_pieces, pw, gen, device)))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    content, spans = make_shard(layout, gen, device)
    print(f"shard: {content.size} bytes, {len(layout)} tensors, "
          f"{n_pieces} pieces of {piece_size}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    main_path, taken = drive_main_path(content, spans, layout, piece_size,
                                       args.seed, device)
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

    swap = phase_hot_swap(content, spans, layout, taken, piece_size, gen,
                          device)
    torch.cuda.empty_cache()
    mesh = phase_mesh(content, layout, taken, device)
    del taken, content
    torch.cuda.empty_cache()
    print("mesh:", json.dumps(mesh))
    print(f"mesh: world of one over {mesh['backend']}; ici_broadcast of "
          f"{mesh['bytes']} B {mesh['ici_broadcast_ms']:.4f} ms device time "
          f"beside copy_ {mesh['copy_ms']:.4f} ms; no copy in "
          f"{sum(mesh['no_copy'].values())} of {len(mesh['no_copy'])} "
          f"placements; StripedBroadcast of {mesh['striped_feeds']} feeds "
          f"in {mesh['striped_s']:.3f} s; peak device memory "
          f"{mesh['peak_device_bytes'] / 1e9:.3f} GB; torch.distributed "
          f"calls {mesh['collective_calls']} on {smi}")
    tm = swap["timings"]
    print("hot swap:", json.dumps(swap))
    print(f"hot swap: {swap['content_bytes'] / 1e9:.3f} GB in "
          f"{swap['chunks']} chunks; reused {swap['reused_device_bytes']} B "
          f"device to device, staged {swap['staged_bytes']} B, "
          f"{swap['copies']} copies; assemble {tm['assemble_s']:.4f} s on "
          f"the host, its copies {tm['assemble_device_ms']:.4f} ms on the "
          f"card; gate cold "
          f"{tm['gate_s']:.4f} s, warm {swap['gate_warm_ms'] / 1e3:.4f} s; "
          f"flip-to-readable {tm['flip_s']:.4f} s; peak device memory "
          f"{swap['peak_device_bytes'] / 1e9:.3f} GB on {smi}")
    feed = phase_feed(args.seed, LLAMA_8B["vocab"], device)
    print("feed:", json.dumps(feed))
    print(f"feed: {feed['batches']} batches of up to {FEED_BATCH} x "
          f"{feed['record_bytes']} B in {feed['feed_s']:.4f} s: "
          f"{feed['batches_per_s']:.1f} batches/s, {feed['gb_per_s']:.3f} GB/s "
          f"on {smi}")
    print("feed window under the profiler:",
          json.dumps(profile_feed(args.seed, LLAMA_8B["vocab"], device)))

    paths = {"main": main_path["launches"], "hot_swap": swap["launches"],
             "mesh": mesh["launches"], "feed": feed["launches"]}
    check_launches(paths, -(-n_pieces // BATCH_PIECES), feed["batches"])
    kernels = []
    timed_keys = ("max_abs_err", "ms", "call_us", "plain_ms", "bound_ms",
                  "copy_ms", "register_path_ms", "plan", "l2_rotation_sets",
                  "shape")
    for kname, res, replaces, also in (
            ("chunk_checksums", k1, "dragonfly2_tpu/ops/checksum.py:67", {}),
            ("land_and_checksum", k2, "dragonfly2_tpu/ops/checksum.py:133",
             {"at_feed_shape": {key: k2_feed[key] for key in timed_keys}})):
        by_path = {p: counts[kname] for p, counts in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "dragonfly2_tpu_torch/csrc/checksum.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: res[key] for key in (
                "max_abs_err", "ms", "call_us", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "copy_ms", "register_path_ms",
                "plan", "shape") if key in res},
            **also, "match": True})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
