"""Device bench of the port: the twin of ``bench.py``'s device section.

    python -m dragonfly2_tpu_torch.bench [--history PATH]

Measures, on one CUDA card, the device work the sink does per landed
byte and prints ONE JSON line, keeping the JAX bench's keys where they
mean the same thing:

- ``verify_and_land_throughput`` (``value``, GB/s): ``entry()``'s step,
  K2 landing 512 MiB of 4 MiB pieces in batches of 16 with per-piece
  checksums, by device time (``device_time``), beside its bound and a
  ``copy_`` of the same bytes. ``vs_baseline`` is its ratio to the CPU's
  sha256 over 64 MiB (the host-side verify of the reference design).
- ``staged_host_to_hbm_gbps``: a 64 MiB host-to-card copy from pageable
  memory, and ``staged_pinned_host_to_hbm_gbps`` from pinned memory,
  which the sink stages through; both on the host clock, as the slope of
  two runs of back-to-back copies each ending in a sync, the way the JAX
  bench times ``device_put``.
- ``swap_verify_gbps``: ``verify_u8_against_host`` over 256 MiB of 4 MiB
  pieces (K1 and the host compare), host clock; K1's device time beside
  its bound, its plain version's and a ``copy_`` of the same bytes.
- ``sink_smoke``: ``HBMSink`` lands 8 x 1 MiB + 12,345 B in shuffled
  order, then ``verify``, the swap gate and a byte round trip.

Every line carries the card's name and power limit as ``nvidia-smi``
prints them. Without CUDA it prints no metric and exits 2: there is no
CPU fallback and no "last known" figure. A run whose sink smoke passed
is appended to its own history file (``BENCH_TORCH_HISTORY.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dragonfly2_tpu_torch.entry import entry, land_batches
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.checksum import (
    checksum_numpy,
    chunk_checksums,
    chunk_checksums_torch,
    land_and_checksum_torch,
    launch_counts,
)
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink, verify_u8_against_host

HISTORY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "BENCH_TORCH_HISTORY.json")
HISTORY_KEEP = 50
MIB = 1 << 20
# The JAX bench's sizes: K2 lands 512 MiB of 4 MiB pieces in batches of 16;
# 64 MiB staged; the swap gate over 256 MiB of 4 MiB pieces; sha256 over
# 64 MiB on the CPU.
LAND_MB, PIECE_MB, LAND_BATCH = 512, 4, 16
STAGE_MB = 64
SWAP_MB = 256
CPU_MB = 64
TIMED_CALLS = 10      # calls in each ``device_time`` window
GATE_ITERS = 5        # host-clock calls of the swap gate

# Clock of the card's spin (torch.cuda._sleep counts SM cycles; an H100's
# SM clock is at most 1.98 GHz, so this overstates the spin's length).
SPIN_HZ = 2.0e9
# Blocks of the read floor's grid (it strides over the rest): 31 an SM.
READ_FLOOR_BLOCKS = 4096


def card_bandwidth(name: str) -> float:
    """Peak memory rate in bytes/s by card name (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in name else 3.35e12   # PCIe, else SXM (HBM3)


def bound_ms(nbytes: int, bandwidth: float) -> float:
    """The bytes bound. Both kernels do two 32-bit integer operations per
    4-byte word, so their operations bound (tens of TOPS) stays below a
    fortieth of this one: every kernel here is ``bound_by`` bytes."""
    return nbytes / bandwidth * 1e3


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


def read_floor(region: torch.Tensor, folds: torch.Tensor) -> None:
    """One launch of K3's yardstick ``csrc/read_floor.cu`` over ``region``
    (CUDA uint8): a coalesced read of its 16-byte words folded by XOR into
    ``folds`` (int32, one a block, ``READ_FLOOR_BLOCKS`` will do), what
    reading the bytes alone costs. On no path and counted nowhere."""
    lib = _build.read_floor_library()
    _build.check(lib, lib.df_read_floor(
        region.data_ptr(), region.numel(), folds.data_ptr(), folds.numel(),
        torch.cuda.current_stream().cuda_stream), "read floor")


def host_ms(fn, iters: int) -> float:
    """Median host-clock milliseconds of ``fn``, which must synchronise."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def host_slope_bps(fn, nbytes: int, pairs: int = 2) -> float:
    """Bytes/s of ``fn`` (which moves ``nbytes``) on the host clock, as
    the JAX bench takes a staging rate: runs of 2 and of 6 back-to-back
    calls, each run ending in a sync, and the slope between them, which
    cancels the sync's fixed cost; the upper median of ``pairs`` slopes."""
    def run(iters: int) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)
    n1, n2 = 2, 6
    slopes = []
    for _ in range(pairs):
        t1, t2 = run(n1), run(n2)
        if t2 > t1:
            slopes.append((n2 - n1) * nbytes / (t2 - t1))
    if not slopes:
        return nbytes * n2 / run(n2)
    return sorted(slopes)[len(slopes) // 2]


# ---------------------------------------------------------------------- #
# The measurements
# ---------------------------------------------------------------------- #

def bench_cpu_sha256(data: bytes, repeats: int = 3) -> float:
    """Bytes/s of the CPU's sha256 over ``data``, best of ``repeats``."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        hashlib.sha256(data).digest()
        best = min(best, time.perf_counter() - t0)
    return len(data) / best


def bench_verify_and_land(device, bandwidth: float) -> dict:
    """``entry()``'s step over ``LAND_MB`` MiB: one K2 launch per batch
    of ``LAND_BATCH`` pieces of ``PIECE_MB`` MiB (``bench.py:213-264``'s
    shape), by device time, beside its bound (each byte read once and
    written once, 4 B of slot read and 8 B of checksums written per piece),
    the plain version's time and a ``copy_`` of the same bytes."""
    piece_words = PIECE_MB * MIB // 4
    n_batches = LAND_MB // PIECE_MB // LAND_BATCH
    fn, batches = entry(device, piece_words=piece_words,
                        batch_pieces=LAND_BATCH, n_batches=n_batches)
    nbytes = n_batches * LAND_BATCH * piece_words * 4
    ms, call_us = device_time(lambda j: fn(*batches), TIMED_CALLS)
    flat = fn(*batches)[0]
    dst = torch.empty_like(flat)
    copy, _ = device_time(lambda j: dst.copy_(flat), TIMED_CALLS)
    del flat, dst
    plain, _ = device_time(lambda j: land_batches(
        batches, land=land_and_checksum_torch), 2, windows=1)
    n_pieces = n_batches * LAND_BATCH
    return {"bytes": nbytes, "batches": n_batches, "ms": ms,
            "call_us": call_us,
            "bound_ms": bound_ms(2 * nbytes + 12 * n_pieces, bandwidth),
            "plain_ms": plain, "copy_ms": copy, "gbps": nbytes / ms / 1e6}


def bench_staged_transfer(device) -> dict:
    """Host-to-card copies of ``STAGE_MB`` MiB on the host clock
    (``host_slope_bps``): from a pageable host buffer, the twin of
    ``bench.py:267-297``'s ``device_put``, and from a pinned one, the
    sink's staging."""
    words = STAGE_MB * MIB // 4
    host = torch.from_numpy(np.random.RandomState(2).randint(
        0, 2**31, size=(words,), dtype=np.int64).astype(np.int32))
    pinned = torch.empty_like(host).pin_memory()
    pinned.copy_(host)
    dst = torch.empty(words, dtype=torch.int32, device=device)
    nbytes = words * 4
    pageable = host_slope_bps(lambda: dst.copy_(host), nbytes)
    pinned_bps = host_slope_bps(
        lambda: dst.copy_(pinned, non_blocking=True), nbytes)
    if not torch.equal(dst.cpu(), host):
        raise AssertionError("staged bytes differ from the host buffer")
    return {"bytes": nbytes, "pageable_gbps": pageable / 1e9,
            "pinned_gbps": pinned_bps / 1e9}


def bench_swap_verify(device, bandwidth: float) -> dict:
    """The hot-swap gate over ``SWAP_MB`` MiB of ``PIECE_MB`` MiB pieces
    (``bench.py:300-343``): ``verify_u8_against_host`` on the host clock
    (each call reads its checksums back, so each ends synchronised), and
    K1 alone by device time beside its bound and its plain version's
    time."""
    piece = PIECE_MB * MIB
    total = SWAP_MB * MIB
    host = np.random.RandomState(3).bytes(total)
    u8 = torch.from_numpy(np.frombuffer(host, np.uint8).copy()).to(device)
    checks = {i: checksum_numpy(host[i * piece:(i + 1) * piece])
              for i in range(total // piece)}

    def gate():
        verify_u8_against_host(u8, piece, checks)

    gate()                                    # warm
    ms = host_ms(gate, GATE_ITERS)
    k1_ms, _ = device_time(lambda j: chunk_checksums(
        u8.view(torch.int32), piece // 4), TIMED_CALLS)
    k1_plain, _ = device_time(lambda j: chunk_checksums_torch(
        u8.view(torch.int32), piece // 4), 2, windows=1)
    dst = torch.empty_like(u8)
    k1_copy, _ = device_time(lambda j: dst.copy_(u8), TIMED_CALLS)
    n_pieces = total // piece
    return {"bytes": total, "ms": ms, "gbps": total / ms / 1e6,
            "k1_ms": k1_ms, "k1_bound_ms": bound_ms(total + 8 * n_pieces,
                                                    bandwidth),
            "k1_plain_ms": k1_plain, "k1_copy_ms": k1_copy}


def sink_smoke(device=None) -> str:
    """The product path on the device: ``HBMSink`` lands 8 x 1 MiB +
    12,345 B in shuffled order, verifies, passes the hot-swap gate
    (``verify_u8_against_host``) and round-trips the bytes exactly.
    Returns ``"ok"`` or what failed (``bench.py:346-372``)."""
    piece = MIB
    rng = np.random.RandomState(7)
    content = rng.bytes(8 * piece + 12345)
    sink = HBMSink(len(content), piece, batch_pieces=4, device=device)
    nums = list(range((len(content) + piece - 1) // piece))
    rng.shuffle(nums)
    for num in nums:
        sink.land_piece(num, content[num * piece:(num + 1) * piece])
    if not sink.complete():
        return "incomplete"
    try:
        sink.verify()
    except ValueError as e:
        return f"verify failed: {e}"
    u8 = sink.as_bytes_array()
    try:
        verify_u8_against_host(u8, piece, sink.host_checksums)
    except ValueError as e:
        return f"swap gate failed: {e}"
    return "ok" if u8.cpu().numpy().tobytes() == content else "bytes mismatch"


def measure(device, smi: str) -> dict:
    """Every measurement on ``device`` (a CUDA device), as the JSON line's
    fields. ``sink_smoke_launches`` are the kernel launches the sink smoke
    made, read from the wrappers' counts before and after it."""
    name = torch.cuda.get_device_name(device)
    bw = card_bandwidth(name)
    cpu_bps = bench_cpu_sha256(np.random.RandomState(1).bytes(CPU_MB * MIB))
    land = bench_verify_and_land(device, bw)
    torch.cuda.empty_cache()
    staged = bench_staged_transfer(device)
    swap = bench_swap_verify(device, bw)
    torch.cuda.empty_cache()
    before = launch_counts()
    smoke = sink_smoke(device)
    smoke_launches = {k: v - before[k] for k, v in launch_counts().items()}
    return {
        "metric": "verify_and_land_throughput",
        "value": land["gbps"], "unit": "GB/s",
        "vs_baseline": land["gbps"] / (cpu_bps / 1e9),
        "verify_and_land_ms": land["ms"],
        "verify_and_land_bound_ms": land["bound_ms"],
        "verify_and_land_plain_ms": land["plain_ms"],
        "verify_and_land_copy_ms": land["copy_ms"],
        "verify_and_land_call_us": land["call_us"],
        "verify_and_land_bytes": land["bytes"],
        "verify_and_land_batches": land["batches"],
        "staged_host_to_hbm_gbps": staged["pageable_gbps"],
        "staged_pinned_host_to_hbm_gbps": staged["pinned_gbps"],
        "staged_bytes": staged["bytes"],
        "swap_verify_gbps": swap["gbps"],
        "swap_verify_ms": swap["ms"],
        "swap_verify_k1_ms": swap["k1_ms"],
        "swap_verify_k1_bound_ms": swap["k1_bound_ms"],
        "swap_verify_k1_plain_ms": swap["k1_plain_ms"],
        "swap_verify_k1_copy_ms": swap["k1_copy_ms"],
        "swap_verify_bytes": swap["bytes"],
        "cpu_sha256_gbps": cpu_bps / 1e9,
        "sink_smoke": smoke,
        "sink_smoke_launches": smoke_launches,
        "backend": "cuda", "device": name, "card": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


# ---------------------------------------------------------------------- #
# History: verified card runs only
# ---------------------------------------------------------------------- #

def history_entry(line: dict) -> dict:
    return {"ts": time.time(),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "gbps": line["value"], "vs_cpu_sha256": line["vs_baseline"],
            "staged_host_to_hbm_gbps": line["staged_host_to_hbm_gbps"],
            "staged_pinned_host_to_hbm_gbps":
                line["staged_pinned_host_to_hbm_gbps"],
            "swap_verify_gbps": line["swap_verify_gbps"],
            "sink_smoke": line["sink_smoke"], "backend": line["backend"],
            "device": line["device"], "card": line["card"]}


def record_history(entry_: dict, path: str = HISTORY) -> None:
    """Append one verified card run to the history at ``path`` (the last
    ``HISTORY_KEEP`` kept). An entry that does not name a CUDA card (its
    ``device`` and its ``card`` line with the power limit) or whose sink
    smoke failed is refused with ``ValueError``: nothing else may stand
    as a card's measurement."""
    if (entry_.get("backend") != "cuda" or not entry_.get("device")
            or not entry_.get("card") or entry_.get("sink_smoke") != "ok"):
        raise ValueError(f"not a verified CUDA card run: {entry_!r}")
    try:
        with open(path) as f:
            history = json.load(f)
    except FileNotFoundError:
        history = []
    if not isinstance(history, list):
        raise ValueError(f"{path} does not hold a list")
    history.append(entry_)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(history[-HISTORY_KEEP:], f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--history", default=HISTORY,
                    help="history file to append a verified run to "
                    "(default: %(default)s)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = measure(device, smi_line())
    print(json.dumps(line))
    if line["sink_smoke"] != "ok":
        return 1
    record_history(history_entry(line), args.history)
    return 0


if __name__ == "__main__":
    sys.exit(main())
