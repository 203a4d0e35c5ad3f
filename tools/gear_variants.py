"""Time variants of the gear-scan kernel K3 on the card, to see what
bounds it (the attribution in PERF.md §6). Not part of the package.

    python -m tools.gear_variants [--parent DIR] [--out FILE]

run from the repository's root. Each variant is a copy of a ``gear.cu``
with some of its lines edited, written under ``build/variants/`` and
built and loaded as the port's own kernels are (``ops/_build.py``: a
library named by a hash of its source, a lock a source, nvcc's output in
``KernelBuildError`` on a failed build); the package's source is never
edited. With ``--parent DIR`` (a checkout of a commit whose kernel is the
first design's, at or before commit 5dc697c: ``git archive <commit> |
tar -x -C DIR``) the variants of that checkout's kernel are:

- ``parent``: the kernel as it is;
- ``parent, no warm-up``: without the loop that re-hashes the 31 bytes
  before each thread's run (wrong candidates: timed only);
- ``parent, kRun 64``: a quarter of the positions a thread (four times
  the blocks), with 4 words in flight instead of 8 (a run must hold a
  whole group of words).

Beside them: this tree's K3 as it is and in the variants of ``TUNE``, a
``copy_`` of the same bytes, and the read floor (``csrc/read_floor.cu``,
``bench.read_floor``: a coalesced 16-byte read of the same bytes folded
by XOR, what reading alone costs). ``TUNE`` edits exact lines of this
tree's ``gear.cu``; after an edit of those lines the script stops and
names the line it no longer finds. Every variant but those timed only is
held against ``gear_candidates_torch`` first, at each shape and at odd
starts with many candidates. Times are ``bench.device_time`` at the three
shapes ``chip_smoke.py`` times K3 at (8 MiB + 31 B, 64 MiB and 1 MiB +
31 B; ctx 31, the default mask_bits), in two passes, the second in the
reverse order. ``block times`` also prints, at each shape, the blocks
that end last (on the card's global timer, from the earliest start) with
the candidates each listed. Prints one JSON line and writes it to FILE;
exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from dragonfly2_tpu_torch.bench import (
    READ_FLOOR_BLOCKS,
    device_time,
    read_floor,
    smi_line,
)
from dragonfly2_tpu_torch.delta.chunker import CDCParams
from dragonfly2_tpu_torch.ops import _build, gear

VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")
BITS = CDCParams().mask_bits
# (name, n bytes, device_time calls)
SHAPES = (("8 MiB + 31 B", (8 << 20) + 31, 40),
          ("64 MiB", 64 << 20, 10),
          ("1 MiB + 31 B", (1 << 20) + 31, 40))

# The lines of the first design's kernel (each thread re-hashing the 31
# bytes before its run from device memory) that the parent's variants edit.
_WARM_UP = ("#pragma unroll 1\n"
            "    for (long long q = w; q < q0; ++q) h = (h << 1) + "
            "gear[__ldg(bytes + q)];\n")
PARENT = (("parent", (), True),
          ("parent, no warm-up", ((_WARM_UP, ""),), False),
          ("parent, kRun 64",
           (("kRun = 256;", "kRun = 64;"), ("kGroup = 8;", "kGroup = 4;")),
           True))

# This tree's kernel with a part changed: (name, edits, checked).
# "launch only": returns at once (what a launch of its grid costs); "ring
# only": the tiles through shared memory with no hashing (no warm-up, one
# XOR a word); "block times": each block's start and end on the global
# timer and its candidates, written past the candidates' slots; "long run
# everywhere": no short run for small regions.
_LIST_STORED = "    if (s < cap) out[s] = list[i];\n  }\n"
_STEP = "  const long long step = (long long)gridDim.x * kWarps;\n"
_NOW = ("({ unsigned long long t; "
        "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
        "(long long)t; })")
TUNE = (("launch only", ((_STEP, _STEP + "  if (limit) return;\n"),), False),
        ("ring only",
         (("if (q0 > 0) {", "if (q0 < 0) {"),
          (": hash_word<true>(run[w], h, off);",
           ": run[w].x ^ run[w].y ^ h;")),
         False),
        ("block times",
         ((_STEP, _STEP + "  if (threadIdx.x == 0) "
           "out[cap - 1024 + 2 * blockIdx.x] = " + _NOW + ";\n"),
          (_LIST_STORED, _LIST_STORED + "  if (threadIdx.x == 0) {\n"
           "    out[cap - 1024 + 2 * blockIdx.x + 1] = " + _NOW + ";\n"
           "    out[cap - 2048 + blockIdx.x] = n_list;\n  }\n")),
         False),
        ("long run everywhere",
         (("? kLongRunWords : kShortRunWords;",
           "? kLongRunWords : kLongRunWords;"),),
         True))


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"gear_variants: {old!r} is not in the source "
                             "exactly once")
        text = text.replace(old, new)
    return text


def build(name: str, source: str, edits) -> tuple[str, object]:
    """Write ``source`` with ``edits`` as the variant ``name`` and load it
    through ``_build``; the variant's source and its library."""
    with open(source) as f:
        text = edited(f.read(), edits)
    os.makedirs(VARIANT_DIR, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    src = os.path.join(VARIANT_DIR, stem + ".cu")
    with open(src, "w") as f:
        f.write(text)
    return src, _build._load(src, _bind_scan)


def _bind_scan(lib) -> None:
    """The scan's launcher alone: a parent's gear.cu has no geometry."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # data, n, ctx, gear, mask_bits, out, cap, count, stream
    lib.df_gear_candidates.argtypes = [p, i64, i64, p, i32, p, i64, p, p]
    lib.df_gear_candidates.restype = i32


def scan(lib, region, table, out, count, ctx=31, bits=BITS) -> None:
    code = lib.df_gear_candidates(
        region.data_ptr(), region.numel(), ctx, table.data_ptr(), bits,
        out.data_ptr(), out.numel(), count.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "gear variant")


def candidates(lib, region, table, ctx, bits) -> torch.Tensor:
    out = torch.empty(4 * (region.numel() >> bits) + (1 << 16),
                      dtype=torch.int64, device=region.device)
    count = torch.zeros(1, dtype=torch.int64, device=region.device)
    scan(lib, region, table, out, count, ctx, bits)
    total = int(count.item())
    if total > out.numel():
        raise AssertionError("gear variant: more candidates than room")
    return out[:total].cpu().sort().values


def latest_blocks(lib, region, table, last: int = 6) -> list:
    """The ``block times`` variant's blocks that end last over ``region``:
    (end in ns from the first block's start, candidates the block listed,
    block), after two warm-up launches."""
    out = torch.full((1 << 16,), -1, dtype=torch.int64, device=region.device)
    count = torch.zeros(1, dtype=torch.int64, device=region.device)
    for _ in range(3):
        scan(lib, region, table, out, count)
    times = out[-1024:].view(-1, 2).cpu()
    ran = times[:, 0] >= 0
    listed = out[-2048:-1536].cpu()[ran].tolist()
    times = times[ran]
    ends = (times[:, 1] - times[:, 0].min()).tolist()
    return sorted(zip(ends, listed, range(len(ends))))[-last:]


def ptxas(log: str) -> list[str]:
    return [line.split(" : ")[-1].strip() for line in log.splitlines()
            if "Used" in line or "spill" in line]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose gear.cu gives the parent variants")
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR,
                                                  "gear_variants.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gear_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = smi_line()
    print(smi)

    todo = [(name, os.path.join(args.parent, "dragonfly2_tpu_torch", "csrc",
                                "gear.cu"), edits, check)
            for name, edits, check in PARENT] if args.parent else []
    todo += [("this tree", _build.GEAR_SOURCE, (), True)]
    todo += [(name, _build.GEAR_SOURCE, edits, check)
             for name, edits, check in TUNE]
    with ThreadPoolExecutor(len(todo) + 1,
                            thread_name_prefix="df-nvcc") as ex:
        floor = ex.submit(_build.read_floor_library)
        built = [ex.submit(build, name, src, edits)
                 for name, src, edits, _ in todo]
        srcs, libs = zip(*[f.result() for f in built])
        floor.result()
    regs = {name: ptxas(_build.build_logs.get(src, ""))
            for (name, *_), src in zip(todo, srcs)}
    regs["read floor"] = ptxas(
        _build.build_logs.get(_build.READ_FLOOR_SOURCE, ""))
    for name, lines in regs.items():
        print(f"{name}: {'; '.join(lines) or 'loaded, not built'}")

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    big = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8,
                        device=device, generator=gen)
    table = gear._table(device)
    regions = {shape: big[:n] for shape, n, _ in SHAPES}
    # The timed shapes, then odd starts and lengths with many candidates.
    checks = [(shape, region, 31, BITS) for shape, region in regions.items()]
    checks += [("12,305 B at +5, mask_bits 6", big[5:12310], 0, 6),
               ("1 MiB + 3 B at +3, mask_bits 10", big[3:(1 << 20) + 6], 0,
                10)]
    for what, region, ctx, bits in checks:
        want = gear.gear_candidates_torch(region, ctx, bits)
        for (name, _, _, check), lib in zip(todo, libs):
            if check and not torch.equal(
                    candidates(lib, region, table, ctx, bits), want):
                raise AssertionError(f"{name} at {what}: differs from the "
                                     "plain version")

    def timers(region):
        out = torch.empty(4 * (region.numel() >> BITS) + (1 << 16),
                          dtype=torch.int64, device=device)
        count = torch.zeros(1, dtype=torch.int64, device=device)
        folds = torch.empty(READ_FLOOR_BLOCKS, dtype=torch.int32,
                            device=device)
        dst = torch.empty_like(region)
        fns = [(name, lambda j, lib=lib: scan(lib, region, table, out, count))
               for (name, *_), lib in zip(todo, libs)]
        fns += [("read floor", lambda j: read_floor(region, folds)),
                ("copy_", lambda j: dst.copy_(region))]
        return fns

    late = {shape: latest_blocks(lib, region, table)
            for (name, *_), lib in zip(todo, libs)
            if name == "block times"
            for shape, region in regions.items()}
    for shape, blocks in late.items():
        print(f"block times at {shape}: the last to end (ns from the first "
              f"start, candidates listed, block) {blocks}")

    results: dict = {}
    for pass_ in (0, 1):
        for shape, n, calls in SHAPES:
            fns = timers(regions[shape])
            for name, fn in (fns if pass_ == 0 else fns[::-1]):
                ms = device_time(fn, calls)[0]
                results.setdefault(shape, {}).setdefault(name, []).append(ms)
    line = {"card": smi, "shapes": {s: n for s, n, _ in SHAPES},
            "ms": results, "ptxas": regs, "latest_blocks": late}
    text = json.dumps(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    for shape, by_name in results.items():
        for name, ms in by_name.items():
            print(f"{shape:>13} {name:>24}: " +
                  " / ".join(f"{t:.5f}" for t in ms) + " ms")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
