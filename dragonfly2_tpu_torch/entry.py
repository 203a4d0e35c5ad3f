"""Top-level entry points on the card: the port of ``__graft_entry__.py``.

- ``entry()`` is the single-card verify+land step: staged piece batches
  land in one flat device buffer through ``land_and_checksum`` (K2), each
  piece's (sum32, xor32) folded from the same pass, as ``HBMSink.flush``
  does it.
- ``dryrun_multichip(n)`` is the fabric + train step over n ranks (one
  process per rank: NCCL on n cards, or gloo with ``device="cpu"``):
  checkpoint words land sharded over every rank, are all-gathered and
  bitcast to bf16 weights, and one data-parallel, tensor-parallel SGD
  step runs on them. It is the port's only training path.

    python -m dragonfly2_tpu_torch.entry [--device cpu] [--devices N]

runs both and prints what they returned. The rank processes run this
module with ``--rank``; they import neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.tensor import Replicate, Shard

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops import checksum
from dragonfly2_tpu_torch.ops.checksum import land_and_checksum
from dragonfly2_tpu_torch.parallel import ici, multihost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.1
# Variables of a launcher that must not leak into the ranks this module
# starts: each rank is given its address, world size and rank explicitly.
_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                  "GROUP_WORLD_SIZE")


# ---------------------------------------------------------------------- #
# entry(): the single-card verify+land step
# ---------------------------------------------------------------------- #

def batch_slots(batches) -> list[torch.Tensor]:
    """The slots of each batch: batch i, of k pieces, fills slots
    i*k .. i*k+k-1 (the plan ``("b", i, 0, k)`` per batch)."""
    k = batches[0].shape[0]
    return [torch.arange(i * k, (i + 1) * k, dtype=torch.int32,
                         device=b.device) for i, b in enumerate(batches)]


def land_batches(batches, slots=None, land=land_and_checksum):
    """Batch ``i`` of ``batches`` (k, piece_words) lands in slots
    ``slots[i]`` (default ``batch_slots``) of one flat word buffer: one
    ``land`` call per batch, the checksums stored at their slots (the
    sink's per-slot outputs). Returns ``(flat, sums, xors)``, all int32,
    in the slot order of ``_assemble_checksum_jit``'s. Every slot is
    landed, so the buffer and the outputs start uninitialized. ``land``
    is K2, or its plain version ``land_and_checksum_torch`` to check it."""
    if slots is None:
        slots = batch_slots(batches)
    pw = batches[0].shape[1]
    n = sum(b.shape[0] for b in batches)
    dev = batches[0].device
    flat = torch.empty(n * pw, dtype=torch.int32, device=dev)
    sums = torch.empty(n, dtype=torch.int32, device=dev)
    xors = torch.empty(n, dtype=torch.int32, device=dev)
    for batch, these in zip(batches, slots):
        land(flat, batch, these, sums, xors)
    return flat, sums, xors


def entry(device=None, *, piece_words: int = 1024, batch_pieces: int = 4,
          n_batches: int = 2):
    """Returns ``(fn, example_args)``: ``fn(*batches)`` lands the staged
    batches through K2 (one launch per batch; the plain version on the
    CPU) and returns ``(flat, sums, xors)``. The args are ``n_batches``
    int32 tensors of shape ``[batch_pieces, piece_words]`` on the device,
    drawn from ``np.random.RandomState(0)`` as the JAX entry draws them.
    The defaults are the JAX entry's shapes (4 KiB pieces)."""
    dev = default_device(device)
    rng = np.random.RandomState(0)
    batches = tuple(
        torch.from_numpy(rng.randint(0, 2**31, size=(batch_pieces,
                                                     piece_words))
                         .astype(np.int32)).to(dev)
        for _ in range(n_batches))
    slots = batch_slots(batches)

    def verify_and_land(*staged):
        return land_batches(staged, slots)

    return verify_and_land, batches


# ---------------------------------------------------------------------- #
# dryrun_multichip(): the fabric + dp x tp train step
# ---------------------------------------------------------------------- #

@dataclass
class DryrunResult:
    """Rank 0's view of one ``dryrun_multichip`` step. ``w1``/``w2`` are
    the updated full weights, ``words`` the gathered checkpoint words
    (padding dropped); ``zeros`` counts the entries of ``w1`` that the
    landed bits made 0 (non-finite bf16 patterns). ``fabric_s`` and
    ``step_s`` are rank 0's wall times of the landing and of the train
    step; ``peak_device_bytes`` its peak device memory (None on the
    CPU). ``launches`` are the checksum kernels' launches in the step,
    counted in each rank from 0 and summed over the ranks."""

    n_devices: int
    dp: int
    tp: int
    d_model: int
    d_ff: int
    batch: int
    loss: float
    w1: np.ndarray
    w2: np.ndarray
    words: np.ndarray
    zeros: int
    fabric_s: float
    step_s: float
    peak_device_bytes: int | None
    launches: dict


def dryrun_shapes(n_devices: int, d_model: int, d_ff: int | None,
                  batch: int | None) -> tuple[int, int, int, int]:
    """``(dp, tp, d_ff, batch)`` as ``__graft_entry__`` picks them: tp 2
    on an even count, the rest dp; ``d_ff`` 128 per tp rank and ``batch``
    8 per dp rank unless given. Raises ``ValueError`` for shapes the mesh
    cannot split evenly."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    d_ff = 128 * tp if d_ff is None else d_ff
    batch = 8 * dp if batch is None else batch
    if d_model < 1 or d_ff % tp or batch % dp or (d_model * d_ff) % 2:
        raise ValueError(
            f"d_model={d_model}, d_ff={d_ff}, batch={batch} on a dp={dp} x "
            f"tp={tp} mesh: d_ff must divide over tp, batch over dp, and "
            "the bf16 weight must fill whole 32-bit words")
    return dp, tp, d_ff, batch


def checkpoint_words(n_devices: int, d_model: int, d_ff: int) -> np.ndarray:
    """The checkpoint's uint32 words (a bf16 ``[d_model, d_ff]`` weight)
    from ``RandomState(1)``, padded up to a multiple of ``n_devices``, as
    ``__graft_entry__`` draws them."""
    n_words = d_model * d_ff * 2 // 4
    padded = -(-n_words // n_devices) * n_devices
    return np.random.RandomState(1).randint(
        0, 2**31, size=(padded,)).astype(np.uint32)


def weights_from_words(words: torch.Tensor, d_model: int,
                       d_ff: int) -> torch.Tensor:
    """The float32 ``w1`` the step trains, from the landed words: bitcast
    to bf16 ``[d_model, d_ff]``, then ``nan_to_num(w * 0 + 0.01)``, the
    JAX step's expression. A finite entry becomes 0.01; a NaN or infinite
    bf16 pattern (about 1 in 256) gives NaN there and becomes 0.0, so the
    landed bits reach the loss."""
    n_words = d_model * d_ff // 2
    u8 = words[:n_words].contiguous().view(torch.uint8)
    w = ici.bitcast_landed_bytes(u8, "bfloat16", (d_model, d_ff))
    return torch.nan_to_num(w.to(torch.float32) * 0 + 0.01)


def train_step_plain(words: np.ndarray, d_model: int, d_ff: int, batch: int,
                     device=None) -> tuple[float, torch.Tensor, torch.Tensor]:
    """The step on one device with no process group: ``(loss, w1, w2)``
    after one SGD step at lr 0.1, from the same words: the loss
    ``mean((max(x @ w1, 0) @ w2 - y) ** 2)``, ``torch.maximum`` splitting
    the gradient at a tie as ``jnp.maximum`` does. The reference the
    ranks' step is held against."""
    dev = default_device(device)
    flat = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)
    w1 = weights_from_words(flat, d_model, d_ff).requires_grad_()
    w2 = torch.full((d_ff, d_model), 0.01, device=dev, requires_grad=True)
    x = torch.ones((batch, d_model), device=dev)
    y = torch.zeros((batch, d_model), device=dev)
    h = torch.maximum(x @ w1, torch.zeros((), device=dev))
    loss = ((h @ w2 - y) ** 2).mean()
    loss.backward()
    with torch.no_grad():
        return float(loss), w1 - LR * w1.grad, w2 - LR * w2.grad


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dryrun_body(n_devices: int, dev: torch.device, d_model: int,
                 d_ff: int | None, batch: int | None) -> dict:
    """One rank's step, inside an initialized process group of
    ``n_devices`` ranks. Returns rank-0 data for the parent."""
    dp, tp, d_ff, batch = dryrun_shapes(n_devices, d_model, d_ff, batch)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)

    # Fabric: the words land sharded over all n ranks, rank r holding
    # block r. JAX lands them over ("dp", "tp") jointly, whose order is
    # dp-major: device (i, j) holds block i * tp + j, which is rank
    # i * tp + j of the train mesh below. Rank 0 holds the words, as the
    # one JAX process does, and scatters them; then every rank gathers.
    words = (checkpoint_words(n_devices, d_model, d_ff).view(np.int32)
             if rank == 0 else None)
    _sync(dev)
    t0 = time.perf_counter()
    ring = ici.make_mesh(n_devices, "d", device=dev)
    landed = ici.scatter_shards(ring, words, "d", src=0)
    gathered = ici.all_gather_shards(ring, landed, "d").to_local()
    w1_full = weights_from_words(gathered, d_model, d_ff)
    _sync(dev)
    fabric_s = time.perf_counter() - t0

    # Train: w1 columns and w2 rows over tp, the batch over dp.
    mesh = multihost.global_mesh({"dp": dp, "tp": tp}, device=dev)
    w1_spec = (Replicate(), Shard(1))
    w2_spec = (Replicate(), Shard(0))
    batch_spec = (Shard(0), Replicate())
    w1 = multihost.place(w1_full, (mesh, w1_spec)).to_local()
    w2 = multihost.place(torch.full((d_ff, d_model), 0.01, device=dev),
                         (mesh, w2_spec)).to_local()
    x = multihost.place(torch.ones((batch, d_model), device=dev),
                        (mesh, batch_spec)).to_local()
    y = multihost.place(torch.zeros((batch, d_model), device=dev),
                        (mesh, batch_spec)).to_local()
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")

    _sync(dev)
    t0 = time.perf_counter()
    w1 = w1.detach().requires_grad_()
    w2 = w2.detach().requires_grad_()
    # The tp ranks' partial products are summed by an all-reduce that
    # autograd passes through (torch.distributed.nn.functional): its
    # backward all-reduces the gradient, the gradient of the SUM of the
    # ranks' losses. Each of the tp ranks holds the same dp-slice loss,
    # so each contributes 1/tp of it.
    h = torch.maximum(x @ w1, torch.zeros((), device=dev))
    out = dist_nn.all_reduce(h @ w2, group=tp_group)
    local = ((out - y) ** 2).mean()
    (local / tp).backward()
    # The loss is the global mean: the dp slices' means and gradients are
    # averaged over dp.
    loss = local.detach().clone()
    dist.all_reduce(loss, group=dp_group)
    loss /= dp
    with torch.no_grad():
        for p in (w1, w2):
            dist.all_reduce(p.grad, group=dp_group)
            p.grad /= dp
        w1_new = w1 - LR * w1.grad
        w2_new = w2 - LR * w2.grad
    _sync(dev)
    step_s = time.perf_counter() - t0

    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    # The updated w1 keeps its column sharding over tp.
    w1_d = multihost.from_local(w1_new, mesh, w1_spec, (d_model, d_ff))
    w2_d = multihost.from_local(w2_new, mesh, w2_spec, (d_ff, d_model))
    if (tuple(w1_d.placements) != w1_spec
            or tuple(w1_d.to_local().shape) != (d_model, d_ff // tp)):
        raise AssertionError(f"w1 lost its tp sharding: {w1_d.placements} "
                             f"{tuple(w1_d.to_local().shape)}")
    w1_all = w1_d.full_tensor()
    w2_all = w2_d.full_tensor()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"n_devices": n_devices, "dp": dp, "tp": tp, "d_model": d_model,
            "d_ff": d_ff, "batch": batch, "loss": loss,
            "w1": w1_all.cpu().numpy(), "w2": w2_all.cpu().numpy(),
            "words": gathered[:d_model * d_ff // 2].cpu().numpy()
            .view(np.uint32),
            "zeros": int((w1_full == 0).sum()), "fabric_s": fabric_s,
            "step_s": step_s, "peak_device_bytes": peak}


def _rank_main(args) -> None:
    """A rank process: join the group, run the step, save its kernel
    launches and (rank 0) the result where the parent reads them."""
    dev = torch.device(args.device)
    multihost.initialize_distributed(args.addr, args.world, args.rank,
                                     device=dev, timeout_s=args.timeout)
    checksum.chunk_checksums.launches = 0
    checksum.land_and_checksum.launches = 0
    try:
        result = _dryrun_body(args.world, dev, args.d_model,
                              args.d_ff or None, args.batch or None)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"launches{args.rank}.json"), "w") as f:
        json.dump(checksum.launch_counts(), f)
    if args.rank == 0:
        peak = result.pop("peak_device_bytes")
        np.savez(os.path.join(args.out, "rank0.npz"),
                 peak_device_bytes=np.array(-1 if peak is None else peak),
                 **{k: np.asarray(v) for k, v in result.items()})
    print(f"rank {args.rank} ok", flush=True)


def _rank_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_VARS}
    paths = [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and p != _REPO]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def _tails(logs: list[str]) -> str:
    out = []
    for r, path in enumerate(logs):
        try:
            with open(path, errors="replace") as f:
                text = f.read()
        except OSError as e:
            text = f"(no output: {e})"
        out.append(f"--- rank {r} ---\n{text[-3000:]}")
    return "\n".join(out)


def dryrun_multichip(n_devices: int, *, device=None, d_model: int = 64,
                     d_ff: int | None = None, batch: int | None = None,
                     timeout_s: float = 75.0) -> DryrunResult:
    """The fabric + train step on an n-rank ``("dp", "tp")`` mesh, one
    process per rank: n NCCL ranks on n cards, or n gloo ranks with
    ``device="cpu"``. The shapes default to the JAX dryrun's
    (``dryrun_shapes``). Returns rank 0's result.

    A rank that fails, a shape the mesh cannot split, or a world that
    outlives ``timeout_s`` (also the ranks' process-group timeout) raises
    ``RuntimeError`` with every rank's output tail; the ranks are killed
    first. On the card, more ranks than cards raise: NCCL refuses two
    ranks on one card, and nothing falls back to gloo or the CPU."""
    dev = default_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no dryrun for device {dev}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on the card needs {n_devices} "
            f"CUDA devices (one NCCL rank each), this host has "
            f"{torch.cuda.device_count()}")
    addr = f"tcp://127.0.0.1:{multihost.free_port()}"
    with tempfile.TemporaryDirectory(prefix="df-dryrun-") as out:
        logs = [os.path.join(out, f"rank{r}.log") for r in range(n_devices)]
        procs = []
        try:
            for r in range(n_devices):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "dragonfly2_tpu_torch.entry",
                         "--rank", str(r), "--world", str(n_devices),
                         "--addr", addr, "--device", dev.type,
                         "--d-model", str(d_model),
                         "--d-ff", str(d_ff or 0),
                         "--batch", str(batch or 0),
                         "--timeout", str(timeout_s), "--out", out],
                        cwd=_REPO, env=_rank_env(), stdout=log,
                        stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
            failure = _wait_world(procs, time.monotonic() + timeout_s,
                                  timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failure:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on "
                               f"{dev.type}: {failure}\n{_tails(logs)}")
        launches = {}
        for r in range(n_devices):
            with open(os.path.join(out, f"launches{r}.json")) as f:
                for name, count in json.load(f).items():
                    launches[name] = launches.get(name, 0) + count
        with np.load(os.path.join(out, "rank0.npz")) as z:
            peak = int(z["peak_device_bytes"])
            return DryrunResult(
                n_devices=int(z["n_devices"]), dp=int(z["dp"]),
                tp=int(z["tp"]), d_model=int(z["d_model"]),
                d_ff=int(z["d_ff"]), batch=int(z["batch"]),
                loss=float(z["loss"]), w1=z["w1"], w2=z["w2"],
                words=z["words"], zeros=int(z["zeros"]),
                fabric_s=float(z["fabric_s"]), step_s=float(z["step_s"]),
                peak_device_bytes=None if peak < 0 else peak,
                launches=launches)


def _wait_world(procs, deadline: float, timeout_s: float) -> str:
    """Wait for every rank; returns "" when all exited 0, else what went
    wrong (the first rank to fail, or the time limit)."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return f"rank {bad[0][0]} exited with {bad[0][1]}"
        if all(c == 0 for c in codes):
            return ""
        if time.monotonic() > deadline:
            return f"the world overran {timeout_s:g} s"
        time.sleep(0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the dryrun (default: every card, or 8 "
                    "gloo ranks on the CPU)")
    # One rank of a dryrun world, as dryrun_multichip starts it.
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--addr", help=argparse.SUPPRESS)
    ap.add_argument("--d-model", type=int, default=64, help=argparse.SUPPRESS)
    ap.add_argument("--d-ff", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=75.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    dev = default_device(args.device)
    n = args.devices or (torch.cuda.device_count() if dev.type == "cuda"
                         else 8)
    r = dryrun_multichip(n, device=dev)
    print(f"dryrun_multichip({n}) ok on {dev.type}: dp={r.dp} tp={r.tp} "
          f"loss={r.loss!r} zeros in w1={r.zeros} step {r.step_s:.4f} s")
    fn, args_ = entry(dev)
    out = fn(*args_)
    print("entry ok:", json.dumps([list(o.shape) for o in out]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
