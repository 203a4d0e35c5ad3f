"""The port's checksum functions against the JAX package, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side is the reference the JAX package's own tests run off a TPU
(``_chunk_checksums_xla``, ``_land_and_checksum_xla``), since its Pallas
kernels need a TPU. Inputs are made with numpy from a seed and fed to
both. These are integer checksums and byte copies: tolerance 0, every
comparison is exact. The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import ast
import inspect
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dragonfly2_tpu.ops.checksum import _chunk_checksums_xla
from dragonfly2_tpu.ops.checksum import checksum_numpy as jax_checksum_numpy
from dragonfly2_tpu.ops.hbm_sink import _land_and_checksum_xla
from dragonfly2_tpu_torch.ops import checksum as pc
from dragonfly2_tpu_torch.ops.convert import words_to_torch


def _words(kind: str, count: int, seed: int) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(seed).integers(
            0, 1 << 32, count, dtype=np.uint32)
    if kind == "zeros":
        return np.zeros(count, np.uint32)
    return np.full(count, 0xFFFFFFFF, np.uint32)     # every sum wraps


CASES = [(kind, pw, n) for kind in ("random", "zeros", "ones")
         for pw, n in ((1, 5), (7, 13), (1000, 3), (1024, 9), (1024, 1))]


@pytest.mark.parametrize("kind,pw,n", CASES)
def test_chunk_checksums_matches_jax(kind, pw, n):
    w = _words(kind, n * pw, seed=pw * 31 + n)
    sums, xors = pc.chunk_checksums(words_to_torch(w), pw)
    js, jx = _chunk_checksums_xla(jnp.asarray(w), pw)
    np.testing.assert_array_equal(pc.to_u32(sums).numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.to_u32(xors).numpy(), np.asarray(jx))
    for i in range(n):
        want = jax_checksum_numpy(w[i * pw:(i + 1) * pw].tobytes())
        assert (int(sums[i]) & 0xFFFFFFFF, int(xors[i]) & 0xFFFFFFFF) == want


@pytest.mark.parametrize("length", [0, 1, 3, 4, 5, 4097, 65536])
def test_checksum_numpy_matches_jax(length):
    data = np.random.default_rng(length).bytes(length)
    assert pc.checksum_numpy(data) == jax_checksum_numpy(data)
    # Trailing zero bytes change nothing (tail pieces are zero padded).
    assert pc.checksum_numpy(data + b"\0" * 8) == pc.checksum_numpy(data)


def test_chunk_checksums_takes_uint32_words():
    w = _words("random", 64 * 3, seed=5)
    a = pc.chunk_checksums(words_to_torch(w), 64)
    b = pc.chunk_checksums(torch.from_numpy(w.copy()).view(torch.uint32), 64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("pw,n_slots,k", [(1024, 8, 2), (7, 13, 5),
                                          (1000, 9, 9), (1, 4, 3)])
def test_land_and_checksum_matches_jax(pw, n_slots, k):
    rng = np.random.default_rng(pw + k)
    base = rng.integers(0, 1 << 32, n_slots * pw, dtype=np.uint32)
    pieces = rng.integers(0, 1 << 32, (k, pw), dtype=np.uint32)
    slots = rng.permutation(n_slots)[:k].astype(np.int32)   # shuffled

    buf = words_to_torch(base.copy())
    out, sums, xors = pc.land_and_checksum(
        buf, words_to_torch(pieces), torch.from_numpy(slots))
    assert out is buf                                 # updated in place
    jbuf, js, jx = _land_and_checksum_xla(
        jnp.asarray(base), jnp.asarray(pieces), jnp.asarray(slots * pw), pw)

    got = buf.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jbuf))
    np.testing.assert_array_equal(pc.to_u32(sums).numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.to_u32(xors).numpy(), np.asarray(jx))
    untouched = np.setdiff1d(np.arange(n_slots), slots)
    for s in untouched:
        np.testing.assert_array_equal(got[s * pw:(s + 1) * pw],
                                      base[s * pw:(s + 1) * pw])


def test_wrappers_validate_their_inputs():
    w = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        pc.chunk_checksums(w.to(torch.int64), 5)
    with pytest.raises(ValueError):
        pc.chunk_checksums(w, 3)                      # not whole pieces
    with pytest.raises(ValueError, match="contiguous"):
        pc.chunk_checksums(torch.zeros(20, dtype=torch.int32)[::2], 5)
    with pytest.raises(TypeError):
        pc.land_and_checksum(w, w.view(2, 5), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        pc.land_and_checksum(torch.zeros(9, dtype=torch.int32), w.view(2, 5),
                             torch.zeros(2, dtype=torch.int32))


def test_no_plain_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused:
    the plain version is taken only for CPU tensors."""
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pc.chunk_checksums(meta, 4)
    with pytest.raises(ValueError, match="no kernel"):
        pc.land_and_checksum(meta, meta.view(4, 4)[:1].clone(),
                             torch.zeros(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("fn", [pc.chunk_checksums, pc.land_and_checksum])
def test_wrappers_catch_nothing(fn):
    """No ``try`` around a launch: a kernel failure surfaces as raised."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_cpu_calls_launch_nothing():
    before = (pc.chunk_checksums.launches, pc.land_and_checksum.launches)
    w = torch.zeros(8, dtype=torch.int32)
    pc.chunk_checksums(w, 4)
    pc.land_and_checksum(w, w.view(2, 4).clone(),
                         torch.tensor([1, 0], dtype=torch.int32))
    assert (pc.chunk_checksums.launches,
            pc.land_and_checksum.launches) == before


# --------------------------------------------------------------------- #
# K2's launch plan (``_land_plan``) and the cut the kernel makes from it
# --------------------------------------------------------------------- #

LAND_CASES = [(1024, 8, 2), (7, 13, 5), (1000, 9, 9), (1, 4, 3)]


def land_cut(plan, pw: int, src_phase: int, dst_phase: int):
    """The cut ``land_checksum_kernel`` (csrc/checksum.cu) makes of one
    piece, as ``(kind, start, words, owner)`` in piece words. A ``"bulk"``
    chunk goes through block ``owner``'s stage ring; a ``"reg"`` span
    goes through registers, the cluster's threads side by side over it
    (owner None). ``src_phase`` and ``dst_phase``: the piece's and its
    slot's start in words past a 16-byte boundary."""
    if not plan.stages or src_phase != dst_phase:
        return [("reg", 0, pw, None)]
    head = min(pw, (4 - src_phase) % 4)
    mid = (pw - head) // 4 * 4
    spans = [("reg", 0, head, None)] if head else []
    spans += [("bulk", head + at, min(plan.stage_words, mid - at), m % plan.cluster)
              for m, at in enumerate(range(0, mid, plan.stage_words))]
    if pw - head - mid:
        spans.append(("reg", head + mid, pw - head - mid, None))
    return spans


def reg_owners(n: int, src_phase: int, dst_phase: int, plan) -> np.ndarray:
    """The block of the cluster that moves each word of a register span
    (``fold_range`` with the cluster's thread index and stride): 16-byte
    words go round the cluster's threads where source and slot share a
    phase, single words otherwise and at the unaligned ends."""
    threads = plan.cluster * plan.threads
    j = np.arange(n)
    if src_phase != dst_phase:
        return j % threads // plan.threads
    head = min(n, (4 - src_phase) % 4)
    nv = (n - head) // 4
    thread = np.empty(n, np.int64)
    thread[:head] = j[:head] % threads
    thread[head:head + 4 * nv] = (j[head:head + 4 * nv] - head) // 4 % threads
    thread[head + 4 * nv:] = (j[head + 4 * nv:] - head - 4 * nv) % threads
    return thread // plan.threads


def plan_ok(plan, k: int) -> bool:
    """The launcher's own checks (``land_plan_ok`` in csrc/checksum.cu)
    and the card's limits."""
    return (1 <= plan.cluster <= 16 and 1 <= plan.grid_y <= 65535
            and plan.grid_y <= k
            and 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
            and (plan.stages == 0
                 or (2 <= plan.stages <= 16 and plan.stage_words > 0
                     and plan.stage_words % 4 == 0
                     and plan.stages * plan.stage_words * 4 <= 200 * 1024)))


def assert_cut_exact(plan, pw: int, src_word: int, dst_word: int):
    """Every word of a piece starting at word address ``src_word`` and
    landing at ``dst_word`` is moved exactly once; every bulk chunk is
    16-byte aligned at both ends, a multiple of 16 bytes long, at most
    one stage, and dealt to the blocks in turn."""
    at, m = 0, 0
    for kind, start, n, owner in land_cut(plan, pw, src_word % 4,
                                          dst_word % 4):
        assert start == at and n > 0
        at += n
        if kind == "bulk":
            assert (src_word + start) % 4 == 0 and (dst_word + start) % 4 == 0
            assert n % 4 == 0 and n <= plan.stage_words
            assert owner == m % plan.cluster
            m += 1
    assert at == pw


@settings(max_examples=300, deadline=None)
@given(k=st.integers(1, 200_000),
       pw=st.one_of(st.integers(1, 1 << 14), st.integers(1, 1 << 23)),
       src_phase=st.integers(0, 3), dst_phase=st.integers(0, 3),
       data=st.data())
def test_land_plan_cuts_every_word_once(k, pw, src_phase, dst_phase, data):
    plan = pc._land_plan(k, pw, src_phase, dst_phase)
    assert plan_ok(plan, k)
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster * min(k, plan.grid_y) <= 132 or plan.cluster == 1
    if plan.stages:        # the ring only where every piece shares a phase
        assert pw % 4 == 0 and src_phase == dst_phase
    i = data.draw(st.integers(0, k - 1), label="piece")
    slot = data.draw(st.integers(0, 1 << 20), label="slot")
    assert_cut_exact(plan, pw, src_phase + i * pw, dst_phase + slot * pw)


@pytest.mark.parametrize("k,pw", [(1, 8_388_608), (8, 8_388_608),
                                  (5, 8_388_608), (64, 8192), (1, 7),
                                  (13, 1001), (3, 1), (70_000, 4096)])
@pytest.mark.parametrize("src_phase,dst_phase", [(0, 0), (1, 1), (0, 3)])
def test_land_plan_at_the_paths_shapes(k, pw, src_phase, dst_phase):
    """The main path's batches (8 and a last 5 of 32 MiB pieces), one
    piece, the feed's 64 records of 32 KiB, odd sizes and more pieces than
    ``gridDim.y`` holds."""
    plan = pc._land_plan(k, pw, src_phase, dst_phase)
    assert plan_ok(plan, k)
    for i in {0, k // 2, k - 1}:
        assert_cut_exact(plan, pw, src_phase + i * pw, dst_phase + 7 * pw)
    if pw % 4 == 0 and src_phase == dst_phase and pw >= 2048:
        assert plan.stages >= 2
    if (k, pw) == (8, 8_388_608):
        assert plan.cluster == 16 and plan.cluster * k == 128


def land_split_combine(base, pieces, slots, plan, src_phase=0, dst_phase=0):
    """A plain version of K2 that works as the kernel does: each block of
    a piece's cluster folds the words it moves into a partial, and the
    cluster combines the partials. numpy uint32 in and out."""
    buf = base.copy()
    k, pw = pieces.shape
    n_slots = buf.size // pw
    sums = np.zeros(k, np.uint32)
    xors = np.zeros(k, np.uint32)
    for i, slot in enumerate(slots):
        if not 0 <= slot < n_slots:
            continue
        sp, dp = (src_phase + i * pw) % 4, (dst_phase + slot * pw) % 4
        part_s, part_x = [0] * plan.cluster, [0] * plan.cluster
        for _, start, n, owner in land_cut(plan, pw, sp, dp):
            w = pieces[i, start:start + n]
            buf[slot * pw + start:slot * pw + start + n] = w
            owners = (np.full(n, owner) if owner is not None else
                      reg_owners(n, (sp + start) % 4, (dp + start) % 4, plan))
            for r in range(plan.cluster):
                mine = w[owners == r]
                part_s[r] += int(mine.sum(dtype=np.uint64))
                part_x[r] ^= int(np.bitwise_xor.reduce(mine, initial=0))
        sums[i] = sum(part_s) & 0xFFFFFFFF
        xors[i] = np.bitwise_xor.reduce(np.array(part_x, np.uint64))
    return buf, sums, xors


@pytest.mark.parametrize("pw,n_slots,k", LAND_CASES + [(70_000, 40, 13),
                                                       (8192, 64, 64)])
@pytest.mark.parametrize("src_phase,dst_phase", [(0, 0), (2, 2), (1, 0)])
def test_split_and_combine_matches_jax(pw, n_slots, k, src_phase, dst_phase):
    rng = np.random.default_rng(pw + k)
    base = rng.integers(0, 1 << 32, n_slots * pw, dtype=np.uint32)
    pieces = rng.integers(0, 1 << 32, (k, pw), dtype=np.uint32)
    slots = rng.permutation(n_slots)[:k].astype(np.int32)
    plan = pc._land_plan(k, pw, src_phase, dst_phase)
    buf, sums, xors = land_split_combine(base, pieces, slots, plan,
                                         src_phase, dst_phase)
    jbuf, js, jx = _land_and_checksum_xla(
        jnp.asarray(base), jnp.asarray(pieces), jnp.asarray(slots * pw), pw)
    np.testing.assert_array_equal(buf, np.asarray(jbuf))
    np.testing.assert_array_equal(sums, np.asarray(js))
    np.testing.assert_array_equal(xors, np.asarray(jx))


@pytest.mark.parametrize("pw,n_slots,k", LAND_CASES)
def test_land_and_checksum_per_slot_outputs_match_jax(pw, n_slots, k):
    """With the sink's per-slot arrays, each piece's checksums land at its
    slot and every other slot keeps its value."""
    rng = np.random.default_rng(pw * 3 + k)
    base = rng.integers(0, 1 << 32, n_slots * pw, dtype=np.uint32)
    pieces = rng.integers(0, 1 << 32, (k, pw), dtype=np.uint32)
    slots = rng.permutation(n_slots)[:k].astype(np.int32)
    before_s = rng.integers(0, 1 << 32, n_slots, dtype=np.uint32)
    before_x = rng.integers(0, 1 << 32, n_slots, dtype=np.uint32)
    buf = words_to_torch(base.copy())
    out_s = words_to_torch(before_s.copy())
    out_x = torch.from_numpy(before_x.copy()).view(torch.uint32)
    got = pc.land_and_checksum(buf, words_to_torch(pieces),
                               torch.from_numpy(slots), out_s, out_x)
    assert got[0] is buf and got[1] is out_s and got[2] is out_x
    jbuf, js, jx = _land_and_checksum_xla(
        jnp.asarray(base), jnp.asarray(pieces), jnp.asarray(slots * pw), pw)
    want_s, want_x = before_s.copy(), before_x.copy()
    want_s[slots], want_x[slots] = np.asarray(js), np.asarray(jx)
    np.testing.assert_array_equal(buf.numpy().view(np.uint32), np.asarray(jbuf))
    np.testing.assert_array_equal(pc.to_u32(out_s).numpy(), want_s)
    np.testing.assert_array_equal(out_x.view(torch.int32).numpy().view(np.uint32),
                                  want_x)


def test_per_slot_outputs_are_checked():
    buf = torch.zeros(12, dtype=torch.int32)
    pieces = torch.zeros((2, 4), dtype=torch.int32)
    slots = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        pc.land_and_checksum(buf, pieces, slots,
                             torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(3,\)"):
        pc.land_and_checksum(buf, pieces, slots,
                             torch.zeros(2, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        pc.land_and_checksum(buf, pieces, slots,
                             torch.zeros(3, dtype=torch.int64),
                             torch.zeros(3, dtype=torch.int64))


_ALLOCATORS = {"zeros", "ones", "full", "empty", "tensor", "as_tensor",
               "zeros_like", "ones_like", "full_like", "empty_like",
               "arange", "rand", "randn", "randint", "cat", "stack"}


def _calls(fn) -> tuple[set, set]:
    """(torch.<name> calls, every other method name called) in ``fn``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    torch_calls, methods = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = node.func.value
            if isinstance(owner, ast.Name) and owner.id == "torch":
                torch_calls.add(node.func.attr)
            else:
                methods.add(node.func.attr)
    return torch_calls, methods


def test_land_and_checksum_is_one_launch_with_empty_outputs():
    """On the card, K2's wrapper allocates its outputs with torch.empty
    only (the kernel stores every result; nothing is zeroed first) and
    queues no device work of its own besides the launch."""
    torch_calls, methods = _calls(pc.land_and_checksum)
    assert torch_calls & _ALLOCATORS == {"empty"}
    assert not methods & {"zero_", "fill_", "index_copy_", "index_put_",
                          "scatter_", "copy_", "clone", "to", "long"}


def test_sink_flush_leaves_the_scatter_to_the_kernel():
    from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink

    _, methods = _calls(HBMSink.flush)
    assert not methods & {"index_copy_", "index_put_", "scatter_", "long"}
    src = inspect.getsource(HBMSink.flush)
    assert "self._dev_sums, self._dev_xors" in src
