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
