"""The port's top-level entry points against ``__graft_entry__``.

- ``entry(device="cpu")`` against the JAX ``entry()``: ``flat``, ``sums``
  and ``xors`` equal bit for bit (the port's int32 seen as uint32), and
  each piece's checksums equal ``checksum_numpy``'s.
- ``dryrun_multichip(n, device="cpu")``, n gloo rank processes, against
  the JAX step rebuilt here on the conftest's CPU devices from the same
  ``RandomState(1)`` words: the gathered words exact, the zeros the
  non-finite bf16 patterns leave in ``w1`` exactly as many, the updated
  ``w1``/``w2`` within ``rtol=1e-6, atol=1e-7`` (float32 sums taken in
  another order: tp partial sums all-reduced here, XLA's own order
  there), and the loss within the same tolerance of the exact (float64)
  mean of the squared errors of the JAX step's forward pass. The loss is
  held to that mean, not to XLA's float32 reduction of it: on the CPU at
  these shapes XLA's mean lies 2.3e-6 (relative) off the exact one, and
  the port's 8e-8. XLA's loss is held to the exact mean at ``rtol=1e-5``
  only to show that both are the same loss. Against the plain
  single-device step the port's loss is held at ``rtol=1e-6``.
- A failing rank and an overrun world raise ``RuntimeError`` with the
  ranks' output; without CUDA, both entry points refuse to run unasked.

Each world takes about 5 s here.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dragonfly2_tpu.ops.hbm_sink import checksum_numpy
from dragonfly2_tpu_torch import entry as pentry
from dragonfly2_tpu_torch.ops import checksum as pck

RTOL, ATOL = 1e-6, 1e-7


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------- #
# entry()
# ---------------------------------------------------------------------- #

def test_entry_equals_the_jax_entry_bit_for_bit():
    jfn, jargs = graft.entry()
    jflat, jsums, jxors = (np.asarray(a) for a in jfn(*jargs))
    fn, args = pentry.entry(device="cpu")
    assert len(args) == len(jargs) == 2
    for a, ja in zip(args, jargs):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        assert tuple(a.shape) == tuple(ja.shape) == (4, 1024)
        np.testing.assert_array_equal(_u32(a), np.asarray(ja))
    flat, sums, xors = fn(*args)
    np.testing.assert_array_equal(_u32(flat), jflat)
    np.testing.assert_array_equal(_u32(sums), jsums)
    np.testing.assert_array_equal(_u32(xors), jxors)
    host = _u32(flat).reshape(-1, 1024)
    for i, piece in enumerate(host):
        assert (int(_u32(sums)[i]), int(_u32(xors)[i])) == checksum_numpy(
            piece.tobytes())


@pytest.mark.parametrize("pw,bp,nb", [(7, 3, 3), (4096, 16, 1), (1, 1, 5)])
def test_entry_lands_every_slot_at_other_shapes(pw, bp, nb):
    fn, args = pentry.entry(device="cpu", piece_words=pw, batch_pieces=bp,
                            n_batches=nb)
    flat, sums, xors = fn(*args)
    want = torch.cat([a.reshape(-1) for a in args])
    assert torch.equal(flat, want)
    ws, wx = pck.chunk_checksums_torch(want, pw)
    assert torch.equal(sums, ws) and torch.equal(xors, wx)


def test_land_batches_calls_land_once_per_batch():
    fn, args = pentry.entry(device="cpu", n_batches=3)
    calls = []

    def land(*a):
        calls.append(a[2].tolist())
        return pck.land_and_checksum_torch(*a)

    got = pentry.land_batches(args, land=land)
    assert calls == [list(range(i * 4, (i + 1) * 4)) for i in range(3)]
    for a, b in zip(got, fn(*args)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- #
# dryrun_multichip(): the JAX step, rebuilt to return its values
# ---------------------------------------------------------------------- #

def _jax_step(n_devices: int) -> dict:
    """``__graft_entry__._dryrun_body`` on n of the conftest's CPU
    devices, returning what it computes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dragonfly2_tpu.parallel.ici import _NO_CHECK, shard_map

    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh = Mesh(np.array(devices).reshape(dp, tp), ("dp", "tp"))
    d_model, d_ff, batch = 64, 128 * tp, 8 * dp
    n_words = d_model * d_ff * 2 // 4
    padded = ((n_words + n_devices - 1) // n_devices) * n_devices
    ckpt = np.random.RandomState(1).randint(
        0, 2**31, size=(padded,)).astype(np.uint32)
    landed = jax.device_put(ckpt, NamedSharding(mesh, P(("dp", "tp"))))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P(("dp", "tp")),
                       out_specs=P(), **_NO_CHECK)
    def gather(shard):
        return jax.lax.all_gather(shard, ("dp", "tp"), axis=0, tiled=True)

    words = gather(landed)[:n_words]
    u8 = jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(-1)
    w1_full = jax.lax.bitcast_convert_type(
        u8.reshape(d_model * d_ff, 2), jnp.bfloat16).reshape(d_model, d_ff)
    w1_full = jnp.nan_to_num(w1_full.astype(jnp.float32) * 0 + 0.01)
    w1 = jax.device_put(w1_full, NamedSharding(mesh, P(None, "tp")))
    w2 = jax.device_put(jnp.full((d_ff, d_model), 0.01, jnp.float32),
                        NamedSharding(mesh, P("tp", None)))
    x = jax.device_put(jnp.ones((batch, d_model), jnp.float32),
                       NamedSharding(mesh, P("dp", None)))
    y = jax.device_put(jnp.zeros((batch, d_model), jnp.float32),
                       NamedSharding(mesh, P("dp", None)))

    def loss_fn(params, x, y):
        h = jnp.maximum(x @ params["w1"], 0.0)
        return jnp.mean((h @ params["w2"] - y) ** 2)

    @jax.jit
    def train_step(params, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        return loss, jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)

    @jax.jit
    def forward(params, x):
        return jnp.maximum(x @ params["w1"], 0.0) @ params["w2"]

    out = np.asarray(forward({"w1": w1, "w2": w2}, x), np.float64)
    loss, params = train_step({"w1": w1, "w2": w2}, x, y)
    assert params["w1"].sharding.spec == P(None, "tp")
    return {"dp": dp, "tp": tp, "d_ff": d_ff, "batch": batch,
            "loss": float(loss),
            "loss64": float(np.mean((out - np.asarray(y, np.float64)) ** 2)),
            "w1": np.asarray(params["w1"]),
            "w2": np.asarray(params["w2"]), "words": np.asarray(words),
            "zeros": int(np.sum(np.asarray(w1_full) == 0))}


@pytest.fixture(scope="module")
def worlds():
    """One gloo world each of 4 (2 x 2) and 2 (1 x 2) ranks, timed."""
    out = {}
    for n in (4, 2):
        t0 = time.perf_counter()
        out[n] = pentry.dryrun_multichip(n, device="cpu", timeout_s=60)
        out[n].wall_s = time.perf_counter() - t0
    return out


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_matches_the_jax_step(worlds, n):
    got, want = worlds[n], _jax_step(n)
    assert (got.dp, got.tp, got.d_model, got.d_ff, got.batch) == (
        want["dp"], want["tp"], 64, want["d_ff"], want["batch"])
    assert got.words.dtype == np.uint32
    np.testing.assert_array_equal(got.words, want["words"])
    # The NaN/Inf trap: w1 is 0 wherever the landed bf16 bits were not
    # finite, and there are some at this size.
    assert got.zeros == want["zeros"] > 0
    np.testing.assert_allclose(got.loss, want["loss64"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(want["loss"], want["loss64"], rtol=1e-5)
    np.testing.assert_allclose(got.w1, want["w1"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.w2, want["w2"], rtol=RTOL, atol=ATOL)
    assert got.peak_device_bytes is None
    assert got.fabric_s > 0 and got.step_s > 0
    # Summed over the ranks' own counts; the step lands through
    # collectives, and the CPU runs the plain versions, which never count.
    assert got.launches == {"chunk_checksums": 0, "land_and_checksum": 0,
                            "gear_candidates": 0}


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_matches_the_plain_single_device_step(worlds, n):
    got = worlds[n]
    loss, w1, w2 = pentry.train_step_plain(
        pentry.checkpoint_words(n, got.d_model, got.d_ff), got.d_model,
        got.d_ff, got.batch, device="cpu")
    np.testing.assert_allclose(got.loss, loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.w1, w1.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.w2, w2.numpy(), rtol=RTOL, atol=ATOL)


def test_each_world_stays_inside_its_budget(worlds):
    assert all(w.wall_s < 40 for w in worlds.values()), {
        n: w.wall_s for n, w in worlds.items()}


def test_zeros_follow_the_non_finite_patterns():
    words = pentry.checkpoint_words(1, 64, 128)
    bits = words.view(np.uint16)
    expo = (bits >> 7) & 0xFF
    want = int(np.sum(expo == 0xFF))           # bf16 NaN and +-Inf
    w1 = pentry.weights_from_words(
        torch.from_numpy(words.view(np.int32)), 64, 128)
    assert int((w1 == 0).sum()) == want > 0
    assert set(np.unique(w1.numpy()).tolist()) == {0.0, np.float32(0.01)}


def test_dryrun_shapes_follow_the_jax_dryrun():
    assert pentry.dryrun_shapes(4, 64, None, None) == (2, 2, 256, 16)
    assert pentry.dryrun_shapes(2, 64, None, None) == (1, 2, 256, 8)
    assert pentry.dryrun_shapes(3, 64, None, None) == (3, 1, 128, 24)
    assert pentry.dryrun_shapes(1, 4096, 14336, 8) == (1, 1, 14336, 8)
    for bad in ((4, 64, 255, None), (4, 64, None, 3), (1, 3, 3, 8),
                (0, 64, None, None)):
        with pytest.raises(ValueError):
            pentry.dryrun_shapes(*bad)


def test_a_failing_rank_raises_with_its_output():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as e:
        pentry.dryrun_multichip(4, device="cpu", batch=3, timeout_s=60)
    msg = str(e.value)
    assert "exited with" in msg and "--- rank 0 ---" in msg
    assert "batch over dp" in msg            # the rank's own ValueError
    assert time.perf_counter() - t0 < 60


def test_an_overrun_world_is_killed_and_raises():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"overran 0\.2 s") as e:
        pentry.dryrun_multichip(2, device="cpu", timeout_s=0.2)
    assert "--- rank 1 ---" in str(e.value)
    assert time.perf_counter() - t0 < 30


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.dryrun_multichip(1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.train_step_plain(np.zeros(2, np.uint32), 2, 2, 1)
