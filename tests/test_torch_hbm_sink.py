"""The port's ``HBMSink`` (``device="cpu"``) against the JAX package's.

The same pieces, made with numpy from a seed, land in both sinks in the
same order; the landed bytes, the per-slot device checksums and the views
must be equal. Mirrors ``tests/test_tpu_ops.py``'s sink cases. Tolerance
0: byte copies and integer checksums are compared exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops.hbm_sink import HBMSink as JaxSink
from dragonfly2_tpu.ops.hbm_sink import (
    verify_u8_against_host as jax_verify_u8,
)
from dragonfly2_tpu_torch.ops import hbm_sink as ph
from dragonfly2_tpu_torch.ops.convert import sink_state_from_numpy


def _both(content_length, piece, batch):
    return (ph.HBMSink(content_length, piece, device="cpu",
                       batch_pieces=batch),
            JaxSink(content_length, piece, batch_pieces=batch))


def _land(sinks, content: bytes, piece: int, nums):
    for n in nums:
        for s in sinks:
            s.land_piece(n, content[n * piece:(n + 1) * piece])


def _port_bytes(sink) -> bytes:
    return sink.as_bytes_array().numpy().tobytes()


def _jax_bytes(sink) -> bytes:
    return np.asarray(sink.as_bytes_array()).tobytes()


def _assert_same_checksums(port, jax_sink):
    jax_sink._assemble()
    np.testing.assert_array_equal(port._dev_sums.numpy().view(np.uint32),
                                  np.asarray(jax_sink._dev_sums))
    np.testing.assert_array_equal(port._dev_xors.numpy().view(np.uint32),
                                  np.asarray(jax_sink._dev_xors))


# Shuffled arrival with a tail piece; many small batches (consolidation on
# the JAX side); one piece per batch scrambled (past its 128-segment cap,
# the JAX gather path); one manual flush of everything.
SHAPES = [
    pytest.param(40_000, 16_384, 2, id="shuffled-tail"),
    pytest.param(1024 * 320 - 77, 1024, 4, id="many-batches"),
    pytest.param(256 * 200 - 5, 256, 1, id="over-128-segments"),
    pytest.param(4096 * 10, 4096, 100, id="manual-flush"),
]


@pytest.mark.parametrize("length,piece,batch", SHAPES)
def test_land_verify_matches_jax(length, piece, batch):
    rng = np.random.default_rng(length)
    content = rng.bytes(length)
    port, jsink = _both(length, piece, batch)
    nums = list(range((length + piece - 1) // piece))
    rng.shuffle(nums)
    _land((port, jsink), content, piece, nums)
    assert port.complete() and jsink.complete()
    assert port.verify() and jsink.verify()
    assert _port_bytes(port) == _jax_bytes(jsink) == content
    _assert_same_checksums(port, jsink)


def test_missing_slots_zero_filled_with_zero_checksums():
    piece = 512
    content = np.random.default_rng(10).bytes(piece * 16)
    port, jsink = _both(len(content), piece, 1)
    landed = (0, 3, 5, 11, 2, 9)
    _land((port, jsink), content, piece, landed)
    got = _port_bytes(port)
    assert got == _jax_bytes(jsink)
    for n in range(16):
        want = (content[n * piece:(n + 1) * piece] if n in landed
                else b"\0" * piece)
        assert got[n * piece:(n + 1) * piece] == want, n
    _assert_same_checksums(port, jsink)
    missing = [n for n in range(16) if n not in landed]
    assert not port._dev_sums[missing].any()
    assert not port._dev_xors[missing].any()


def test_relanding_is_a_no_op_and_out_of_range_raises():
    piece = 1024
    a, b = b"\x01" * piece, b"\x02" * piece
    port, jsink = _both(4 * piece, piece, 8)
    for s in (port, jsink):
        s.land_piece(1, a)
        s.land_piece(1, b)          # ignored: piece 1 already landed
        for bad in (4, -1):
            with pytest.raises(ValueError, match="out of range"):
                s.land_piece(bad, a)
    assert _port_bytes(port) == _jax_bytes(jsink)
    assert _port_bytes(port)[piece:2 * piece] == a


def test_wrong_host_checksum_fails_verify_by_name():
    content = np.random.default_rng(2).bytes(16_384 * 3)
    port, jsink = _both(len(content), 16_384, 8)
    _land((port, jsink), content, 16_384, [0])
    for s in (port, jsink):
        s.host_checksums[0] = (123, 456)      # lie about piece 0
    _land((port, jsink), content, 16_384, [1, 2])
    for s in (port, jsink):
        with pytest.raises(ValueError, match="piece 0 corrupt"):
            s.verify()


@pytest.mark.parametrize("dtype,np_view,shape", [
    ("bfloat16", np.int16, (8, 16)),
    ("float32", np.uint32, (4, 4, 4)),
    ("int8", np.int8, (256,)),
    ("uint16", np.uint16, (2, 64)),
])
def test_as_tensor_matches_jax(dtype, np_view, shape):
    content = np.random.default_rng(4).bytes(512)
    port, jsink = _both(len(content), 128, 2)
    _land((port, jsink), content, 128, range(4))
    got = port.as_tensor(dtype, shape)
    want = np.asarray(jsink.as_tensor(dtype, shape))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.view(torch.uint8).numpy().view(np_view),
                                  want.view(np_view))


def test_as_record_batch_matches_jax():
    record, piece, count = 100, 128, 6
    rng = np.random.default_rng(6)
    recs = [rng.bytes(record) for _ in range(count)]
    port, jsink = _both(piece * count, piece, 4)
    for n, r in enumerate(recs):
        port.land_piece(n, r)
        jsink.land_piece(n, r)
    got = port.as_record_batch(count, record)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsink.as_record_batch(count,
                                                                   record)))
    for s in (port, jsink):
        with pytest.raises(ValueError):
            s.as_record_batch(count + 1, record)
        with pytest.raises(ValueError):
            s.as_record_batch(count, piece + 1)


@pytest.mark.parametrize("length,piece", [(40_000, 16_384), (8192, 1024),
                                          (0, 1024)])
def test_verify_u8_against_host_matches_jax(length, piece):
    content = np.random.default_rng(length).bytes(length)
    checks = {n: ph.checksum_numpy(content[n * piece:(n + 1) * piece])
              for n in range(max(1, -(-length // piece)))}
    u8 = np.frombuffer(content, np.uint8)
    ph.verify_u8_against_host(torch.from_numpy(u8.copy()), piece, checks)
    jax_verify_u8(jnp.asarray(u8), piece, checks)
    bad = dict(checks)
    last = max(bad)
    bad[last] = (bad[last][0] ^ 1, bad[last][1])
    with pytest.raises(ValueError, match=f"piece {last} corrupt"):
        ph.verify_u8_against_host(torch.from_numpy(u8.copy()), piece, bad)
    with pytest.raises(ValueError, match=f"piece {last} corrupt"):
        jax_verify_u8(jnp.asarray(u8), piece, bad)


def test_verify_u8_checks_an_unaligned_view():
    """A byte view that does not start on a word is copied, not refused."""
    content = np.random.default_rng(8).bytes(4097)
    checks = {0: ph.checksum_numpy(content[1:2049]),
              1: ph.checksum_numpy(content[2049:])}
    t = torch.from_numpy(np.frombuffer(content, np.uint8).copy())
    ph.verify_u8_against_host(t[1:], 2048, checks)


def test_sink_state_from_numpy_round_trip():
    length, piece = 50_000, 4096
    content = np.random.default_rng(12).bytes(length)
    jsink = JaxSink(length, piece, batch_pieces=3)
    nums = [n for n in range(-(-length // piece)) if n != 5]   # one missing
    for n in nums:
        jsink.land_piece(n, content[n * piece:(n + 1) * piece])
    assert jsink.verify()
    flat = np.asarray(jsink._assemble())
    port = sink_state_from_numpy(flat, jsink.host_checksums,
                                 content_length=length, piece_size=piece,
                                 device="cpu")
    assert port._verified and port.landed == set(nums)
    assert _port_bytes(port) == _jax_bytes(jsink)
    _assert_same_checksums(port, jsink)
    bad = dict(jsink.host_checksums)
    bad[3] = (bad[3][0], bad[3][1] ^ 1)
    with pytest.raises(ValueError, match="piece 3 corrupt"):
        sink_state_from_numpy(flat, bad, content_length=length,
                              piece_size=piece, device="cpu")
    with pytest.raises(ValueError, match="padded words"):
        sink_state_from_numpy(flat[:-1], jsink.host_checksums,
                              content_length=length, piece_size=piece,
                              device="cpu")


def test_views_share_the_buffer_and_staging_drops_after_verify():
    content = np.random.default_rng(13).bytes(4096)
    port = ph.HBMSink(len(content), 1024, device="cpu", batch_pieces=2)
    for n in range(4):
        port.land_piece(n, content[n * 1024:(n + 1) * 1024])
    assert port.verify()
    assert port._staging == []
    u8 = port.as_bytes_array()
    assert u8.data_ptr() == port._buffer.data_ptr()     # a view, no copy


def test_landing_accumulates_its_host_time_by_share():
    content = np.random.default_rng(14).bytes(8 * 1024)
    port = ph.HBMSink(len(content), 1024, device="cpu", batch_pieces=2)
    assert port.host_checksum_s == port.stage_s == port.stage_wait_s == 0.0
    for n in range(8):
        port.land_piece(n, content[n * 1024:(n + 1) * 1024])
    assert port.host_checksum_s > 0.0 and port.stage_s > 0.0
    assert port.stage_wait_s == 0.0        # no copy events on the CPU


def test_piece_size_must_be_word_aligned_and_dtype_names_map():
    with pytest.raises(ValueError, match="aligned"):
        ph.HBMSink(100, 1022, device="cpu")
    assert ph.torch_dtype("bfloat16") is torch.bfloat16
    assert ph.torch_dtype(np.float32) is torch.float32
    assert ph.torch_dtype(torch.int64) is torch.int64
    with pytest.raises(TypeError):
        ph.torch_dtype("complex64")
