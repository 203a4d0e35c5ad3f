"""The port's packed report codec against the JAX package's.

``dragonfly2_tpu_torch/proto/reportcodec.py`` is a copy of
``dragonfly2_tpu/proto/reportcodec.py`` without its native decoder. With
hypothesis batches (and seeded numpy batches at the conductor's sizes):

- ``encode_reports`` gives the JAX encoder's packed dict, byte for byte
  once MessagePack-encoded (``msgpack`` for the JAX side, the port's own
  codec for the port's), and both refuse the same lossy batches;
- ``decode_packed`` of a JAX-encoded batch gives the JAX decoder's
  ``to_dicts()``, columns and aggregates, and both refuse the same broken
  envelopes with ``CodecError``; the port's numpy decoder equals its
  pure-Python reference;
- bitmaps round-trip and are the JAX bytes.

Tolerance 0: every value is an integer or a string.
"""

from __future__ import annotations

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dragonfly2_tpu.proto import reportcodec as jcodec
from dragonfly2_tpu_torch.proto import reportcodec as pcodec
from dragonfly2_tpu_torch.rpc import codec as pmsgpack

U32, U64 = 1 << 32, 1 << 64

_digests = st.one_of(
    st.just(""),
    st.integers(0, U32 - 1).map(lambda v: f"crc32c:{v:08x}"),
    st.sampled_from(["md5:abc", "sha256:" + "0" * 64, "crc32c:XYZ",
                     "crc32c:0000000", "CRC32C:00000000"]))
_timings = st.one_of(
    st.none(), st.just({}),
    st.fixed_dictionaries({}, optional={
        "dcn_ms": st.one_of(st.integers(0, U32 - 1), st.none()),
        "stall_ms": st.integers(0, U32 - 1),
        "store_ms": st.integers(0, U32 - 1)}))


@st.composite
def _report(draw, lossy: bool):
    r = {"piece_num": draw(st.integers(0, (1 << 40))),
         "range_start": draw(st.integers(0, U64 - 1)),
         "range_size": draw(st.integers(0, U32 - 1)),
         "digest": draw(_digests),
         "download_cost_ms": draw(st.integers(0, U32 - 1)),
         "dst_peer_id": draw(st.sampled_from(["", "peer-a", "peer-b",
                                              "peer-é"]))}
    t = draw(_timings)
    if t is not None:
        r["timings"] = t
    if lossy:
        key, value = draw(st.sampled_from([
            ("download_cost_ms", 1.5), ("download_cost_ms", True),
            ("range_size", -1), ("range_size", U32), ("range_start", U64),
            ("piece_num", -3), ("extra", 1), ("digest", b"raw"),
            ("timings", {"dcn_ms": 1.0}), ("timings", {"other_ms": 1}),
            ("timings", [1]), ("dst_peer_id", 7)]))
        r[key] = value
    return r


@st.composite
def _batch(draw):
    n = draw(st.integers(1, 40))
    lossy_at = draw(st.one_of(st.none(), st.integers(0, n - 1)))
    return [draw(_report(lossy=(i == lossy_at))) for i in range(n)]


def _same_batch(jb, pb) -> None:
    assert pb.to_dicts() == jb.to_dicts()
    for name in ("nums", "costs", "starts", "sizes", "peer_idx", "flags",
                 "crcs"):
        # The JAX native decoder hands some columns over as memoryviews.
        assert list(getattr(pb, name)) == list(getattr(jb, name)), name
    for name in ("n", "peers", "spill", "cost_total", "bytes_total",
                 "phase_ms", "parent_aggs", "min_cost"):
        assert getattr(pb, name) == getattr(jb, name), name
    for i in range(jb.n):
        assert pb.digest(i) == jb.digest(i)
        assert pb.timings(i) == jb.timings(i)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_batch())
def test_encode_reports_is_the_jax_encoder(batch):
    jp, pp = jcodec.encode_reports(batch), pcodec.encode_reports(batch)
    assert (pp is None) == (jp is None)
    if jp is None:
        return
    assert pp == jp
    assert pmsgpack.packb(pp) == msgpack.packb(jp, use_bin_type=True)
    jb = jcodec._decode_python(jp["nums"], jp["cols"], jp["n"],
                               list(jp["peers"]), dict(jp.get("digests") or {}))
    pb = pcodec.decode_packed(msgpack.unpackb(
        msgpack.packb(jp, use_bin_type=True), raw=False,
        strict_map_key=False))
    _same_batch(jb, pb)
    _same_batch(jb, pcodec._decode_python(
        jp["nums"], jp["cols"], jp["n"], list(jp["peers"]),
        dict(jp.get("digests") or {})))


@pytest.mark.parametrize("seed", range(8))
def test_conductor_batches_decode_as_the_jax_decoder(seed):
    """Batches as the conductor sends them: up to 32 reports of 32 MiB
    pieces, crc32c digests, one parent, timings on most."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 33))
    piece = 32 << 20
    batch = []
    for num in rng.permutation(149)[:n]:
        r = {"piece_num": int(num), "range_start": int(num) * piece,
             "range_size": piece,
             "digest": "crc32c:%08x" % int(rng.randint(0, U32, dtype=np.int64)),
             "download_cost_ms": int(rng.randint(0, 900)),
             "dst_peer_id": "parent-peer-0"}
        if rng.randint(4):
            r["timings"] = {"dcn_ms": int(rng.randint(0, 800)),
                            "stall_ms": int(rng.randint(0, 300)),
                            "store_ms": int(rng.randint(0, 60))}
        batch.append(r)
    jp, pp = jcodec.encode_reports(batch), pcodec.encode_reports(batch)
    assert pp == jp is not None
    jb = jcodec.decode_packed(jp)
    _same_batch(jb, pcodec.decode_packed(jp))
    assert pcodec.decode_packed(pp).to_dicts() == jb.to_dicts()


def _broken_envelopes():
    good = jcodec.encode_reports([
        {"piece_num": 3, "range_start": 0, "range_size": 5,
         "digest": "md5:x", "download_cost_ms": 1, "dst_peer_id": "a"},
        {"piece_num": 9, "range_start": 5, "range_size": 5, "digest": "",
         "download_cost_ms": 2, "dst_peer_id": "b"}])
    yield "not a map", [1]
    yield "version", {**good, "v": 2}
    yield "count", {**good, "n": -1}
    yield "peers", {**good, "peers": [1]}
    yield "nums type", {**good, "nums": "x"}
    yield "cols length", {**good, "cols": good["cols"][:-1]}
    yield "spill type", {**good, "digests": [1]}
    yield "spill index", {**good, "digests": {5: "x"}}
    yield "varint cut", {**good, "nums": good["nums"][:-1]}
    yield "varint trailing", {**good, "nums": good["nums"] + b"\x00"}
    yield "negative num", {**good, "nums": b"\x05\x00"}
    yield "peer index", {**good, "peers": ["a"]}


@pytest.mark.parametrize("what,packed", list(_broken_envelopes()),
                         ids=[w for w, _ in _broken_envelopes()])
def test_both_refuse_the_same_broken_batches(what, packed):
    with pytest.raises(jcodec.CodecError):
        jcodec.decode_packed(packed)
    with pytest.raises(pcodec.CodecError):
        pcodec.decode_packed(packed)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 5000), max_size=300))
def test_bitmaps_round_trip_as_the_jax_ones(nums):
    jb, pb = jcodec.nums_to_bitmap(nums), pcodec.nums_to_bitmap(nums)
    assert pb == jb
    assert pcodec.bitmap_to_nums(pb) == jcodec.bitmap_to_nums(jb) == sorted(
        set(nums))


def test_the_port_decodes_with_numpy():
    assert pcodec.report_backend() == "numpy"
    assert (pcodec.COL_SIZE, pcodec.FLAG_TIMINGS, pcodec.FLAG_CRC_DIGEST,
            pcodec.FLAG_SPILL_DIGEST) == (jcodec.COL_SIZE,
                                          jcodec.FLAG_TIMINGS,
                                          jcodec.FLAG_CRC_DIGEST,
                                          jcodec.FLAG_SPILL_DIGEST)
