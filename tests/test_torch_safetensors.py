"""The port's safetensors views against the JAX package's, on the CPU.

The same generated files land in a port ``HBMSink(device="cpu")`` and a
JAX ``HBMSink``; both ``load_from_sink`` paths must give bit-equal tensors
(bf16 compared as int16). Every malformed header raises
``SafetensorsError`` in both, as ``tests/test_safetensors.py`` checks.
Tolerance 0: tensors are views of landed bytes, compared bit for bit.

One divergence is intended and named below: PyTorch has 64-bit types, so
the port loads F64/I64/U64 exactly where the JAX package (without x64
mode) refuses them or checks their high words.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import safetensors as jst
from dragonfly2_tpu.ops.hbm_sink import HBMSink as JaxSink
from dragonfly2_tpu_torch.ops import safetensors as pst
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink
from tests.test_safetensors import make_safetensors


def _sinks(content: bytes, piece: int = 256):
    port = HBMSink(len(content), piece, device="cpu", batch_pieces=4)
    jsink = JaxSink(len(content), piece, batch_pieces=4)
    for n in range(max(1, -(-len(content) // piece))):
        chunk = content[n * piece:(n + 1) * piece]
        port.land_piece(n, chunk)
        jsink.land_piece(n, chunk)
    assert port.verify() and jsink.verify()
    return port, jsink


def _raw(content: bytes, header: dict, data: bytes = b"") -> bytes:
    hj = json.dumps(header).encode()
    return struct.pack("<Q", len(hj)) + hj + data


def _bits(t) -> np.ndarray:
    """The raw bytes of a port or JAX tensor."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(-1).view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


# (safetensors dtype, numpy dtype) pairs both packages load as they are.
DTYPES = [("F32", np.float32), ("F16", np.float16), ("I32", np.int32),
          ("I16", np.int16), ("I8", np.int8), ("U8", np.uint8),
          ("U16", np.uint16), ("U32", np.uint32), ("BF16", np.uint16),
          ("BOOL", np.bool_)]


@pytest.mark.parametrize("st_dtype,np_dtype", DTYPES,
                         ids=[d for d, _ in DTYPES])
def test_tensors_bit_equal_to_jax(st_dtype, np_dtype):
    rng = np.random.default_rng(len(st_dtype))
    raw = rng.integers(0, 256, 3 * 5 * 8 * np.dtype(np_dtype).itemsize,
                       np.uint8)
    if np_dtype is np.bool_:
        raw = raw % 2
    arr = raw.view(np_dtype).reshape(3, 5, -1)
    lead = np.arange(7, dtype=np.uint8)      # pushes later spans off-word
    content = make_safetensors({"lead": lead, "t": arr},
                               {"lead": "U8", "t": st_dtype})
    port, jsink = _sinks(content)
    got = pst.load_from_sink(port)
    want = jst.load_from_sink(jsink)
    assert set(got) == set(want) == {"lead", "t"}
    for name in got:
        assert tuple(got[name].shape) == tuple(np.asarray(want[name]).shape)
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
    if st_dtype == "BF16":
        assert got["t"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["t"].view(torch.int16).numpy(),
                                      np.asarray(want["t"]).view(np.int16))


def test_names_filter_and_missing_name():
    tensors = {"a": np.arange(4, dtype=np.float32),
               "b": np.arange(6, dtype=np.float32)}
    port, jsink = _sinks(make_safetensors(tensors, {"a": "F32", "b": "F32"}))
    assert list(pst.load_from_sink(port, names=["b"])) == ["b"]
    for mod, sink in ((pst, port), (jst, jsink)):
        with pytest.raises(mod.SafetensorsError, match="not in checkpoint"):
            mod.load_from_sink(sink, names=["typo"])


MALFORMED = [
    pytest.param(b"[1, 2]", id="header-not-object"),
    pytest.param(b'{"t": "not-an-object"}', id="entry-not-object"),
    pytest.param(b'{"t": {"dtype": "F32", "data_offsets": [0, 4]}}',
                 id="no-shape"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": "x", '
                 b'"data_offsets": [0, 4]}}', id="shape-not-list"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [1], '
                 b'"data_offsets": [0.0, 4]}}', id="float-offset"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [-1], '
                 b'"data_offsets": [0, 4]}}', id="negative-dim"),
    pytest.param(b'{"t": {"dtype": "Q7", "shape": [1], '
                 b'"data_offsets": [0, 4]}}', id="unknown-dtype"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [4], '
                 b'"data_offsets": [0, 12]}}', id="span-mismatch"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [64], '
                 b'"data_offsets": [0, 256]}}', id="past-the-end"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [2], '
                 b'"data_offsets": [-8, 0]}}', id="negative-offset"),
    pytest.param(b'{"t": {"dtype": "F32", "shape": [0], '
                 b'"data_offsets": [0, 4]}}', id="zero-shape-with-span"),
    pytest.param(b'{"t": ', id="bad-json"),
]


@pytest.mark.parametrize("hj", MALFORMED)
def test_malformed_headers_raise_in_both(hj):
    content = struct.pack("<Q", len(hj)) + hj + b"\x00" * 16
    port, jsink = _sinks(content)
    with pytest.raises(pst.SafetensorsError):
        pst.load_from_sink(port)
    with pytest.raises(jst.SafetensorsError):
        jst.load_from_sink(jsink)


def test_header_length_past_content_raises_in_both():
    content = struct.pack("<Q", 1 << 40) + b"{}" + b"\x00" * 100
    port, jsink = _sinks(content)
    with pytest.raises(pst.SafetensorsError, match="header length"):
        pst.load_from_sink(port)
    with pytest.raises(jst.SafetensorsError, match="header length"):
        jst.load_from_sink(jsink)


def test_zero_length_tensors_and_metadata():
    header = {
        "__metadata__": {"format": "pt"},
        "f32": {"dtype": "F32", "shape": [0], "data_offsets": [0, 0]},
        "f64": {"dtype": "F64", "shape": [0], "data_offsets": [0, 0]},
        "i64": {"dtype": "I64", "shape": [0, 4], "data_offsets": [0, 0]},
        "bool": {"dtype": "BOOL", "shape": [0], "data_offsets": [0, 0]},
        "mid": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
        "end": {"dtype": "F16", "shape": [4, 0], "data_offsets": [8, 8]},
    }
    content = _raw(b"", header, b"\x11" * 8)
    port, jsink = _sinks(content)
    got, want = pst.load_from_sink(port), jst.load_from_sink(jsink)
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
    np.testing.assert_array_equal(_bits(got["mid"]), _bits(want["mid"]))
    assert got["bool"].dtype == torch.bool
    parsed, _ = pst.parse_header(content)
    assert pst.header_metadata(parsed) == jst.header_metadata(parsed)


@pytest.mark.parametrize("bad", [[1, 2], "x", {"k": 3}, {"k": None}])
def test_header_metadata_malformed_in_both(bad):
    for mod in (pst, jst):
        with pytest.raises(mod.SafetensorsError, match="__metadata__"):
            mod.header_metadata({"__metadata__": bad})


@pytest.mark.parametrize("st_dtype,values", [
    ("I64", np.array([(1 << 40) + 7, -5, -(1 << 50)], np.int64)),
    ("U64", np.array([(1 << 63) + 3, 9], np.uint64)),
    ("F64", np.array([1.0 / 3.0, -2.5e300, 7.0], np.float64)),
])
def test_intended_divergence_64bit_loads_exactly(st_dtype, values):
    """Intended divergence: the port loads 64-bit tensors exactly; the JAX
    package, without x64 mode, refuses these (F64 always, 64-bit integers
    whose high words are not a sign/zero extension)."""
    content = make_safetensors({"w": values}, {"w": st_dtype})
    port, jsink = _sinks(content)
    got = pst.load_from_sink(port)["w"]
    np.testing.assert_array_equal(got.numpy(), values)
    with pytest.raises(jst.SafetensorsError, match="x64|exceed 32 bits"):
        jst.load_from_sink(jsink)
