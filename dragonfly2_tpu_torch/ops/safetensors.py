"""Safetensors views over the device sink's landed bytes.

The port of ``dragonfly2_tpu/ops/safetensors.py``: the 8-byte header
length and the JSON header come to the host (tiny), and each tensor is a
view of the device-resident byte buffer, reinterpreted as its dtype.

Format (https://github.com/huggingface/safetensors):
  [u64 little-endian header_len][header_len bytes of JSON][tensor data]
  header: {"tensor.name": {"dtype": "BF16", "shape": [..],
                           "data_offsets": [begin, end]}, ...}
  offsets are relative to the end of the header.

Divergence from the JAX package, intended: PyTorch has 64-bit types, so
F64, I64 and U64 tensors load exactly, where the JAX package (without x64
mode) refuses F64 and checks that 64-bit integers fit in 32 bits.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "U16": torch.uint16, "U32": torch.uint32,
    "U64": torch.uint64,
}


class SafetensorsError(ValueError):
    pass


def parse_header(head: bytes) -> tuple[dict, int]:
    """(header dict, data_start_offset) from the file's first bytes."""
    if len(head) < 8:
        raise SafetensorsError("file shorter than the length prefix")
    n = int.from_bytes(head[:8], "little")
    if n > len(head) - 8:
        raise SafetensorsError(
            f"header ({n} bytes) longer than provided prefix")
    try:
        header = json.loads(head[8:8 + n])
    except json.JSONDecodeError as e:
        raise SafetensorsError(f"bad header JSON: {e}") from e
    return header, 8 + n


def header_metadata(header: dict) -> dict[str, str]:
    """The checkpoint's ``__metadata__`` entry as a plain dict ({} when
    absent); a malformed entry raises."""
    if not isinstance(header, dict):
        raise SafetensorsError(
            f"header must be a JSON object, got {type(header).__name__}")
    meta = header.get("__metadata__")
    if meta is None:
        return {}
    if (not isinstance(meta, dict)
            or not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in meta.items())):
        raise SafetensorsError(
            "__metadata__ must be a string-to-string object, got "
            f"{meta!r}")
    return dict(meta)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def tensor_views(u8: torch.Tensor, header: dict, data_start: int,
                 names: list[str] | None = None) -> dict[str, torch.Tensor]:
    """Named device tensors as views of the landed uint8 buffer. A span
    whose start is not aligned to its item size is copied first (a view
    cannot start mid-element); BOOL compares with 0, as in the JAX package."""
    out: dict[str, torch.Tensor] = {}
    total = int(u8.shape[0])
    if not isinstance(header, dict):
        raise SafetensorsError(
            f"header must be a JSON object, got {type(header).__name__}")
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if names is not None and name not in names:
            continue
        # The header is untrusted downloaded bytes: every malformation
        # raises SafetensorsError.
        if not isinstance(meta, dict):
            raise SafetensorsError(f"{name}: entry must be an object")
        dtype = _DTYPES.get(meta.get("dtype", ""))
        if dtype is None:
            raise SafetensorsError(
                f"{name}: unsupported dtype {meta.get('dtype')!r}")
        shape_raw = meta.get("shape")
        offsets = meta.get("data_offsets")
        if (not isinstance(shape_raw, list)
                or not all(_is_int(d) and d >= 0 for d in shape_raw)):
            raise SafetensorsError(f"{name}: bad shape {shape_raw!r}")
        if (not isinstance(offsets, list) or len(offsets) != 2
                or not all(_is_int(o) for o in offsets)):
            raise SafetensorsError(
                f"{name}: bad data_offsets {offsets!r}")
        shape = tuple(shape_raw)
        begin, end = offsets
        itemsize = dtype.itemsize
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * itemsize:
            raise SafetensorsError(
                f"{name}: data span {end - begin} != "
                f"{count}x{itemsize} for shape {shape}")
        if begin < 0 or data_start + end > total:
            raise SafetensorsError(
                f"{name}: data_offsets [{begin}, {end}] outside content "
                f"({total - data_start} data bytes)")
        if count == 0:
            out[name] = torch.zeros(shape, dtype=dtype, device=u8.device)
            continue
        raw = u8[data_start + begin: data_start + end]
        if dtype == torch.bool:
            t = raw != 0
        elif itemsize == 1:
            t = raw.view(dtype)
        else:
            if raw.storage_offset() % itemsize:
                raw = raw.clone()
            t = raw.view(dtype)
        out[name] = t.reshape(shape)
    if names is not None:
        missing = [n for n in names if n not in out]
        if missing:
            raise SafetensorsError(
                f"tensors not in checkpoint: {missing}")
    return out


def read_header(u8: torch.Tensor) -> tuple[dict, int]:
    """(header dict, data_start_offset) of a landed uint8 buffer: the
    length prefix, then exactly the header, as two tiny device-to-host
    copies instead of a guessed prefix size."""
    prefix = u8[:8].cpu().numpy().tobytes()
    if len(prefix) < 8:
        raise SafetensorsError("content shorter than the length prefix")
    n = int.from_bytes(prefix, "little")
    if 8 + n > u8.shape[0]:
        raise SafetensorsError("header length exceeds content")
    return parse_header(u8[: 8 + n].cpu().numpy().tobytes())


def load_from_sink(sink, *, names: list[str] | None = None
                   ) -> dict[str, torch.Tensor]:
    """Named tensors from a completed, verified sink (anything with
    ``as_bytes_array()`` returning a device uint8 tensor)."""
    u8 = sink.as_bytes_array()
    header, data_start = read_header(u8)
    return tensor_views(u8, header, data_start, names)
