"""A MessagePack codec on the standard library: the bytes drpc frames
carry, as ``msgpack.packb(m, use_bin_type=True)`` and
``msgpack.unpackb(b, raw=False, strict_map_key=False)`` give them.

The JAX package's framing (``dragonfly2_tpu/rpc/framing.py``) uses the
``msgpack`` package, which the card machine does not have. This codec
writes the same bytes for every type the wire carries, so frames from
either package decode in the other:

- nil, false, true;
- integers in the smallest format that holds them: positive and negative
  fixint, then uint 8/16/32/64 for a non-negative value and int
  8/16/32/64 for a negative one (outside [-2**63, 2**64) raises
  ``OverflowError``, as ``packb`` does);
- float as float64 (``packb``'s default);
- str as UTF-8 in fixstr / str 8 / str 16 / str 32; bytes, bytearray and
  memoryview as bin 8 / 16 / 32;
- list and tuple as fixarray / array 16 / array 32; dict (in its order)
  as fixmap / map 16 / map 32.

Anything else raises ``TypeError``. Decoding gives ``None``, ``bool``,
``int``, ``float``, ``str``, ``bytes``, ``list`` and ``dict`` (float32
also decodes, to ``float``); an ext type or trailing bytes raise
``ValueError``.
"""

from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              op8: int | None, op16: int, op32: int) -> None:
    if n <= fix_max:
        out.append(fix_base | n)
    elif op8 is not None and n < 0x100:
        out += bytes((op8, n))
    elif n < 0x10000:
        out.append(op16)
        out += _H.pack(n)
    elif n < 0x100000000:
        out.append(op32)
        out += _I.pack(n)
    else:
        raise ValueError(f"object too large to pack: {n} entries or bytes")


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += bytes((0xCC, v))
        elif v < 0x10000:
            out.append(0xCD)
            out += _H.pack(v)
        elif v < 0x100000000:
            out.append(0xCE)
            out += _I.pack(v)
        elif v < 0x10000000000000000:
            out.append(0xCF)
            out += _Q.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out.append(0xD0)
        out += _b.pack(v)
    elif v >= -0x8000:
        out.append(0xD1)
        out += _h.pack(v)
    elif v >= -0x80000000:
        out.append(0xD2)
        out += _i.pack(v)
    elif v >= -0x8000000000000000:
        out.append(0xD3)
        out += _q.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += _d.pack(v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = v.cast("B") if isinstance(v, memoryview) else v
        n = raw.nbytes if isinstance(raw, memoryview) else len(raw)
        if n < 0x100:
            out += bytes((0xC4, n))
        elif n < 0x10000:
            out.append(0xC5)
            out += _H.pack(n)
        elif n < 0x100000000:
            out.append(0xC6)
            out += _I.pack(n)
        else:
            raise ValueError(f"bin too large to pack: {n} bytes")
        out += raw
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, None, 0xDC, 0xDD)
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, None, 0xDE, 0xDF)
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def packb(v) -> bytes:
    """``v`` in MessagePack, byte for byte ``msgpack.packb(v,
    use_bin_type=True)``."""
    out = bytearray()
    _pack(out, v)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _str(r: _Reader, n: int) -> str:
    return str(r.take(n), "utf-8")


def _array(r: _Reader, n: int) -> list:
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


# Formats with a length or value after the first byte: (reader, kind).
_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(_B))),
    0xC5: lambda r: bytes(r.take(r.unpack(_H))),
    0xC6: lambda r: bytes(r.take(r.unpack(_I))),
    0xCA: lambda r: r.unpack(_f),
    0xCB: lambda r: r.unpack(_d),
    0xCC: lambda r: r.unpack(_B),
    0xCD: lambda r: r.unpack(_H),
    0xCE: lambda r: r.unpack(_I),
    0xCF: lambda r: r.unpack(_Q),
    0xD0: lambda r: r.unpack(_b),
    0xD1: lambda r: r.unpack(_h),
    0xD2: lambda r: r.unpack(_i),
    0xD3: lambda r: r.unpack(_q),
    0xD9: lambda r: _str(r, r.unpack(_B)),
    0xDA: lambda r: _str(r, r.unpack(_H)),
    0xDB: lambda r: _str(r, r.unpack(_I)),
    0xDC: lambda r: _array(r, r.unpack(_H)),
    0xDD: lambda r: _array(r, r.unpack(_I)),
    0xDE: lambda r: _map(r, r.unpack(_H)),
    0xDF: lambda r: _map(r, r.unpack(_I)),
}


def _unpack(r: _Reader):
    op = r.take(1)[0]
    if op < 0x80:
        return op
    if op >= 0xE0:
        return op - 0x100
    if op < 0x90:
        return _map(r, op & 0x0F)
    if op < 0xA0:
        return _array(r, op & 0x0F)
    if op < 0xC0:
        return _str(r, op & 0x1F)
    fn = _FIXED.get(op)
    if fn is None:
        raise ValueError(f"unsupported MessagePack format 0x{op:02x}")
    return fn(r)


def unpackb(data):
    """The one object in ``data``, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` gives it."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("extra data after the MessagePack object")
    return out
