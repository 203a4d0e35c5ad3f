"""ctypes binding of the port's host library (``csrc/host/dfhost.cc``):
CRC-32C and the task store's fused checksum-and-I/O calls.

The library is built from the repository's source at first use
(``ops/_build.host_library``); a missing compiler or a failed build
raises ``HostBuildError``. There is no Python fallback on the store's
path: the table-driven ``digest._crc32c_py`` is the plain version the
tests hold this library against.

Every function takes any contiguous bytes-like (``bytes``, ``bytearray``,
``memoryview``, read-only or not) without copying it, and releases the
interpreter lock for the call (ctypes does). I/O failures raise
``OSError`` with the call's errno.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from dragonfly2_tpu_torch.ops import _build


def _addr(data) -> tuple[np.ndarray, int]:
    """(keep-alive array, address) of a contiguous bytes-like; the array
    must outlive the native call."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr, arr.ctypes.data


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc``."""
    arr, ptr = _addr(data)
    return _build.host_library().df_crc32c(ptr, arr.size, crc)


def crc32c_table(data, crc: int = 0) -> int:
    """The slice-by-8 table path of ``crc32c`` alone, whatever the CPU."""
    arr, ptr = _addr(data)
    return _build.host_library().df_crc32c_table(ptr, arr.size, crc)


def _check(rc: int) -> None:
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc))


def write_piece_crc(fd: int, offset: int, data) -> int:
    """pwrite ``data`` at ``offset`` with its CRC-32C taken on the way;
    returns the crc."""
    arr, ptr = _addr(data)
    out = ctypes.c_uint32(0)
    _check(_build.host_library().df_write_piece_crc(
        fd, offset, ptr, arr.size, ctypes.byref(out)))
    return out.value


def write_chunk_crc(fd: int, offset: int, data, crc: int = 0) -> int:
    """``write_piece_crc`` for one wire chunk of a piece: the crc continues
    from ``crc``."""
    arr, ptr = _addr(data)
    out = ctypes.c_uint32(0)
    _check(_build.host_library().df_write_chunk_crc(
        fd, offset, ptr, arr.size, crc, ctypes.byref(out)))
    return out.value


def read_piece_crc_into(fd: int, offset: int, buf) -> tuple[int, int]:
    """pread into the writable ``buf`` and checksum what was read:
    ``(bytes_read, crc32c)``."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.readonly:
        raise ValueError("read_piece_crc_into needs a writable buffer")
    arr, ptr = _addr(mv)
    out = ctypes.c_uint32(0)
    n = _build.host_library().df_read_piece_crc(fd, offset, ptr, arr.size,
                                                ctypes.byref(out))
    _check(n)
    return n, out.value


def hash_pieces_crc(fd: int, offsets: list[int], sizes: list[int],
                    threads: int = 0) -> list[int]:
    """The CRC-32C of each ``(offsets[i], sizes[i])`` span of an open file,
    read by ``threads`` native workers (0: one a hardware thread)."""
    n = len(offsets)
    if n != len(sizes):
        raise ValueError("offsets/sizes length mismatch")
    if n == 0:
        return []
    off = np.asarray(offsets, dtype=np.uint64)
    size = np.asarray(sizes, dtype=np.uint64)
    crcs = np.zeros(n, dtype=np.uint32)
    _check(_build.host_library().df_hash_pieces_crc(
        fd, off.ctypes.data, size.ctypes.data, crcs.ctypes.data, n, threads))
    return [int(c) for c in crcs]
