"""Per-piece (sum32, xor32) checksums on the card.

The device sink's integrity check: every landed piece gets a 64-bit
(sum32, xor32) checksum computed on the device and compared against the
value the daemon computed on the host. Over a piece of little-endian
32-bit words w_i (zero padded):

  sum32 = sum(w_i) mod 2^32      xor32 = xor(w_i)

Two kernels, hand-written in CUDA C++ (``csrc/checksum.cu``), each with a
plain PyTorch version of the same function beside it:

- ``chunk_checksums`` (K1) replaces ``_chunk_checksums_pallas``
  (``dragonfly2_tpu/ops/checksum.py:67-130``);
- ``land_and_checksum`` (K2) replaces ``_land_checksum_pallas``
  (``dragonfly2_tpu/ops/checksum.py:133-218``).

Both are bound by memory: the least time is the bytes they move over the
card's memory rate. The kernel source says how its design meets that.

A wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches its kernel or raises; nothing falls back. Each wrapper
counts its launches in its ``launches`` attribute.

Words are ``torch.int32`` tensors: CUDA's uint32 coverage in PyTorch is
thin, and two's-complement add and xor give the uint32 bit patterns. The
sums come back as int32 tensors; ``to_u32`` shows them as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_tpu_torch.ops import _build

_MASK32 = 0xFFFFFFFF


def checksum_numpy(data) -> tuple[int, int]:
    """Host reference: (sum32, xor32) of ``data`` (bytes-like), zero padded
    to a whole word."""
    buf = np.frombuffer(data, dtype=np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    words = buf.view("<u4")
    s = int(np.sum(words, dtype=np.uint64) & _MASK32)
    x = int(np.bitwise_xor.reduce(words, initial=np.uint32(0)))
    return s, x


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """An int32 checksum tensor viewed as uint32 (same bits)."""
    return t.view(torch.uint32)


def _as_words(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 or uint32 words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _wrap32(t64: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32, as int32 with the same low 32 bits."""
    t64 = t64 & _MASK32
    return torch.where(t64 >= 1 << 31, t64 - (1 << 32), t64).to(torch.int32)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR over axis 1 of an int32 (n, L) tensor by halving: PyTorch has no
    xor reduction (the same fold as the Pallas kernel's, checksum.py:82-93)."""
    while x.shape[1] > 1:
        length = x.shape[1]
        half = length // 2
        folded = x[:, :half] ^ x[:, half:2 * half]
        if length % 2:
            folded[:, 0] ^= x[:, length - 1]
        x = folded
    return x[:, 0].clone()


def _device_call(t: torch.Tensor):
    """(library, stream handle) for a launch on ``t``'s card."""
    lib = _build.library()
    return lib, torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------- #
# K1: chunk_checksums
# --------------------------------------------------------------------- #

def chunk_checksums_torch(words: torch.Tensor, piece_words: int):
    """Plain version of K1: (sums[n], xors[n]) int32 for n pieces of
    ``piece_words`` words. The sum runs in int64, masked to 32 bits."""
    w = _as_words(words, "words").view(-1, piece_words)
    sums = _wrap32(w.sum(dim=1, dtype=torch.int64))
    return sums, _xor_fold(w)


def chunk_checksums(words: torch.Tensor, piece_words: int):
    """(sums[n], xors[n]) int32 per piece of ``words`` (1-D int32 or uint32,
    ``n * piece_words`` words). Any ``piece_words`` and ``n`` work; the
    TPU kernel's divisibility limits do not apply."""
    words = _as_words(words, "words")
    if words.dim() != 1 or piece_words <= 0 or words.numel() % piece_words:
        raise ValueError(
            f"words must be 1-D with a multiple of {piece_words} elements")
    n = words.numel() // piece_words
    if words.device.type == "cpu":
        return chunk_checksums_torch(words, piece_words)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    sums = torch.zeros(n, dtype=torch.int32, device=words.device)
    xors = torch.zeros(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return sums, xors
    lib, stream = _device_call(words)
    with torch.cuda.device(words.device):
        code = lib.df_chunk_checksums(words.data_ptr(), n, piece_words,
                                      sums.data_ptr(), xors.data_ptr(), stream)
    _build.check(lib, code, "chunk_checksums")
    chunk_checksums.launches += 1
    return sums, xors


chunk_checksums.launches = 0


# --------------------------------------------------------------------- #
# K2: land_and_checksum
# --------------------------------------------------------------------- #

def _land_args(buffer, pieces, slots):
    buffer = _as_words(buffer, "buffer")
    pieces = _as_words(pieces, "pieces")
    if slots.dtype != torch.int32 or not slots.is_contiguous():
        raise TypeError("slots must be contiguous int32")
    if pieces.dim() != 2 or buffer.dim() != 1:
        raise ValueError("pieces must be (k, piece_words), buffer 1-D")
    k, pw = pieces.shape
    if pw <= 0 or buffer.numel() % pw or slots.shape != (k,):
        raise ValueError(
            f"buffer of {buffer.numel()} words does not hold whole "
            f"{pw}-word slots, or slots is not ({k},)")
    if not (buffer.device == pieces.device == slots.device):
        raise ValueError("buffer, pieces and slots must share a device")
    return buffer, pieces, k, pw


def land_and_checksum_torch(buffer, pieces, slots):
    """Plain version of K2: ``buffer[slot*pw:(slot+1)*pw] = piece`` for each
    piece, in place, and the pieces' (sums[k], xors[k])."""
    buffer, pieces, k, pw = _land_args(buffer, pieces, slots)
    buffer.view(-1, pw).index_copy_(0, slots.long(), pieces)
    sums, xors = chunk_checksums_torch(pieces.reshape(-1), pw)
    return buffer, sums, xors


def land_and_checksum(buffer, pieces, slots):
    """Store ``pieces`` (k, piece_words) into their ``slots`` (int32[k]) of
    the flat word ``buffer`` and return ``(buffer, sums[k], xors[k])``, the
    checksums folded from the same pass that stores the bytes.

    ``buffer`` is updated IN PLACE, where the TPU kernel donated and aliased
    it: untouched slots keep their bytes. The slots must be distinct and in
    range; the caller checks that (the kernel skips, and never writes, a
    slot out of range)."""
    buffer, pieces, k, pw = _land_args(buffer, pieces, slots)
    if buffer.device.type == "cpu":
        return land_and_checksum_torch(buffer, pieces, slots)
    if buffer.device.type != "cuda":
        raise ValueError(f"no kernel for device {buffer.device}")
    sums = torch.zeros(k, dtype=torch.int32, device=buffer.device)
    xors = torch.zeros(k, dtype=torch.int32, device=buffer.device)
    if k == 0:
        return buffer, sums, xors
    lib, stream = _device_call(buffer)
    with torch.cuda.device(buffer.device):
        code = lib.df_land_and_checksum(
            buffer.data_ptr(), buffer.numel() // pw, pieces.data_ptr(),
            slots.data_ptr(), k, pw, sums.data_ptr(), xors.data_ptr(), stream)
    _build.check(lib, code, "land_and_checksum")
    land_and_checksum.launches += 1
    return buffer, sums, xors


land_and_checksum.launches = 0
