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

from typing import NamedTuple

import numpy as np
import torch

from dragonfly2_tpu_torch.ops import _build, gear

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

# The launch geometry of K2 is planned here, for an H100: 132 SMs, at
# most 16 blocks in a thread block cluster. One cluster lands one piece.
_SMS = 132
_MAX_CLUSTER = 16
_MAX_GRID_Y = 65535          # gridDim.y
_MIN_BLOCK_WORDS = 1024      # 4 KiB: a smaller share is all latency
# A 32 KiB ring of two 16 KiB stages a block: the fastest of the rings
# from 4 KiB x 4 to 48 KiB x 2 tried on an H100 at k=8 x 32 MiB (PERF.md).
_STAGE_WORDS = 4096
_STAGES = 2
_BULK_THREADS = 256
_REG_THREADS = 1024


class LandPlan(NamedTuple):
    """How one K2 launch cuts its work. Each of the k pieces goes to one
    cluster of ``cluster`` blocks of ``threads`` threads; ``grid_y``
    clusters run side by side and each takes every ``grid_y``-th piece.
    With ``stages`` > 0, a piece's 16-byte-aligned middle is cut into
    chunks of ``stage_words`` words, dealt round the cluster's blocks
    (chunk m to block m mod ``cluster``), and each block moves its chunks
    through a ring of ``stages`` stages by bulk copies; the rest, and
    every word when ``stages`` is 0, goes through registers, the cluster's
    threads side by side over the piece."""

    cluster: int
    grid_y: int
    stage_words: int
    stages: int
    threads: int


def _land_plan(k: int, pw: int, src_phase: int, dst_phase: int) -> LandPlan:
    """The plan for k pieces of ``pw`` words, from a piece buffer and a
    slot buffer that start ``src_phase`` and ``dst_phase`` words past a
    16-byte boundary. About one block per SM: the cluster doubles while
    k clusters still fit on the card and each block keeps at least
    ``_MIN_BLOCK_WORDS``. The bulk ring needs every piece and its slot at
    one 16-byte phase (``pw`` a multiple of 4, equal phases); otherwise
    every word goes through registers."""
    if k <= 0 or pw <= 0:
        raise ValueError(f"no plan for k={k}, pw={pw}")
    cluster = 1
    while (cluster < _MAX_CLUSTER and k * cluster * 2 <= _SMS
           and pw >= cluster * 2 * _MIN_BLOCK_WORDS):
        cluster *= 2
    grid_y = min(k, _MAX_GRID_Y)
    share = -(-pw // cluster)
    if pw % 4 or src_phase != dst_phase or share < _MIN_BLOCK_WORDS:
        # No more threads than a block's share has 16-byte words.
        threads = min(_REG_THREADS, -(-share // 128) * 32)
        return LandPlan(cluster, grid_y, 0, 0, threads)
    stage_words = min(_STAGE_WORDS, share + -share % 4)
    return LandPlan(cluster, grid_y, stage_words, _STAGES, _BULK_THREADS)


def _phase(t: torch.Tensor) -> int:
    """Words past a 16-byte boundary at which ``t`` starts."""
    return (t.data_ptr() >> 2) & 3


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


def _land_outs(buffer, pw, out_sums, out_xors):
    """The per-slot output arrays as int32 words, or None for neither."""
    if out_sums is None and out_xors is None:
        return None
    if out_sums is None or out_xors is None:
        raise ValueError("pass both out_sums and out_xors, or neither")
    n_slots = buffer.numel() // pw
    outs = (_as_words(out_sums, "out_sums"), _as_words(out_xors, "out_xors"))
    for t in outs:
        if t.shape != (n_slots,) or t.device != buffer.device:
            raise ValueError(f"out_sums and out_xors must be ({n_slots},) on "
                             f"{buffer.device}")
    return outs


def land_and_checksum_torch(buffer, pieces, slots, out_sums=None,
                            out_xors=None):
    """Plain version of K2: ``buffer[slot*pw:(slot+1)*pw] = piece`` for each
    piece, in place, and the pieces' (sums[k], xors[k]); or, given the
    per-slot ``out_sums``/``out_xors``, each piece's result stored at its
    slot there and those arrays returned."""
    buffer, pieces, k, pw = _land_args(buffer, pieces, slots)
    outs = _land_outs(buffer, pw, out_sums, out_xors)
    idx = slots.long()
    buffer.view(-1, pw).index_copy_(0, idx, pieces)
    sums, xors = chunk_checksums_torch(pieces.reshape(-1), pw)
    if outs is None:
        return buffer, sums, xors
    outs[0].index_copy_(0, idx, sums)
    outs[1].index_copy_(0, idx, xors)
    return buffer, out_sums, out_xors


def land_and_checksum(buffer, pieces, slots, out_sums=None, out_xors=None, *,
                      plan: LandPlan | None = None):
    """Store ``pieces`` (k, piece_words) into their ``slots`` (int32[k]) of
    the flat word ``buffer`` and return ``(buffer, sums[k], xors[k])``, the
    checksums folded from the same pass that stores the bytes. Given
    ``out_sums`` and ``out_xors`` (int32 or uint32, one per slot), each
    piece's checksums go to its slot there instead, and the call returns
    ``(buffer, out_sums, out_xors)``.

    ``buffer`` is updated IN PLACE, where the TPU kernel donated and aliased
    it: untouched slots keep their bytes. The slots must be distinct and in
    range; the caller checks that (the kernel never writes a slot out of
    range, and its sums and xors come back 0). On the card this is one
    launch; ``plan`` overrides ``_land_plan``'s geometry."""
    buffer, pieces, k, pw = _land_args(buffer, pieces, slots)
    outs = _land_outs(buffer, pw, out_sums, out_xors)
    if buffer.device.type == "cpu":
        return land_and_checksum_torch(buffer, pieces, slots, out_sums,
                                       out_xors)
    if buffer.device.type != "cuda":
        raise ValueError(f"no kernel for device {buffer.device}")
    if outs is None:
        outs = (torch.empty(k, dtype=torch.int32, device=buffer.device),
                torch.empty(k, dtype=torch.int32, device=buffer.device))
        result = (buffer, *outs)
    else:
        result = (buffer, out_sums, out_xors)
    if k == 0:
        return result
    if plan is None:
        plan = _land_plan(k, pw, _phase(pieces), _phase(buffer))
    lib, stream = _device_call(buffer)
    with torch.cuda.device(buffer.device):
        code = lib.df_land_and_checksum(
            buffer.data_ptr(), buffer.numel() // pw, pieces.data_ptr(),
            slots.data_ptr(), k, pw, *plan, outs[0].data_ptr(),
            outs[1].data_ptr(), int(out_sums is not None), stream)
    _build.check(lib, code, "land_and_checksum")
    land_and_checksum.launches += 1
    return result


land_and_checksum.launches = 0


def launch_counts() -> dict:
    """Each kernel's launches so far, as its wrapper counts them: K1, K2
    and K3 (``ops/gear.py``)."""
    return {"chunk_checksums": chunk_checksums.launches,
            "land_and_checksum": land_and_checksum.launches,
            "gear_candidates": gear.gear_candidates.launches}
