"""Gear-hash cut candidates on the card: the scan of content-defined
chunking (``delta/chunker.py``).

For every position i of a region r of n bytes, the gear hash is

  H[i] = sum_{j=0}^{min(31, i)} gear[r[i-j]] << j   (mod 2^32),

the recurrence h = 2h + gear[b] over a 32-byte window, prefix-only at the
region's start, with the JAX package's table (``GEAR_LIST``: the first
four bytes of sha256 of each byte value, little-endian). Position i is a
cut candidate when the top ``mask_bits`` of H[i] are zero. The first
``ctx`` bytes of a region are left context: hashed, never reported.

K3, ``gear_candidates``, is hand-written in CUDA C++ (``csrc/gear.cu``;
tiles through shared memory, a run of bytes a lane whose length follows
the region's size, ``geometry``). It is the port's counterpart of the
JAX package's host scan
``df_chunk_scan`` (``dragonfly2_tpu/native/src/dfchunk.cc:46``), not of a
Pallas kernel. Its plain version ``gear_candidates_torch`` sits beside
it: the log-doubling of ``dragonfly2_tpu/delta/chunker.py``'s
``_window_hashes`` in torch ops on int64 masked to 32 bits. A wrapper takes
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches K3 or raises. Both return the candidates as an ascending int64
tensor on the host, where the chunker uses them.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np
import torch

from dragonfly2_tpu_torch.ops import _build

WINDOW = 32
GEAR_LIST = [int.from_bytes(hashlib.sha256(bytes([i])).digest()[:4], "little")
             for i in range(256)]
_GEAR64 = torch.tensor(GEAR_LIST, dtype=torch.int64)
_MASK32 = 0xFFFFFFFF
# The plain version hashes at most this many positions at a time, which
# bounds its int64 temporaries to a few times 32 MiB.
_PLAIN_BLOCK = 4 << 20
# K3's first launch has room for this many candidates beyond four times
# the expected count (n / 2^mask_bits); more takes a second launch.
_SPARE_SLOTS = 1 << 16

_tables: dict = {}
_tables_lock = threading.Lock()


def _check(region: torch.Tensor, ctx: int, mask_bits: int) -> None:
    if region.dtype != torch.uint8 or region.dim() != 1:
        raise TypeError(f"region must be 1-D uint8, got {region.dtype} "
                        f"{tuple(region.shape)}")
    if not region.is_contiguous():
        raise ValueError("region must be contiguous")
    if not 1 <= mask_bits <= 31:
        raise ValueError(f"bad mask_bits {mask_bits}")
    if not 0 <= ctx <= min(WINDOW - 1, region.numel()):
        raise ValueError(f"bad ctx {ctx} for a region of {region.numel()} "
                         "bytes")


def _window_hashes(data: torch.Tensor) -> torch.Tensor:
    """H of every position of ``data`` (uint8), int64 in [0, 2^32): one
    table gather, then H_{k+1}[i] = H_k[i] + (H_k[i - 2^k] << 2^k) five
    times (``dragonfly2_tpu/delta/chunker.py:99-122``)."""
    h = _GEAR64.to(data.device)[data.long()]
    n = h.numel()
    span = 1
    while span < min(WINDOW, n):
        nxt = h.clone()
        nxt[span:] += h[:-span] << span
        nxt[span:] &= _MASK32
        h = nxt
        span *= 2
    return h


def gear_candidates_torch(region: torch.Tensor, ctx: int,
                          mask_bits: int) -> torch.Tensor:
    """Plain version of K3: the ascending positions in [ctx, n) of
    ``region`` whose gear hash has its top ``mask_bits`` zero, as int64 on
    the host. Runs on the region's device, ``_PLAIN_BLOCK`` positions at a
    time, each block with its 31 bytes of left context."""
    _check(region, ctx, mask_bits)
    n = region.numel()
    shift = 32 - mask_bits
    found = []
    for lo in range(0, n, _PLAIN_BLOCK):
        hi = min(n, lo + _PLAIN_BLOCK)
        c = min(lo, WINDOW - 1)
        h = _window_hashes(region[lo - c:hi])[c:]
        found.append(torch.nonzero((h >> shift) == 0).flatten() + lo)
    idx = torch.cat(found) if found else torch.empty(0, dtype=torch.int64)
    return idx[idx >= ctx].cpu()


def _table(device: torch.device) -> torch.Tensor:
    """The gear table as 256 int32 words on ``device``, made once."""
    with _tables_lock:
        t = _tables.get(device)
        if t is None:
            words = np.array(GEAR_LIST, dtype=np.uint32).view(np.int32)
            t = _tables[device] = torch.from_numpy(words).to(device)
        return t


def geometry(n: int) -> tuple[int, int]:
    """K3's (tile, run) in bytes for a region of n bytes on the current
    card: the bytes a warp takes at a time and the bytes a lane hashes of
    them, where the kernel's edges lie (it takes a shorter run while a
    region is small)."""
    tile, run = ctypes.c_int64(), ctypes.c_int64()
    lib = _build.gear_library()
    _build.check(lib, lib.df_gear_geometry(n, ctypes.byref(tile),
                                           ctypes.byref(run)), "gear geometry")
    return tile.value, run.value


def gear_scan(region: torch.Tensor, ctx: int, mask_bits: int,
              out: torch.Tensor, count: torch.Tensor) -> None:
    """One K3 launch on the current stream, with no sync: appends the
    candidates of ``region`` (CUDA uint8) to ``out`` (int64) in no order
    and adds their number to ``count`` (int64[1]); slots past
    ``out.numel()`` are not written."""
    _check(region, ctx, mask_bits)
    if region.device.type != "cuda":
        raise ValueError(f"no kernel for device {region.device}")
    if (out.dtype != torch.int64 or count.dtype != torch.int64
            or count.numel() != 1 or not out.is_contiguous()
            or out.device != region.device or count.device != region.device):
        raise ValueError("out and count must be int64 on the region's device")
    lib = _build.gear_library()
    table = _table(region.device)
    with torch.cuda.device(region.device):
        stream = torch.cuda.current_stream(region.device).cuda_stream
        code = lib.df_gear_candidates(
            region.data_ptr(), region.numel(), ctx, table.data_ptr(),
            mask_bits, out.data_ptr(), out.numel(), count.data_ptr(), stream)
    _build.check(lib, code, "gear_candidates")
    gear_candidates.launches += 1


def gear_candidates(region: torch.Tensor, ctx: int,
                    mask_bits: int) -> torch.Tensor:
    """The ascending positions in [ctx, n) of ``region`` (1-D uint8) whose
    gear hash has its top ``mask_bits`` zero, as int64 on the host;
    ``ctx`` is at most 31 and at most n.

    On the card this is one K3 launch with room for four times the
    expected n / 2^mask_bits candidates plus ``_SPARE_SLOTS``, then one
    read of their count; when more turn up, a second launch with room for
    all of them. The positions come back in the order the blocks found
    them and are sorted here."""
    _check(region, ctx, mask_bits)
    if region.device.type == "cpu":
        return gear_candidates_torch(region, ctx, mask_bits)
    if region.device.type != "cuda":
        raise ValueError(f"no kernel for device {region.device}")
    n = region.numel()
    if n == 0:
        return torch.empty(0, dtype=torch.int64)
    cap = min(n, 4 * (n >> mask_bits) + _SPARE_SLOTS)
    count = torch.zeros(1, dtype=torch.int64, device=region.device)
    while True:
        out = torch.empty(cap, dtype=torch.int64, device=region.device)
        gear_scan(region, ctx, mask_bits, out, count)
        total = int(count.item())
        if total <= cap:
            break
        cap = total
        count.zero_()
    pos = out[:total].cpu().numpy()
    pos.sort()
    return torch.from_numpy(pos)


gear_candidates.launches = 0
