"""Content-defined chunking with the gear hash: the port's copy of
``dragonfly2_tpu/delta/chunker.py``.

A cut falls after byte i when the gear hash of the 32 bytes ending at i
has its top ``mask_bits`` zero, within the [min_size, max_size] bounds of
``CDCParams``. The decision depends only on those 32 bytes, so identical
regions of two versions cut identically whatever precedes them, and
``feed()`` may split the stream anywhere: the chunks are a pure function
of (content, params), byte for byte the JAX package's.

The candidate scan is the one hot loop. It runs as K3
(``ops/gear.gear_candidates``) on the card, each scan block staged there
through a reusable pinned buffer; with ``device="cpu"`` the block goes to
K3's plain version. There is no other backend and no fallback. The
min/max/forced-cut selection (``_emit``) and the sha256 of each chunk run
on the host, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops import gear

# The hash window: the gear recurrence h = 2h + gear[b] carried mod 2^32
# sees exactly the last 32 bytes. The gear table is ``gear.GEAR_LIST``.
WINDOW = gear.WINDOW


@dataclass(frozen=True)
class CDCParams:
    """Chunking geometry: candidates every ~2^mask_bits bytes, chunks
    within [min_size, max_size]. The expected chunk is min_size +
    2^mask_bits bytes. Two manifests dedup against each other only when
    their params are equal. Defaults: ~1.25 MiB chunks within
    [256 KiB, 4 MiB]."""

    mask_bits: int = 20
    min_size: int = 256 << 10
    max_size: int = 4 << 20

    def __post_init__(self):
        if not (0 < self.min_size <= self.max_size):
            raise ValueError(
                f"bad CDC bounds [{self.min_size}, {self.max_size}]")
        if not (1 <= self.mask_bits <= 31):
            raise ValueError(f"bad mask_bits {self.mask_bits}")


@dataclass(frozen=True)
class Chunk:
    offset: int
    length: int
    sha256: str        # hex, no "sha256:" prefix

    @property
    def end(self) -> int:
        return self.offset + self.length


class GearChunker:
    """Streaming CDC chunker: ``feed()`` byte chunks (any split), collect
    the emitted ``Chunk``s from ``feed``'s return value (or ``chunks``
    afterwards), then ``finish()`` for the tail. Offsets are absolute
    stream offsets; the chunks exactly cover the stream.

    ``device``: where the scan runs (``default_device``: the current CUDA
    device unless the caller asks for the CPU). ``timings`` accumulates
    host seconds: ``stage_s`` (scan blocks into pinned staging and onto
    the card), ``scan_s`` (the scan and the read of its candidates) and
    ``hash_s`` (cut selection and sha256)."""

    # The most bytes scanned by one K3 launch (plus 31 bytes of left
    # context). Cut points do not depend on it. The staging buffers grow to
    # the largest block fed so far, never past this.
    _SCAN_BLOCK = 64 << 20

    def __init__(self, params: CDCParams | None = None, *, device=None):
        self.params = params or CDCParams()
        self.device = default_device(device)
        self.chunks: list[Chunk] = []
        self._tail = bytearray()        # bytes not yet emitted
        self._tail_start = 0            # absolute offset of _tail[0]
        self._scanned = 0               # absolute position hashed so far
        self._cands: list[int] = []     # absolute cut positions (chunk END)
        self._ci = 0                    # consumed prefix of _cands
        self._finished = False
        self._pinned: torch.Tensor | None = None
        self._staged: torch.Tensor | None = None
        self.timings = {"stage_s": 0.0, "scan_s": 0.0, "hash_s": 0.0}

    # -- feeding -----------------------------------------------------------

    def feed(self, data) -> list[Chunk]:
        """Consume ``data`` (bytes-like); returns the chunks this call
        completed."""
        if self._finished:
            raise RuntimeError("feed() after finish()")
        if not len(data):
            return []
        self._tail += data
        self._scan()
        return self._emit()

    def finish(self) -> list[Chunk]:
        """End of stream: the remaining tail becomes the final chunk
        (shorter than min_size is legal only here)."""
        self._finished = True
        out = self._emit()
        if self._tail:
            out.append(self._cut(len(self._tail)))
        return out

    @property
    def consumed(self) -> int:
        return self._tail_start + len(self._tail)

    # -- internals ---------------------------------------------------------

    def _candidates(self, lo: int, hi: int, ctx: int) -> torch.Tensor:
        """K3 (or, on the CPU, its plain version) over ``_tail[lo - ctx:hi]``:
        candidate positions relative to that region."""
        bits = self.params.mask_bits
        t0 = time.perf_counter()
        with memoryview(self._tail) as mv:
            region = mv[lo - ctx:hi]
            if self.device.type == "cpu":
                idx = gear.gear_candidates(
                    torch.frombuffer(region, dtype=torch.uint8), ctx, bits)
                self.timings["scan_s"] += time.perf_counter() - t0
                return idx
            n = hi - lo + ctx
            if self._pinned is None or self._pinned.numel() < n:
                # Room for this block with a full window of context, so
                # equal feeds after the first need no second allocation.
                size = hi - lo + WINDOW - 1
                self._pinned = torch.empty(size, dtype=torch.uint8,
                                           pin_memory=True)
                self._staged = torch.empty(size, dtype=torch.uint8,
                                           device=self.device)
            self._pinned[:n].numpy()[:] = np.frombuffer(region, np.uint8)
            del region
        staged = self._staged[:n]
        staged.copy_(self._pinned[:n])       # from pinned memory: synchronous
        t1 = time.perf_counter()
        idx = gear.gear_candidates(staged, ctx, bits)
        self.timings["stage_s"] += t1 - t0
        self.timings["scan_s"] += time.perf_counter() - t1
        return idx

    def _scan(self) -> None:
        """Scan the not-yet-scanned region (with WINDOW-1 bytes of left
        context so boundaries are split-independent) and append new cut
        candidates, at most ``_SCAN_BLOCK`` bytes a launch."""
        while True:
            lo = self._scanned - self._tail_start   # first unscanned, tail-rel
            hi = min(len(self._tail), lo + self._SCAN_BLOCK)
            if hi <= lo:
                return
            ctx = min(lo, WINDOW - 1)
            idx = self._candidates(lo, hi, ctx)
            # Cut AFTER the matching byte: chunk end = position + 1.
            self._cands.extend((idx + (self._scanned - ctx + 1)).tolist())
            self._scanned = self._tail_start + hi

    def _emit(self) -> list[Chunk]:
        t0 = time.perf_counter()
        p = self.params
        # Decide every cut first, then materialize them off one view and
        # trim the tail ONCE.
        lengths: list[int] = []
        start = self._tail_start
        while True:
            # First candidate cut that respects min_size for this chunk.
            while (self._ci < len(self._cands)
                   and self._cands[self._ci] - start < p.min_size):
                self._ci += 1
            cut = -1
            if self._ci < len(self._cands):
                c = self._cands[self._ci]
                if c - start <= p.max_size:
                    cut = c - start
            if cut < 0 and self._scanned - start >= p.max_size:
                cut = p.max_size                    # forced cut at the bound
            if cut < 0:
                break
            lengths.append(cut)
            start += cut
        if not lengths:
            self.timings["hash_s"] += time.perf_counter() - t0
            return []
        out: list[Chunk] = []
        mv = memoryview(self._tail)
        off = 0
        for length in lengths:
            ck = Chunk(self._tail_start + off, length,
                       hashlib.sha256(mv[off:off + length]).hexdigest())
            out.append(ck)
            self.chunks.append(ck)
            off += length
        del mv
        del self._tail[:off]
        self._tail_start += off
        self.timings["hash_s"] += time.perf_counter() - t0
        return out

    def _cut(self, length: int) -> Chunk:
        view = memoryview(self._tail)[:length]
        ck = Chunk(self._tail_start, length,
                   hashlib.sha256(view).hexdigest())
        del view
        del self._tail[:length]
        self._tail_start += length
        self.chunks.append(ck)
        return ck


def chunk_bytes(data, params: CDCParams | None = None, *,
                device=None) -> list[Chunk]:
    """One-shot chunking of in-memory content, scanned on ``device``."""
    ch = GearChunker(params, device=device)
    ch.feed(data)
    ch.finish()
    return ch.chunks
