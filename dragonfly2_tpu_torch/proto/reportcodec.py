"""Packed piece-report batches and the resume bitmap: the port's copy of
``dragonfly2_tpu/proto/reportcodec.py``.

The packed form is a negotiated wire alternative to a ``pieces_finished``
dict list: the scheduler advertises ``packed_reports`` on every stamped
answer, and the conductor sends packed batches only after seeing it, so
old and new peers interoperate.

Packed layout (``encode_reports`` → a MessagePack-ready dict)::

    {v: 1, n: <count>,
     peers:   [interned dst_peer_id strings, <= 65535],
     nums:    <bytes: zigzag-varint deltas of piece_num in batch order>,
     cols:    <bytes: n fixed 36-byte little-endian columns>,
     digests: {index: str}  # digests that are not crc32c:%08x}

Column struct ``<IQIHHIIII``: download_cost_ms u32, range_start u64,
range_size u32, peer_idx u16, flags u16, dcn_ms u32, stall_ms u32,
store_ms u32, digest_crc u32. Flags: bit0 the report carried a (truthy)
``timings`` dict; bit1 the digest packed as its crc32c word; bit2 the
digest spilled to ``digests``.

``encode_reports`` REFUSES (returns None, and the caller sends the dict
list) any report the packed form cannot carry exactly: unknown keys,
non-int numbers, bools, negative values, overflow, unknown timings keys.
So a packed batch decodes to what the dict list would have said.

``decode_packed`` is the scheduler's side (the daemon only encodes). Its
decoder is the JAX module's numpy one; ``_decode_python`` stays as the
reference it is held to. Intended divergence: the JAX native decoder
(``dfreport.cc`` in the JAX package's native library, which the port never
loads) and its backend ladder and ``DF_REPORT_BACKEND`` pin are not
ported, so ``report_backend()`` is always ``"numpy"``.

Also here: the landed-piece bitmap of a ``RESUME`` (``nums_to_bitmap`` /
``bitmap_to_nums``), one bit a piece instead of a list of numbers.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = [
    "CodecError", "DecodedBatch", "encode_reports", "decode_packed",
    "report_backend", "nums_to_bitmap", "bitmap_to_nums",
    "FLAG_TIMINGS", "FLAG_CRC_DIGEST", "FLAG_SPILL_DIGEST",
]


class CodecError(ValueError):
    """A packed batch failed structural validation (truncated columns,
    varint overrun, out-of-range intern index). The scheduler drops the
    batch with a warning — at-least-once re-delivery re-reports the
    pieces — rather than killing the announce stream."""


# One column per piece: cost u32, range_start u64, range_size u32,
# peer_idx u16, flags u16, dcn u32, stall u32, store u32, digest_crc u32.
COLS = struct.Struct("<IQIHHIIII")
COL_SIZE = COLS.size            # 36

FLAG_TIMINGS = 1        # report carried a truthy timings dict
FLAG_CRC_DIGEST = 2     # digest packed as crc32c word ("crc32c:%08x")
FLAG_SPILL_DIGEST = 4   # digest spilled to the digests map

_U32 = 1 << 32
_U64 = 1 << 64
_ALLOWED_KEYS = frozenset((
    "piece_num", "range_start", "range_size", "digest",
    "download_cost_ms", "dst_peer_id", "timings"))
_TIMING_KEYS = ("dcn_ms", "stall_ms", "store_ms")
_HEX = frozenset("0123456789abcdef")

# --------------------------------------------------------------------- #
# varint / zigzag (piece-num delta stream)
# --------------------------------------------------------------------- #

def _zigzag(v: int) -> int:
    # v is a signed 64-bit delta; arithmetic shift makes this the classic
    # protobuf zigzag: 0,-1,1,-2,... -> 0,1,2,3,...
    return (v << 1) ^ (v >> 63)


def _encode_nums(nums: list) -> bytes:
    out = bytearray()
    prev = 0
    for num in nums:
        zz = _zigzag(num - prev)
        prev = num
        while zz >= 0x80:
            out.append((zz & 0x7F) | 0x80)
            zz >>= 7
        out.append(zz)
    return bytes(out)


def _decode_nums(buf: bytes, n: int) -> list:
    """Decode exactly ``n`` zigzag-varint deltas consuming all of ``buf``;
    the pure-python reference every other backend must match."""
    nums = []
    pos = 0
    end = len(buf)
    prev = 0
    for _ in range(n):
        zz = 0
        shift = 0
        while True:
            if pos >= end or shift > 63:
                raise CodecError("piece-num varint stream truncated")
            b = buf[pos]
            pos += 1
            zz |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        prev += (zz >> 1) ^ -(zz & 1)
        if prev < 0:
            raise CodecError("negative piece number")
        nums.append(prev)
    if pos != end:
        raise CodecError("trailing bytes after piece-num stream")
    return nums


# --------------------------------------------------------------------- #
# encode (conductor side)
# --------------------------------------------------------------------- #

def _int_field(v, bound: int):
    """Value as a non-negative int below ``bound``, or None to refuse.
    bool is an int in Python but means something else on the wire."""
    if type(v) is not int or not 0 <= v < bound:
        return None
    return v


def encode_reports(reports: list) -> "dict | None":
    """The packed wire form of a report batch, or None when any report
    is not exactly representable (caller sends the dict list instead).
    Refusal is the compatibility valve: new report fields, float costs,
    or exotic digests simply keep riding the legacy encoding."""
    n = len(reports)
    if n == 0 or n > _U32 - 1:
        return None
    peers: list = []
    peer_idx: dict = {}
    nums: list = []
    cols = bytearray(n * COL_SIZE)
    digests: dict = {}
    pack_into = COLS.pack_into
    for i, r in enumerate(reports):
        if not isinstance(r, dict) or not _ALLOWED_KEYS.issuperset(r):
            return None
        num = r.get("piece_num")
        if type(num) is not int or not 0 <= num < (1 << 63):
            return None
        start = _int_field(r.get("range_start"), _U64)
        size = _int_field(r.get("range_size"), _U32)
        cost = _int_field(r.get("download_cost_ms", 0), _U32)
        if start is None or size is None or cost is None:
            return None
        dst = r.get("dst_peer_id", "")
        if type(dst) is not str:
            return None
        pi = peer_idx.get(dst)
        if pi is None:
            if len(peers) >= 0xFFFF:
                return None
            pi = peer_idx[dst] = len(peers)
            peers.append(dst)
        flags = 0
        dcn = stall = store = 0
        timings = r.get("timings")
        if timings is not None:
            if not isinstance(timings, dict) \
                    or not set(timings).issubset(_TIMING_KEYS):
                return None
            if timings:        # {} is falsy: the dict walk ignores it too
                flags |= FLAG_TIMINGS
                vals = []
                for key in _TIMING_KEYS:
                    v = timings.get(key)
                    if v is None:
                        v = 0   # dict walk: int(timings.get(k, 0) or 0)
                    v = _int_field(v, _U32)
                    if v is None:
                        return None
                    vals.append(v)
                dcn, stall, store = vals
        crc = 0
        digest = r.get("digest", "")
        if type(digest) is not str:
            return None
        if digest:
            if (len(digest) == 15 and digest.startswith("crc32c:")
                    and _HEX.issuperset(digest[7:])):
                crc = int(digest[7:], 16)
                flags |= FLAG_CRC_DIGEST
            else:
                digests[i] = digest
                flags |= FLAG_SPILL_DIGEST
        nums.append(num)
        pack_into(cols, i * COL_SIZE, cost, start, size, pi, flags,
                  dcn, stall, store, crc)
    packed = {"v": 1, "n": n, "peers": peers,
              "nums": _encode_nums(nums), "cols": bytes(cols)}
    if digests:
        packed["digests"] = digests
    return packed


# --------------------------------------------------------------------- #
# decoded batch
# --------------------------------------------------------------------- #

class DecodedBatch:
    """One decoded packed batch: per-piece columns as plain Python lists
    (identical across backends) plus the batch aggregates the scheduler's
    apply path consumes — phase sums for PodAggregator, per-parent
    [count, cost_sum, bytes] for fleet scorecards — computed inside the
    backend so the hot path never walks pieces in Python."""

    __slots__ = ("n", "peers", "nums", "costs", "starts", "sizes",
                 "peer_idx", "flags", "crcs", "spill",
                 "cost_total", "bytes_total", "phase_ms", "parent_aggs",
                 "min_cost", "_phase_cols")

    def __init__(self, n, peers, nums, costs, starts, sizes, peer_idx,
                 flags, crcs, spill, cost_total, bytes_total, phase_ms,
                 parent_aggs, min_cost):
        self.n = n
        self.peers = peers
        self.nums = nums
        self.costs = costs
        self.starts = starts
        self.sizes = sizes
        self.peer_idx = peer_idx
        self.flags = flags
        self.crcs = crcs
        self.spill = spill
        self.cost_total = cost_total
        self.bytes_total = bytes_total
        self.phase_ms = phase_ms          # (dcn, stall, store) sums
        self.parent_aggs = parent_aggs    # per peer idx: [k, cost, bytes]
        self.min_cost = min_cost
        # Per-piece phase columns: only the slow-path bridge and debug
        # accessors need them — backends hand them over via _set_phases.
        self._phase_cols = ((), (), ())

    def digest(self, i: int) -> str:
        f = self.flags[i]
        if f & FLAG_CRC_DIGEST:
            return f"crc32c:{self.crcs[i]:08x}"
        if f & FLAG_SPILL_DIGEST:
            return self.spill.get(i, "")
        return ""

    def timings(self, i: int) -> "dict | None":
        if not self.flags[i] & FLAG_TIMINGS:
            return None
        return {"dcn_ms": self.phase_of(i, 0), "stall_ms": self.phase_of(i, 1),
                "store_ms": self.phase_of(i, 2)}

    def phase_of(self, i: int, phase: int) -> int:
        return self._phase_cols[phase][i]

    def to_dicts(self) -> list:
        """The equivalent dict-list batch — the slow-path bridge when the
        bulk apply can't run (duplicate nums, partially-known peer) and
        the reconstruction every fuzz test round-trips against."""
        out = []
        dcns, stalls, stores = self._phase_cols
        for i in range(self.n):
            d = {"piece_num": self.nums[i],
                 "range_start": self.starts[i],
                 "range_size": self.sizes[i],
                 "digest": self.digest(i),
                 "download_cost_ms": self.costs[i],
                 "dst_peer_id": self.peers[self.peer_idx[i]]}
            if self.flags[i] & FLAG_TIMINGS:
                d["timings"] = {"dcn_ms": dcns[i], "stall_ms": stalls[i],
                                "store_ms": stores[i]}
            out.append(d)
        return out

    def _set_phases(self, dcns, stalls, stores):
        self._phase_cols = (dcns, stalls, stores)
        return self


def _finish(n, peers, nums, cols, spill):
    """Shared python-rung finishing: aggregate totals from unpacked
    column lists (the reference semantics every backend must match)."""
    costs, starts, sizes, pidx, flags, dcns, stalls, stores, crcs = cols
    cost_total = 0
    bytes_total = 0
    dcn_t = stall_t = store_t = 0
    aggs = [[0, 0, 0] for _ in peers]
    min_cost = 0
    for i in range(n):
        c = costs[i]
        cost_total += c
        bytes_total += sizes[i]
        if flags[i] & FLAG_TIMINGS:
            dcn_t += dcns[i]
            stall_t += stalls[i]
            store_t += stores[i]
        else:
            dcn_t += c
        a = aggs[pidx[i]]
        a[0] += 1
        a[1] += c
        a[2] += sizes[i]
        if i == 0 or c < min_cost:
            min_cost = c
    batch = DecodedBatch(n, peers, nums, costs, starts, sizes, pidx,
                         flags, crcs, spill, cost_total, bytes_total,
                         (dcn_t, stall_t, store_t), aggs, min_cost)
    return batch._set_phases(dcns, stalls, stores)


# --------------------------------------------------------------------- #
# decoders: numpy, held to the pure-Python reference
# --------------------------------------------------------------------- #

def _decode_python(nums_b, cols_b, n, peers, spill):
    nums = _decode_nums(nums_b, n)
    cols = tuple([] for _ in range(9))
    appends = [c.append for c in cols]
    n_peers = len(peers)
    for row in COLS.iter_unpack(cols_b):
        if row[3] >= n_peers:
            raise CodecError("peer intern index out of range")
        for v, app in zip(row, appends):
            app(v)
    return _finish(n, peers, nums, cols, spill)


_NP_DTYPE = np.dtype([
    ("cost", "<u4"), ("start", "<u8"), ("size", "<u4"),
    ("peer", "<u2"), ("flags", "<u2"), ("dcn", "<u4"),
    ("stall", "<u4"), ("store", "<u4"), ("crc", "<u4")])


def _decode_numpy(nums_b, cols_b, n, peers, spill):
    nums = _decode_nums(nums_b, n)     # varint stream stays a Python loop
    arr = np.frombuffer(cols_b, dtype=_NP_DTYPE)
    pidx = arr["peer"].astype(np.int64)
    n_peers = len(peers)
    if n and int(pidx.max()) >= n_peers:
        raise CodecError("peer intern index out of range")
    cost = arr["cost"].astype(np.int64)
    size = arr["size"].astype(np.int64)
    flags = arr["flags"]
    timed = (flags & FLAG_TIMINGS).astype(bool)
    dcn = arr["dcn"].astype(np.int64)
    # int64 accumulation throughout: identical to the python rung, no
    # float64 rounding at any batch size.
    dcn_t = int(np.where(timed, dcn, cost).sum())
    stall_t = int(arr["stall"].astype(np.int64)[timed].sum())
    store_t = int(arr["store"].astype(np.int64)[timed].sum())
    counts = np.bincount(pidx, minlength=n_peers)
    agg_cost = np.zeros(n_peers, np.int64)
    np.add.at(agg_cost, pidx, cost)
    agg_bytes = np.zeros(n_peers, np.int64)
    np.add.at(agg_bytes, pidx, size)
    aggs = [[int(counts[p]), int(agg_cost[p]), int(agg_bytes[p])]
            for p in range(n_peers)]
    batch = DecodedBatch(
        n, peers, nums, cost.tolist(), arr["start"].tolist(), size.tolist(),
        pidx.tolist(), flags.tolist(), arr["crc"].tolist(), spill,
        int(cost.sum()), int(size.sum()), (dcn_t, stall_t, store_t),
        aggs, int(cost.min()) if n else 0)
    return batch._set_phases(dcn.tolist(), arr["stall"].tolist(),
                             arr["store"].tolist())


def report_backend() -> str:
    """The packed-batch decoder the port uses: always ``"numpy"`` (the
    JAX package's native rung is not ported)."""
    return "numpy"


def decode_packed(packed: dict) -> DecodedBatch:
    """Decode a packed ``pieces_finished`` batch. Raises CodecError on
    any structural violation — the caller drops the batch (at-least-once
    re-delivery restores the pieces) instead of failing the stream."""
    if not isinstance(packed, dict) or packed.get("v") != 1:
        raise CodecError(f"unsupported packed version {packed.get('v')!r}"
                         if isinstance(packed, dict)
                         else "packed body must be a map")
    n = packed.get("n")
    if type(n) is not int or n < 0:
        raise CodecError("bad piece count")
    peers = packed.get("peers")
    if not isinstance(peers, list) \
            or any(not isinstance(p, str) for p in peers):
        raise CodecError("bad peer intern table")
    nums_b = packed.get("nums")
    cols_b = packed.get("cols")
    if not isinstance(nums_b, (bytes, bytearray)) \
            or not isinstance(cols_b, (bytes, bytearray)):
        raise CodecError("nums/cols must be binary")
    if len(cols_b) != n * COL_SIZE:
        raise CodecError(f"column block is {len(cols_b)} bytes, "
                         f"want {n * COL_SIZE}")
    spill_raw = packed.get("digests") or {}
    if not isinstance(spill_raw, dict):
        raise CodecError("digest spill must be a map")
    spill = {}
    for k, v in spill_raw.items():
        if type(k) is not int or not isinstance(v, str) or not 0 <= k < n:
            raise CodecError("bad digest spill entry")
        spill[k] = v
    return _decode_numpy(bytes(nums_b), bytes(cols_b), n, list(peers), spill)


# --------------------------------------------------------------------- #
# RESUME piece bitmap
# --------------------------------------------------------------------- #

# bit i of byte (num >> 3) set <=> piece num landed.
_BITS_OF = tuple(
    tuple(b for b in range(8) if v & (1 << b)) for v in range(256))


def nums_to_bitmap(nums) -> bytes:
    """Landed-piece set as a little-bitmap (bit i of byte i>>3)."""
    if not nums:
        return b""
    out = bytearray((max(nums) >> 3) + 1)
    for num in nums:
        out[num >> 3] |= 1 << (num & 7)
    return bytes(out)


def bitmap_to_nums(bitmap) -> list:
    """Ascending piece numbers set in ``bitmap`` (inverse of
    nums_to_bitmap up to ordering/duplicates)."""
    nums = []
    extend = nums.extend
    base = 0
    for byte in bytes(bitmap):
        if byte:
            extend(base + b for b in _BITS_OF[byte])
        base += 8
    return nums
