"""Piece-size math, piece records and byte ranges: the port's own copy of
``compute_piece_size``, ``compute_piece_count``, ``piece_length``,
``PieceInfo``, ``Range`` and ``SizeScope`` (``dragonfly2_tpu/pkg/piece.py``). The piece math sizes the device sink's
slots exactly as the daemon sizes its pieces; the reference daemon reads
a port request's ``Range`` directly (``start``, ``length``); the
scheduler's registration shortcuts read ``SizeScope``."""

from __future__ import annotations

import math
from dataclasses import dataclass

_MB = 1024 * 1024
DEFAULT_PIECE_SIZE = 4 * _MB
PIECE_SIZE_LIMIT = 32 * _MB

# Content up to this size keeps the 4 MiB floor; above it the piece size
# scales to hold the piece count near _TARGET_PIECES.
_SCALE_START = 128 * _MB
_TARGET_PIECES = 32


def compute_piece_size(length: int) -> int:
    """4 MiB up to 128 MiB of content; above that ~32 pieces per task in
    1 MiB multiples, capped at 32 MiB."""
    if length <= 0 or length <= _SCALE_START:
        return DEFAULT_PIECE_SIZE
    target = length // _TARGET_PIECES
    size = ((target + _MB - 1) // _MB) * _MB  # 1 MiB multiple (sink alignment)
    return min(max(size, DEFAULT_PIECE_SIZE), PIECE_SIZE_LIMIT)


def compute_piece_count(length: int, piece_size: int) -> int:
    """ceil(length / piece_size)."""
    return math.ceil(length / piece_size)


def piece_length(piece_num: int, piece_size: int, content_length: int) -> int:
    """Length of piece ``piece_num`` given the content length (a whole
    piece while the length is unknown)."""
    start = piece_num * piece_size
    if content_length < 0:
        return piece_size
    return max(0, min(piece_size, content_length - start))


@dataclass
class PieceInfo:
    """One piece's wire record."""

    piece_num: int
    range_start: int
    range_size: int
    digest: str = ""            # "crc32c:..." / "md5:..."
    download_cost_ms: int = 0
    dst_peer_id: str = ""       # the parent that served it

    def to_wire(self) -> dict:
        return {
            "piece_num": self.piece_num,
            "range_start": self.range_start,
            "range_size": self.range_size,
            "digest": self.digest,
            "download_cost_ms": self.download_cost_ms,
            "dst_peer_id": self.dst_peer_id,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "PieceInfo":
        return cls(
            piece_num=d["piece_num"],
            range_start=d["range_start"],
            range_size=d["range_size"],
            digest=d.get("digest", ""),
            download_cost_ms=d.get("download_cost_ms", 0),
            dst_peer_id=d.get("dst_peer_id", ""),
        )


@dataclass
class Range:
    """HTTP byte range [start, start+length); ``length`` is -1 for an
    open end (``bytes=N-``) whose content length is not known yet."""

    start: int
    length: int

    @staticmethod
    def normalize_header(value: str) -> str:
        """Canonical ``bytes=a-b`` form, validated. The string is task
        identity (``task_id_v1`` hashes it verbatim), so a ranged request
        normalizes through here or its task id stops matching the other
        producers'. Raises ValueError on malformed or suffix spans."""
        if not value:
            return ""
        v = value if value.strip().startswith("bytes=") else f"bytes={value}"
        return Range.parse_http(v).to_http()

    @classmethod
    def parse_http(cls, header: str, content_length: int = -1) -> "Range | None":
        """Parse a single ``bytes=a-b`` / ``bytes=a-`` / ``bytes=-n``."""
        if not header:
            return None
        value = header.strip()
        if value.startswith("bytes="):
            value = value[len("bytes="):]
        if "," in value:
            raise ValueError("multi-range not supported")
        start_s, sep, end_s = value.partition("-")
        if not sep:
            raise ValueError(f"invalid range {header!r}")
        if not start_s:  # suffix range: the last N bytes
            if content_length < 0:
                raise ValueError("suffix range needs content length")
            n = int(end_s)
            return cls(max(0, content_length - n), min(n, content_length))
        start = int(start_s)
        if not end_s:
            if content_length < 0:
                return cls(start, -1)
            return cls(start, max(0, content_length - start))
        end = int(end_s)
        if end < start:
            raise ValueError(f"inverted range {header!r}")
        return cls(start, end - start + 1)

    def to_http(self) -> str:
        if self.length < 0:
            return f"bytes={self.start}-"
        return f"bytes={self.start}-{self.start + self.length - 1}"


class SizeScope:
    """Task size classes that drive the scheduler's registration
    shortcuts."""

    NORMAL = "normal"   # more than one piece: the full piece machinery
    SMALL = "small"     # one piece: the single-piece shortcut
    TINY = "tiny"       # <= 128 bytes: inlined in the scheduler's answer
    EMPTY = "empty"     # zero bytes
    UNKNOW = "unknow"   # content length not known yet

    TINY_FILE_SIZE = 128

    @classmethod
    def of(cls, content_length: int, piece_size: int,
           total_piece_count: int | None = None) -> str:
        if content_length < 0:
            return cls.UNKNOW
        if content_length == 0:
            return cls.EMPTY
        if content_length <= cls.TINY_FILE_SIZE:
            return cls.TINY
        if total_piece_count is None:
            total_piece_count = compute_piece_count(content_length,
                                                    piece_size)
        if total_piece_count == 1:
            return cls.SMALL
        return cls.NORMAL
