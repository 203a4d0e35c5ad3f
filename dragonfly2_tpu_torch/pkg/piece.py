"""Piece-size math: the port's own copy of ``compute_piece_size`` and
``compute_piece_count`` (``dragonfly2_tpu/pkg/piece.py``), which size the
device sink's slots exactly as the daemon sizes its pieces."""

from __future__ import annotations

import math

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
