"""Digests in ``algorithm:encoded`` form, and piece hashing: the port's
copy of ``dragonfly2_tpu/pkg/digest.py``.

CRC-32C has one implementation here: the port's host library
(``pkg/dfhost.py``, built from ``csrc/host/dfhost.cc``), which gives the
JAX package's native values bit for bit. There is no backend ladder: a
missing compiler raises at the first hash. So ``preferred_piece_algorithm``
is always crc32c, as it is for the JAX daemon wherever its native library
or google-crc32c loads. ``_crc32c_py``, the table-driven version, stays as
the plain version the tests hold the library against; nothing on the
store's path calls it.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg import dfhost

ALGORITHM_MD5 = "md5"
ALGORITHM_SHA1 = "sha1"
ALGORITHM_SHA256 = "sha256"
ALGORITHM_SHA512 = "sha512"
ALGORITHM_CRC32C = "crc32c"

_ALGORITHMS = (ALGORITHM_MD5, ALGORITHM_SHA1, ALGORITHM_SHA256,
               ALGORITHM_SHA512, ALGORITHM_CRC32C)

_ENCODED_RE = {
    ALGORITHM_MD5: re.compile(r"^[a-f0-9]{32}$"),
    ALGORITHM_SHA1: re.compile(r"^[a-f0-9]{40}$"),
    ALGORITHM_SHA256: re.compile(r"^[a-f0-9]{64}$"),
    ALGORITHM_SHA512: re.compile(r"^[a-f0-9]{128}$"),
    ALGORITHM_CRC32C: re.compile(r"^[a-f0-9]{8}$"),
}


class InvalidDigestError(ValueError):
    pass


@dataclass(frozen=True)
class Digest:
    """A digest in ``algorithm:encoded`` form."""

    algorithm: str
    encoded: str

    def __post_init__(self):
        if self.algorithm not in _ALGORITHMS:
            raise InvalidDigestError(
                f"unsupported digest algorithm {self.algorithm!r}")
        if not _ENCODED_RE[self.algorithm].match(self.encoded):
            raise InvalidDigestError(
                f"invalid {self.algorithm} encoded value {self.encoded!r}")

    def __str__(self) -> str:
        return f"{self.algorithm}:{self.encoded}"


def parse(value: str) -> Digest:
    """Parse ``algorithm:encoded``."""
    algorithm, sep, encoded = value.partition(":")
    if not sep:
        raise InvalidDigestError(f"digest {value!r} missing ':' separator")
    return Digest(algorithm, encoded.lower())


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), one table lookup a byte: the plain version."""
    table = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC32C_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C over any contiguous bytes-like, continuing from ``crc``,
    by the host library."""
    return dfhost.crc32c(data, crc)


class _Crc32cHasher:
    """hashlib-like interface over crc32c."""

    name = ALGORITHM_CRC32C
    digest_size = 4

    def __init__(self):
        self._crc = 0

    def update(self, data) -> None:
        self._crc = crc32c(data, self._crc)

    def hexdigest(self) -> str:
        return f"{self._crc:08x}"

    def digest(self) -> bytes:
        return self._crc.to_bytes(4, "big")


def preferred_piece_algorithm() -> str:
    """The per-piece digest of newly written pieces: crc32c, fused into
    the write by the host library."""
    return ALGORITHM_CRC32C


def new_hasher(algorithm: str):
    if algorithm == ALGORITHM_CRC32C:
        return _Crc32cHasher()
    if algorithm in (ALGORITHM_MD5, ALGORITHM_SHA1, ALGORITHM_SHA256,
                     ALGORITHM_SHA512):
        return hashlib.new(algorithm)
    raise InvalidDigestError(f"unsupported digest algorithm {algorithm!r}")


def hash_bytes(algorithm: str, data) -> Digest:
    h = new_hasher(algorithm)
    h.update(data)
    return Digest(algorithm, h.hexdigest())
