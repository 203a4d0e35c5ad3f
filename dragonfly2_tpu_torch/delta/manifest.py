"""Chunk manifests: the port's own copy of ``Chunk``, ``CDCParams`` and
``DeltaManifest`` (``dragonfly2_tpu/delta/chunker.py`` and
``dragonfly2_tpu/delta/manifest.py``).

A manifest lists one content version's chunks ``{offset, length,
sha256}`` and the chunking geometry that cut them. The port reads the
manifests other hosts publish (``from_json_bytes``) and plans a device
hot-swap from two of them; it has no chunker of its own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg import metrics

MANIFEST_VERSION = 1

MANIFEST_FETCHES = metrics.counter(
    "peer_delta_manifest_total",
    "Delta manifest resolutions by outcome", ("result",))


class ManifestError(Exception):
    """Malformed or inconsistent chunk manifest."""


@dataclass(frozen=True)
class CDCParams:
    """Chunking geometry: candidates every ~2^mask_bits bytes, chunks
    within [min_size, max_size]. Two manifests dedup against each other
    only when their params are equal. Defaults: ~1.25 MiB chunks within
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


@dataclass
class DeltaManifest:
    """One content version's chunk map."""

    name: str
    content_length: int
    chunks: list[Chunk]
    params: CDCParams = field(default_factory=CDCParams)
    version: int = MANIFEST_VERSION

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def digest_map(self) -> dict[str, Chunk]:
        """sha256 hex -> chunk (first occurrence wins; chunks with equal
        content are interchangeable)."""
        out: dict[str, Chunk] = {}
        for c in self.chunks:
            out.setdefault(c.sha256, c)
        return out

    def validate(self) -> None:
        """Chunks must exactly tile [0, content_length)."""
        off = 0
        for c in self.chunks:
            if c.offset != off or c.length <= 0:
                raise ManifestError(
                    f"chunk at {c.offset} breaks tiling (expected {off})")
            off = c.end
        if off != self.content_length:
            raise ManifestError(
                f"chunks cover {off}B of {self.content_length}B content")

    def to_json_bytes(self) -> bytes:
        doc = {
            "v": self.version,
            "name": self.name,
            "size": self.content_length,
            "params": [self.params.mask_bits, self.params.min_size,
                       self.params.max_size],
            "chunks": [[c.offset, c.length, c.sha256] for c in self.chunks],
        }
        return json.dumps(doc, separators=(",", ":")).encode()

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "DeltaManifest":
        try:
            doc = json.loads(raw)
            if doc["v"] != MANIFEST_VERSION:
                raise ManifestError(
                    f"manifest version {doc['v']} unsupported")
            bits, mn, mx = doc["params"]
            m = cls(
                name=doc["name"], content_length=int(doc["size"]),
                chunks=[Chunk(int(o), int(n), str(s))
                        for o, n, s in doc["chunks"]],
                params=CDCParams(mask_bits=int(bits), min_size=int(mn),
                                 max_size=int(mx)))
        except ManifestError:
            raise
        except Exception as e:
            raise ManifestError(f"corrupt delta manifest: {e}") from e
        m.validate()
        return m
