"""Chunk manifests: the port's own copy of
``dragonfly2_tpu/delta/manifest.py``'s ``DeltaManifest``,
``build_manifest``, ``manifest_from_store``, ``manifest_object_key`` and
``fetch_or_build_manifest``.

A manifest lists one content version's chunks ``{offset, length,
sha256}`` and the chunking geometry that cut them (``CDCParams`` and
``Chunk`` live in ``delta/chunker.py`` and are imported here too). The
port builds manifests with its own chunker, whose scan runs on the card,
and reads the manifests other hosts publish (``from_json_bytes``); a
device hot-swap plans from two of them. Its manifests are the JAX
package's, byte for byte. Over the object gateway a manifest is cached
beside its object as ``.dfdelta/<key>.json`` (``fetch_or_build_manifest``,
the pattern of the dataset plane's ``fetch_or_build_index``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.client.dfstore import DfstoreError
from dragonfly2_tpu_torch.delta.chunker import CDCParams, Chunk, GearChunker
from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("delta.manifest")

MANIFEST_VERSION = 1
# Hidden bucket prefix of gateway-cached manifests, beside the object.
MANIFEST_PREFIX = ".dfdelta/"

MANIFEST_FETCHES = metrics.counter(
    "peer_delta_manifest_total",
    "Delta manifest resolutions by outcome", ("result",))


class ManifestError(Exception):
    """Malformed or inconsistent chunk manifest."""


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


def build_manifest(data, name: str = "", params: CDCParams | None = None,
                   *, device=None) -> DeltaManifest:
    """Manifest of in-memory content, scanned on ``device``."""
    ch = GearChunker(params, device=device)
    ch.feed(data)
    ch.finish()
    return DeltaManifest(name=name, content_length=len(data),
                         chunks=ch.chunks, params=ch.params)


def manifest_from_store(store, name: str = "",
                        params: CDCParams | None = None,
                        span: int = 8 << 20, *, device=None,
                        stats: dict | None = None) -> DeltaManifest:
    """Manifest of a completed task store (``metadata``, ``read_into``,
    ``with`` to pin it): ``span``-byte reads into one buffer of this
    call's own, fed through the streaming chunker scanning on ``device``;
    never the whole content in memory. Blocking: callers on an event loop
    run it in a thread.

    ``stats``, when given, gets the host seconds of the reads
    (``read_s``), the chunker's ``timings`` and the number of
    ``feeds``."""
    total = store.metadata.content_length
    if total < 0:
        raise ManifestError(
            f"task {store.metadata.task_id[:16]} has unknown length")
    ch = GearChunker(params, device=device)
    buf = bytearray(min(span, total))
    read_s = 0.0
    feeds = 0
    with store:
        off = 0
        while off < total:
            take = min(span, total - off)
            t0 = time.perf_counter()
            store.read_into(off, take, buf)
            read_s += time.perf_counter() - t0
            ch.feed(memoryview(buf)[:take])
            feeds += 1
            off += take
    ch.finish()
    if stats is not None:
        stats.update(read_s=read_s, feeds=feeds, **ch.timings)
    return DeltaManifest(name=name or store.metadata.url,
                         content_length=total, chunks=ch.chunks,
                         params=ch.params)


def manifest_object_key(key: str) -> str:
    """The gateway object key of the manifest cached beside ``key``."""
    return f"{MANIFEST_PREFIX}{key}.json"


async def fetch_or_build_manifest(store, bucket: str, key: str, *,
                                  params: CDCParams | None = None,
                                  publish: bool = True, device=None,
                                  stats: dict | None = None) -> DeltaManifest:
    """The pod-wide manifest contract over the object gateway (``store``
    a ``Dfstore``): try the cached manifest object first (chunked once,
    fetched everywhere); on a miss, stream the object ONE pass through the
    chunker, its scan on ``device``, and publish the result back (best
    effort; hosts racing to build it converge on identical bytes). A cached
    manifest whose recorded size disagrees with the object's current
    length, or whose params differ from ``params``, is stale and rebuilt.

    ``stats``, when given, gets the outcome (``result``: hit, or built
    after a miss, a stale or a corrupt manifest) and, for a build, the
    host seconds spent awaiting the stream (``stream_s``), the number of
    ``feeds`` and the chunker's ``timings``."""
    meta = await store.stat_object(bucket, key)    # missing object raises
    result = "built"
    try:
        raw = await store.get_object(bucket, manifest_object_key(key))
        m = DeltaManifest.from_json_bytes(raw)
        if m.content_length == meta.content_length and (
                params is None or m.params == params):
            MANIFEST_FETCHES.labels("hit").inc()
            if stats is not None:
                stats.update(result="hit")
            return m
        log.info("cached delta manifest stale; rebuilding", key=key,
                 cached=m.content_length, actual=meta.content_length)
        MANIFEST_FETCHES.labels("stale").inc()
        result = "stale"
    except DfstoreError:
        pass
    except ManifestError as e:
        log.warning("cached delta manifest corrupt; rebuilding",
                    key=key, error=str(e)[:200])
        MANIFEST_FETCHES.labels("corrupt").inc()
        result = "corrupt"
    ch = GearChunker(params, device=device)
    stream_s = 0.0
    feeds = 0
    chunks = await store.stream_object(bucket, key)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                chunk = await anext(chunks)
            except StopAsyncIteration:
                break
            finally:
                stream_s += time.perf_counter() - t0
            ch.feed(chunk)
            feeds += 1
    finally:
        await chunks.aclose()
    ch.finish()
    m = DeltaManifest(name=key, content_length=ch.consumed,
                      chunks=ch.chunks, params=ch.params)
    m.validate()
    MANIFEST_FETCHES.labels("built").inc()
    if stats is not None:
        stats.update(result=result, stream_s=stream_s, feeds=feeds,
                     **ch.timings)
    if publish:
        try:
            await store.put_object(bucket, manifest_object_key(key),
                                   m.to_json_bytes())
        except DfstoreError as e:
            log.warning("delta manifest publish failed (non-fatal)",
                        key=key, error=str(e)[:200])
    return m
