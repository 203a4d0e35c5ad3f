"""Delta planning and fabric-published manifests: the port's own copy of
``plan_delta``, ``DeltaPlan``, ``fetch_manifest`` and
``publish_manifest_for`` (``dragonfly2_tpu/delta/resolver.py``).

A new version's chunk is reused when a chunk of the same sha256 and
length exists anywhere in the base version, and fetched otherwise. The
device hot-swap (``client/device.py``) copies reused chunks out of the
live device buffer and stages only the fetched ones from the host.

Manifests travel over the fabric as ``dfdelta://<content_task_id>``
tasks. The manifest task's id is a pure function of the content task id,
so the port must build the same request as the JAX package, or every
fetch misses. A host that holds the content builds and publishes its
manifest (``publish_manifest_for``); the daemon's task manager ``tm`` is
the reference one, reached by duck type.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest
from dragonfly2_tpu_torch.delta.manifest import (
    MANIFEST_FETCHES,
    CDCParams,
    Chunk,
    DeltaManifest,
    ManifestError,
    manifest_from_store,
)
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.proto.common import UrlMeta

log = dflog.get("delta.resolver")

MANIFEST_SCHEME = "dfdelta"
MANIFEST_TAG = "dfdelta-manifest"


def manifest_url(content_task_id: str) -> str:
    return f"{MANIFEST_SCHEME}://{content_task_id}"


@dataclass
class DeltaPlan:
    """Partition of the new version's chunks against a base manifest."""

    reused: list[tuple[Chunk, Chunk]] = field(default_factory=list)  # (new, base)
    fetched: list[Chunk] = field(default_factory=list)

    @property
    def reused_bytes(self) -> int:
        return sum(c.length for c, _ in self.reused)

    @property
    def fetched_bytes(self) -> int:
        return sum(c.length for c in self.fetched)

    def fetch_spans(self) -> list[tuple[int, int]]:
        """Adjacent fetched chunks merged into spans (zero-gap merges
        only: a gap byte is a reused byte)."""
        spans: list[list[int]] = []
        for c in self.fetched:
            if spans and c.offset == spans[-1][1]:
                spans[-1][1] = c.end
            else:
                spans.append([c.offset, c.end])
        return [(s, e) for s, e in spans]


def plan_delta(new_m: DeltaManifest, base_m: DeltaManifest) -> DeltaPlan:
    """A new chunk whose (sha256, length) appears anywhere in the base is
    reused from there; every other chunk is fetched. Both manifests must
    share chunking params."""
    if new_m.params != base_m.params:
        raise ManifestError(
            f"chunking params differ: {new_m.params} vs {base_m.params}")
    base_map = base_m.digest_map()
    plan = DeltaPlan()
    for c in new_m.chunks:
        b = base_map.get(c.sha256)
        if b is not None and b.length == c.length:
            plan.reused.append((c, b))
        else:
            plan.fetched.append(c)
    return plan


def manifest_request(content_task_id: str) -> FileTaskRequest:
    """The request for a content task's published manifest. A
    ``dfdelta://`` task has no origin: it exists in the fabric or not."""
    return FileTaskRequest(url=manifest_url(content_task_id), output="",
                           meta=UrlMeta(tag=MANIFEST_TAG),
                           disable_back_source=True)


async def fetch_manifest(tm, content_task_id: str,
                         timeout: float = 8.0) -> DeltaManifest | None:
    """Pull the fabric-published manifest of a content task through the
    daemon's task manager ``tm``; None when no host published one. The
    timeout is short on purpose: an unpublished manifest would cost the
    scheduler's full no-source patience, and every miss has a cheap
    recovery (chunk a landed base here, or stage the whole buffer)."""
    req = manifest_request(content_task_id)

    async def drain():
        final = None
        async for p in tm.start_file_task(req):
            if p.state == "failed":
                return None
            if p.state == "done":
                final = p
        return final

    try:
        final = await asyncio.wait_for(drain(), timeout)
    except (DfError, asyncio.TimeoutError):
        final = None
    if final is None:
        MANIFEST_FETCHES.labels("miss").inc()
        return None
    store = tm.storage.find_completed_task(final.task_id)
    if store is None:
        return None
    n = store.metadata.content_length
    buf = bytearray(n)
    try:
        with store:
            await asyncio.to_thread(store.read_into, 0, n, buf)
        m = DeltaManifest.from_json_bytes(buf)
    except ManifestError as e:
        log.warning("fabric manifest corrupt; ignoring",
                    task=content_task_id[:16], error=str(e)[:200])
        MANIFEST_FETCHES.labels("corrupt").inc()
        return None
    MANIFEST_FETCHES.labels("hit").inc()
    return m


async def publish_manifest_for(tm, content_task_id: str, *,
                               params: CDCParams | None = None,
                               manifest: DeltaManifest | None = None,
                               device=None) -> DeltaManifest | None:
    """Build the manifest of this host's completed copy of a content task
    (scanned on ``device``), or take the prebuilt ``manifest``, and import
    it as the ``dfdelta://`` task, announced like any import so peers can
    pull it. An already-published manifest task is left as it is. Returns
    the manifest, or None when the content is not landed here.

    ``tm`` is the daemon's task manager: ``storage.find_completed_task``,
    ``storage.opt.data_dir`` and ``import_task``."""
    store = tm.storage.find_completed_task(content_task_id)
    if store is None:
        log.warning("cannot publish manifest: content not landed",
                    task=content_task_id[:16])
        return None
    m = manifest
    if m is None:
        m = await asyncio.to_thread(manifest_from_store, store,
                                    store.metadata.url, params,
                                    device=device)
    req = manifest_request(content_task_id)
    if tm.storage.find_completed_task(req.task_id()) is not None:
        MANIFEST_FETCHES.labels("published").inc()
        return m
    path = os.path.join(tm.storage.opt.data_dir,
                        f".manifest-{content_task_id[:16]}.json")
    try:
        await asyncio.to_thread(_write_file, path, m.to_json_bytes())
        await tm.import_task(path, req)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    MANIFEST_FETCHES.labels("published").inc()
    return m


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
