"""The checkpoint-delta plane of the port: content-defined chunking (its
scan on the card), chunk manifests, the delta plan and fabric-published
manifests. ``client/device.py`` drives the device hot-swap from them."""

from dragonfly2_tpu_torch.delta.chunker import (
    CDCParams,
    Chunk,
    GearChunker,
    chunk_bytes,
)
from dragonfly2_tpu_torch.delta.manifest import (
    DeltaManifest,
    ManifestError,
    build_manifest,
    fetch_or_build_manifest,
    manifest_from_store,
    manifest_object_key,
)
from dragonfly2_tpu_torch.delta.resolver import (
    DeltaPlan,
    fetch_manifest,
    manifest_url,
    plan_delta,
    publish_manifest_for,
)

__all__ = [
    "CDCParams", "Chunk", "GearChunker", "chunk_bytes",
    "DeltaManifest", "ManifestError", "build_manifest",
    "fetch_or_build_manifest", "manifest_from_store", "manifest_object_key",
    "DeltaPlan", "fetch_manifest", "manifest_url", "plan_delta",
    "publish_manifest_for",
]
