"""Object-storage backends behind one interface: the port's copy of
``dragonfly2_tpu/pkg/objectstorage/``, with the ``fs`` backend only.

A backend's ``object_url`` is the origin URL a P2P task fetches the
object from, which is how the daemon's gateway turns object GETs into
ordinary stream tasks; ``fs``'s is a ``file://`` URL, read by the port's
``file`` origin client. The cloud backends (``s3``, ``gcs``, ``oss``,
``obs``) come with the port's cloud source clients: ``new_client``
refuses them by name.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.pkg.objectstorage.base import (
    BucketMetadata,
    ObjectMetadata,
    ObjectStorage,
    ObjectStorageError,
)

NOT_PORTED = ("s3", "gcs", "oss", "obs")


def new_client(name: str, **kwargs) -> ObjectStorage:
    """A backend by name: ``fs``."""
    if name == "fs":
        from dragonfly2_tpu_torch.pkg.objectstorage.fs import FSObjectStorage

        return FSObjectStorage(**kwargs)
    if name in NOT_PORTED:
        raise ObjectStorageError(
            f"object storage backend {name!r} is not ported yet (the port "
            f"has the 'fs' backend only)")
    raise ObjectStorageError(f"unknown object storage backend {name!r}")


__all__ = [
    "BucketMetadata",
    "NOT_PORTED",
    "ObjectMetadata",
    "ObjectStorage",
    "ObjectStorageError",
    "new_client",
]
