"""The ``ObjectStorage`` interface and its metadata types: the port's copy
of ``dragonfly2_tpu/pkg/objectstorage/base.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator


class ObjectStorageError(Exception):
    """A backend failure. ``status`` is the HTTP status when one was
    received (0: a connection-level or non-HTTP failure)."""

    def __init__(self, message: str = "", status: int = 0):
        super().__init__(message)
        self.status = status


@dataclass
class BucketMetadata:
    name: str
    created_at: float = 0.0


@dataclass
class ObjectMetadata:
    key: str
    content_length: int = -1
    content_type: str = ""
    etag: str = ""
    digest: str = ""          # "algo:encoded" (stored as user metadata)
    last_modified: float = 0.0
    user_metadata: dict = field(default_factory=dict)


class ObjectStorage:
    """An async backend client. Every method raises ObjectStorageError on
    a backend failure; the exists methods return False instead."""

    name = "base"

    async def get_bucket_metadata(self, bucket: str) -> BucketMetadata:
        raise NotImplementedError

    async def create_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    async def delete_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    async def list_buckets(self) -> list[BucketMetadata]:
        raise NotImplementedError

    async def is_bucket_exist(self, bucket: str) -> bool:
        try:
            await self.get_bucket_metadata(bucket)
            return True
        except ObjectStorageError:
            return False

    async def get_object_metadata(self, bucket: str,
                                  key: str) -> ObjectMetadata:
        raise NotImplementedError

    async def get_object(self, bucket: str, key: str, range_start: int = -1,
                         range_end: int = -1) -> AsyncIterator[bytes]:
        raise NotImplementedError

    async def put_object(self, bucket: str, key: str, data,
                         *, digest: str = "", content_type: str = "") -> None:
        """``data`` is bytes or a seekable binary file (the gateway spools
        an upload to one)."""
        raise NotImplementedError

    async def delete_object(self, bucket: str, key: str) -> None:
        raise NotImplementedError

    async def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            await self.get_object_metadata(bucket, key)
            return True
        except ObjectStorageError:
            return False

    async def list_object_metadatas(self, bucket: str, prefix: str = "",
                                    marker: str = "",
                                    limit: int = 1000) -> list[ObjectMetadata]:
        raise NotImplementedError

    def object_url(self, bucket: str, key: str) -> str:
        """The origin URL a P2P task fetches this object from."""
        raise NotImplementedError

    async def close(self) -> None:
        pass
