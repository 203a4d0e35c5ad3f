"""The filesystem backend: the port's copy of
``dragonfly2_tpu/pkg/objectstorage/fs.py``.

A bucket is a directory, an object a file, its metadata a ``.dfmeta``
JSON sidecar, laid out as the JAX backend lays them, so either gateway
serves the other's root. ``object_url`` is a ``file://`` URL, so a P2P
back-to-source reads the file through the ``file`` origin client.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import AsyncIterator
from urllib.parse import quote

from dragonfly2_tpu_torch.pkg.objectstorage.base import (
    BucketMetadata,
    ObjectMetadata,
    ObjectStorage,
    ObjectStorageError,
)

_META_SUFFIX = ".dfmeta"


class FSObjectStorage(ObjectStorage):
    name = "fs"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _bucket_dir(self, bucket: str) -> str:
        if not bucket or "/" in bucket or bucket.startswith("."):
            raise ObjectStorageError(f"invalid bucket name {bucket!r}")
        return os.path.join(self.root, bucket)

    def _object_path(self, bucket: str, key: str) -> str:
        d = self._bucket_dir(bucket)
        norm = os.path.normpath(key)
        if norm.startswith("..") or os.path.isabs(norm):
            raise ObjectStorageError(f"invalid object key {key!r}")
        return os.path.join(d, norm)

    # -- buckets -----------------------------------------------------------

    async def get_bucket_metadata(self, bucket: str) -> BucketMetadata:
        d = self._bucket_dir(bucket)
        if not os.path.isdir(d):
            raise ObjectStorageError(f"bucket {bucket!r} not found")
        return BucketMetadata(name=bucket, created_at=os.path.getctime(d))

    async def create_bucket(self, bucket: str) -> None:
        os.makedirs(self._bucket_dir(bucket), exist_ok=True)

    async def delete_bucket(self, bucket: str) -> None:
        d = self._bucket_dir(bucket)
        if not os.path.isdir(d):
            raise ObjectStorageError(f"bucket {bucket!r} not found")
        shutil.rmtree(d)

    async def list_buckets(self) -> list[BucketMetadata]:
        out = []
        for name in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, name)
            if os.path.isdir(d):
                out.append(BucketMetadata(name=name,
                                          created_at=os.path.getctime(d)))
        return out

    # -- objects -----------------------------------------------------------

    def _load_meta(self, path: str) -> dict:
        try:
            with open(path + _META_SUFFIX) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    async def get_object_metadata(self, bucket: str,
                                  key: str) -> ObjectMetadata:
        path = self._object_path(bucket, key)
        if not os.path.isfile(path):
            raise ObjectStorageError(f"object {bucket}/{key} not found")
        side = self._load_meta(path)
        st = os.stat(path)
        return ObjectMetadata(
            key=key, content_length=st.st_size,
            content_type=side.get("content_type", ""),
            etag=side.get("etag", ""), digest=side.get("digest", ""),
            last_modified=st.st_mtime,
            user_metadata=side.get("user_metadata", {}))

    async def get_object(self, bucket: str, key: str, range_start: int = -1,
                         range_end: int = -1) -> AsyncIterator[bytes]:
        path = self._object_path(bucket, key)
        if not os.path.isfile(path):
            raise ObjectStorageError(f"object {bucket}/{key} not found")

        async def chunks() -> AsyncIterator[bytes]:
            with open(path, "rb") as f:
                if range_start >= 0:
                    f.seek(range_start)
                remaining = (range_end - range_start + 1
                             if range_end >= 0 else -1)
                while True:
                    n = 1 << 20 if remaining < 0 else min(1 << 20, remaining)
                    if n == 0:
                        break
                    data = f.read(n)
                    if not data:
                        break
                    if remaining > 0:
                        remaining -= len(data)
                    yield data

        return chunks()

    async def put_object(self, bucket: str, key: str, data,
                         *, digest: str = "", content_type: str = "") -> None:
        path = self._object_path(bucket, key)
        if not os.path.isdir(self._bucket_dir(bucket)):
            raise ObjectStorageError(f"bucket {bucket!r} not found")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            if isinstance(data, (bytes, bytearray)):
                f.write(data)
            else:
                shutil.copyfileobj(data, f, 1 << 20)
        os.replace(tmp, path)
        with open(path + _META_SUFFIX, "w") as f:
            json.dump({"digest": digest, "content_type": content_type,
                       "etag": f"{int(time.time() * 1e6):x}",
                       "user_metadata": {}}, f)

    async def delete_object(self, bucket: str, key: str) -> None:
        path = self._object_path(bucket, key)
        if os.path.isfile(path):
            os.unlink(path)
        if os.path.isfile(path + _META_SUFFIX):
            os.unlink(path + _META_SUFFIX)

    async def list_object_metadatas(self, bucket: str, prefix: str = "",
                                    marker: str = "",
                                    limit: int = 1000) -> list[ObjectMetadata]:
        d = self._bucket_dir(bucket)
        if not os.path.isdir(d):
            raise ObjectStorageError(f"bucket {bucket!r} not found")
        keys = []
        for base, _, files in os.walk(d):
            for fn in files:
                if fn.endswith(_META_SUFFIX) or fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(base, fn), d)
                if rel.startswith(prefix) and rel > marker:
                    keys.append(rel)
        out = []
        for key in sorted(keys)[:limit]:
            out.append(await self.get_object_metadata(bucket, key))
        return out

    def object_url(self, bucket: str, key: str) -> str:
        return "file://" + quote(self._object_path(bucket, key))
