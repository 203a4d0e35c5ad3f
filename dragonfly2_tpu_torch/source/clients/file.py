"""``file://`` origin client, for local imports, shared-filesystem
origins and hermetic tests: the port's copy of
``dragonfly2_tpu/source/clients/file.py``. Its reads run on worker
threads, off the event loop."""

from __future__ import annotations

import asyncio
import os
import urllib.request
from email.utils import formatdate
from typing import AsyncIterator
from urllib.parse import unquote, urlsplit

from dragonfly2_tpu_torch.pkg.errors import Code, SourceError
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.source.client import (
    ListEntry,
    Request,
    ResourceClient,
    Response,
)

CHUNK = 1 << 20


def _url_to_path(url: str) -> str:
    parts = urlsplit(url)
    if parts.scheme != "file":
        raise SourceError(f"not a file url: {url}", Code.UnsupportedProtocol)
    return unquote(parts.path)


class FileSourceClient(ResourceClient):
    async def download(self, request: Request) -> Response:
        path = _url_to_path(request.url)
        if not os.path.exists(path):
            raise SourceError(f"file not found: {path}", Code.SourceNotFound)
        if os.path.isdir(path):
            raise SourceError(f"is a directory: {path}", Code.BadRequest)
        size = os.path.getsize(path)
        start, length = 0, size
        status = 200
        rng = request.header.get("Range")
        if rng:
            try:
                r = Range.parse_http(rng, size)
            except ValueError as e:
                raise SourceError(str(e), Code.BadRequest)
            if r is not None:
                start = r.start
                length = r.length if r.length >= 0 else size - r.start
                status = 206

        async def body() -> AsyncIterator[bytes]:
            remaining, off = length, start
            with open(path, "rb") as f:
                while remaining > 0:
                    chunk = await asyncio.to_thread(
                        os.pread, f.fileno(), min(CHUNK, remaining), off)
                    if not chunk:
                        break
                    remaining -= len(chunk)
                    off += len(chunk)
                    yield chunk

        return Response(
            body(),
            status=status,
            content_length=length,
            support_range=True,
            last_modified=formatdate(os.path.getmtime(path), usegmt=True),
        )

    async def get_content_length(self, request: Request) -> int:
        path = _url_to_path(request.url)
        if not os.path.exists(path):
            raise SourceError(f"file not found: {path}", Code.SourceNotFound)
        return os.path.getsize(path)

    async def is_support_range(self, request: Request) -> bool:
        return True

    async def get_last_modified(self, request: Request) -> str:
        path = _url_to_path(request.url)
        if not os.path.exists(path):
            return ""
        return formatdate(os.path.getmtime(path), usegmt=True)

    async def list_metadata(self, request: Request) -> list[ListEntry]:
        path = _url_to_path(request.url)
        if not os.path.isdir(path):
            raise SourceError(f"not a directory: {path}", Code.BadRequest)
        entries = []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            is_dir = os.path.isdir(full)
            entries.append(ListEntry(
                url="file://" + urllib.request.pathname2url(full),
                name=name, is_dir=is_dir,
                content_length=-1 if is_dir else os.path.getsize(full)))
        return entries
