"""The origin client interface and its scheme registry: the port's copy
of ``dragonfly2_tpu/source/client.py``.

A ``ResourceClient`` opens a content stream (honouring a ``Range``
header), answers the content length and range support (``probe``, in as
few round trips as its protocol allows) and, optionally, lists a
directory. The registry maps URL schemes to clients; the port registers
``file`` and ``http``/``https`` (``source/clients/``). The other schemes
and the plugin lookup of unknown ones are not ported yet: an unknown
scheme raises ``SourceError(UnsupportedProtocol)``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import AsyncIterator
from urllib.parse import urlsplit

from dragonfly2_tpu_torch.pkg.errors import Code, SourceError

UNKNOWN_SOURCE_FILE_LEN = -2


@dataclass
class Request:
    """An origin request."""

    url: str
    header: dict[str, str] = field(default_factory=dict)
    timeout: float = 300.0

    @property
    def scheme(self) -> str:
        return urlsplit(self.url).scheme.lower()

    def with_range(self, http_range: str) -> "Request":
        h = dict(self.header)
        h["Range"] = http_range
        return Request(self.url, h, self.timeout)


@dataclass
class ListEntry:
    """One entry of a directory listing."""

    url: str
    name: str
    is_dir: bool
    content_length: int = -1


class Response:
    """An origin response: an async body stream and its metadata."""

    def __init__(
        self,
        body: AsyncIterator[bytes],
        *,
        status: int = 200,
        content_length: int = -1,
        headers: dict[str, str] | None = None,
        support_range: bool = False,
        last_modified: str = "",
        close=None,
    ):
        self.body = body
        self.status = status
        self.content_length = content_length
        self.headers = headers or {}
        self.support_range = support_range
        self.last_modified = last_modified
        self._close = close

    async def close(self) -> None:
        if self._close is not None:
            await self._close()

    async def read_all(self) -> bytes:
        chunks = []
        async for c in self.body:
            chunks.append(c)
        await self.close()
        return b"".join(chunks)


class ResourceClient(abc.ABC):
    """One origin protocol."""

    @abc.abstractmethod
    async def download(self, request: Request) -> Response:
        """Open the content stream. Honours request.header['Range']."""

    @abc.abstractmethod
    async def get_content_length(self, request: Request) -> int:
        """Content length, or UNKNOWN_SOURCE_FILE_LEN."""

    @abc.abstractmethod
    async def is_support_range(self, request: Request) -> bool:
        """Whether the origin honours byte ranges (which enables the
        concurrent back-to-source piece groups)."""

    async def get_last_modified(self, request: Request) -> str:
        return ""

    async def probe(self, request: Request) -> tuple[int, bool]:
        """(content_length, support_range) in as few round trips as the
        protocol allows; by default two calls."""
        length = await self.get_content_length(request)
        support = await self.is_support_range(request)
        return length, support

    async def list_metadata(self, request: Request) -> list[ListEntry]:
        """Directory listing for recursive downloads; optional."""
        raise SourceError(
            f"{self.__class__.__name__} does not support listing",
            Code.UnsupportedProtocol)


class Registry:
    def __init__(self):
        self._clients: dict[str, ResourceClient] = {}
        self._retains = 0
        self._close_when_idle = False

    def retain(self) -> "Registry":
        """A user with streams in flight (a running daemon) takes a
        reference; the clients' pooled connections close only when the
        last user releases and a stopping user asked for it."""
        self._retains += 1
        return self

    async def release(self, *, close_when_idle: bool = False) -> None:
        if close_when_idle:
            self._close_when_idle = True
        self._retains = max(0, self._retains - 1)
        if self._retains == 0 and self._close_when_idle:
            self._close_when_idle = False
            await self.close_all()

    def register(self, scheme: str, client: ResourceClient) -> None:
        self._clients[scheme.lower()] = client

    def get(self, url_or_scheme: str) -> ResourceClient:
        scheme = url_or_scheme
        if "://" in url_or_scheme or (":" in url_or_scheme
                                      and "/" in url_or_scheme):
            scheme = urlsplit(url_or_scheme).scheme
        client = self._clients.get(scheme.lower())
        if client is None:
            raise SourceError(f"no source client for scheme {scheme!r}",
                              Code.UnsupportedProtocol)
        return client

    async def close_all(self) -> None:
        """Close every client's pooled connections."""
        for client in list(self._clients.values()):
            close = getattr(client, "close", None)
            if close is not None:
                await close()


_default = Registry()
_builtin_loaded = False


def default_registry() -> Registry:
    _ensure_builtin_clients()
    return _default


def register_client(scheme: str, client: ResourceClient) -> None:
    _default.register(scheme, client)


def get_client(url_or_scheme: str) -> ResourceClient:
    return default_registry().get(url_or_scheme)


def _ensure_builtin_clients() -> None:
    global _builtin_loaded
    if _builtin_loaded:
        return
    _builtin_loaded = True
    from dragonfly2_tpu_torch.source.clients.file import FileSourceClient
    from dragonfly2_tpu_torch.source.clients.http import HTTPSourceClient

    if "http" not in _default._clients:
        http = HTTPSourceClient()
        _default.register("http", http)
        _default.register("https", http)
    if "file" not in _default._clients:
        _default.register("file", FileSourceClient())
