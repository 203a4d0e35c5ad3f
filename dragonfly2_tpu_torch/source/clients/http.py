"""HTTP(S) origin client on the standard library: the port's copy of
``dragonfly2_tpu/source/clients/http.py``, which rides ``aiohttp`` (the
card machine has none).

The same requests, status mapping and answers as the JAX client:

- ``probe`` is one 1-byte ranged GET: a 206 gives the length from
  ``Content-Range`` and range support, a 200 the ``Content-Length`` and
  none; ``get_last_modified`` is a HEAD; a download reports range support
  when the origin answered 206 or sent ``Accept-Ranges: bytes``.
- 404 is ``SourceNotFound``, 401/403 ``SourceForbidden``, 416
  ``SourceRangeUnsupported``, all permanent; 408, 429 and every 5xx are
  temporary ``BackToSourceAborted``, other 4xx permanent. A connection
  failure, a timeout and a body cut short are temporary.
- Redirects are followed (at most 10), as aiohttp follows them.
- Each socket wait is bounded by 60 s (10 s to connect) and a whole
  request, body included, by ``Request.timeout`` (a probe by 30 s).

Transport: ``http.client`` on the client's own worker threads
(``df-source-http``). Connections are kept alive and reused by
(scheme, host, port); a ``ConnectionError`` on a kept-alive connection is
taken as stale (the origin closed it meanwhile) and the request is sent
once more on a fresh one. A body read to its end hands its connection
back; one abandoned or failed mid-body is closed. A cancelled call cuts
its connection and returns only after its worker has stopped. The JAX
client decompresses a compressed body; this one asks for identity and
refuses any other ``Content-Encoding`` with ``UnsupportedProtocol``.
"""

from __future__ import annotations

import html.parser
import http.client
import os
import ssl
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator
from urllib.parse import urljoin, urlsplit

from dragonfly2_tpu_torch.pkg.bufpool import WorkerCall, await_worker
from dragonfly2_tpu_torch.pkg.errors import Code, SourceError, describe
from dragonfly2_tpu_torch.source.client import (
    UNKNOWN_SOURCE_FILE_LEN,
    ListEntry,
    Request,
    ResourceClient,
    Response,
)

CHUNK = 1 << 20
WORKERS = 16
CONNECT_TIMEOUT = 10.0
READ_TIMEOUT = 60.0
PROBE_TIMEOUT = 30.0
LIST_TIMEOUT = 60.0
MAX_REDIRECTS = 10
_REDIRECTS = (301, 302, 303, 307, 308)


def _status_error(status: int, url: str) -> SourceError:
    if status == 404:
        return SourceError(f"origin 404: {url}", Code.SourceNotFound)
    if status in (401, 403):
        return SourceError(f"origin {status}: {url}", Code.SourceForbidden)
    if status == 416:
        return SourceError(f"origin 416: {url}", Code.SourceRangeUnsupported)
    # Retryable: explicit transient statuses and the whole 5xx family. The
    # other 4xx are the caller's fault: a retry can never succeed.
    temporary = status in (408, 429) or status >= 500
    return SourceError(f"origin {status}: {url}", Code.BackToSourceAborted,
                       temporary=temporary)


def _transport_error(e: BaseException, url: str, what: str) -> SourceError:
    return SourceError(f"origin {what} {url}: {describe(e)}",
                       Code.BackToSourceAborted, temporary=True)


def _ssl_config() -> ssl.SSLContext:
    """Origin TLS trust: DRAGONFLY_SSL_CA_FILE adds a private CA,
    DRAGONFLY_SSL_INSECURE=1 turns verification off; by default the
    system's trust store."""
    ctx = ssl.create_default_context(
        cafile=os.environ.get("DRAGONFLY_SSL_CA_FILE") or None)
    if os.environ.get("DRAGONFLY_SSL_INSECURE") == "1":
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


class _Exchange:
    """One response and the connection it arrived on."""

    def __init__(self, key, conn, resp, url: str, deadline: float):
        self.key = key
        self.conn = conn
        self.resp = resp
        self.url = url
        self.deadline = deadline


class HTTPSourceClient(ResourceClient):
    # Its worker threads are df-<THREADS>.
    THREADS = "source-http"

    def __init__(self, workers: int = WORKERS):
        self._workers = workers
        self._mu = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._idle: dict[tuple, list[http.client.HTTPConnection]] = {}
        self._ssl: ssl.SSLContext | None = None

    # -- transport ---------------------------------------------------------

    def _executor(self) -> ThreadPoolExecutor:
        with self._mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix=f"df-{self.THREADS}")
            return self._pool

    async def _run(self, fn, *args):
        """``fn(call, *args)`` on a worker; a cancel cuts the call's
        connection and waits for the worker to stop."""
        call = WorkerCall()
        fut = self._executor().submit(fn, call, *args)
        return await await_worker(fut, call.abort)

    async def close(self) -> None:
        with self._mu:
            pool, self._pool = self._pool, None
            idle, self._idle = self._idle, {}
        if pool is not None:
            pool.shutdown(wait=False)
        for conns in idle.values():
            for conn in conns:
                conn.close()

    def _checkout(self, key) -> tuple[http.client.HTTPConnection, bool]:
        """An idle connection to ``key`` (reused: True) or a new one."""
        with self._mu:
            idle = self._idle.get(key)
            if idle:
                return idle.pop(), True
        scheme, host, port = key
        if scheme == "https":
            if self._ssl is None:
                self._ssl = _ssl_config()
            return http.client.HTTPSConnection(
                host, port, timeout=CONNECT_TIMEOUT, context=self._ssl), False
        return http.client.HTTPConnection(host, port,
                                          timeout=CONNECT_TIMEOUT), False

    def _checkin(self, ex: _Exchange) -> None:
        """Hand back a connection whose response was read to its end;
        close any other."""
        resp = ex.resp
        if resp.isclosed() and not resp.will_close and ex.conn.sock is not None:
            with self._mu:
                if self._pool is not None:
                    self._idle.setdefault(ex.key, []).append(ex.conn)
                    return
        ex.conn.close()

    @staticmethod
    def _wait_budget(deadline: float) -> float:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("request timed out")
        return min(READ_TIMEOUT, left)

    def _exchange(self, call: WorkerCall, method: str, url: str, headers: dict,
                  total: float) -> _Exchange:
        """Send ``method url`` and read the status line and headers,
        following redirects. A kept-alive connection that proves stale is
        replaced once. Raises OSError / HTTPException on transport
        failures."""
        deadline = time.monotonic() + total
        for _ in range(MAX_REDIRECTS + 1):
            parts = urlsplit(url)
            if parts.scheme not in ("http", "https") or not parts.hostname:
                raise SourceError(f"unsupported url {url!r}",
                                  Code.UnsupportedProtocol)
            key = (parts.scheme, parts.hostname,
                   parts.port or (443 if parts.scheme == "https" else 80))
            path = (parts.path or "/") + (f"?{parts.query}" if parts.query
                                          else "")
            while True:
                conn, reused = self._checkout(key)
                try:
                    call.attach(conn)
                    if reused:
                        conn.sock.settimeout(self._wait_budget(deadline))
                    conn.request(method, path, headers=headers)
                    conn.sock.settimeout(self._wait_budget(deadline))
                    resp = conn.getresponse()
                    break
                except ConnectionError:
                    conn.close()
                    if not reused or call.stopped:
                        raise
                except BaseException:
                    conn.close()
                    raise
                finally:
                    call.detach(conn)
            ex = _Exchange(key, conn, resp, url, deadline)
            location = resp.getheader("Location")
            if resp.status not in _REDIRECTS or not location:
                return ex
            conn.close()
            url = urljoin(url, location)
            if resp.status == 303:
                method = "GET"
        raise SourceError(f"origin {url}: too many redirects",
                          Code.BackToSourceAborted)

    def _read(self, call: WorkerCall, ex: _Exchange, amt: int | None) -> bytes:
        """Up to ``amt`` body bytes (None: the rest); b"" at the end. A
        body cut before its declared length raises IncompleteRead."""
        call.attach(ex.conn)
        try:
            if ex.conn.sock is not None:
                ex.conn.sock.settimeout(self._wait_budget(ex.deadline))
            data = ex.resp.read(amt)
            if not data and ex.resp.length:
                raise http.client.IncompleteRead(b"", ex.resp.length)
            return data
        finally:
            call.detach(ex.conn)

    @staticmethod
    def _check_encoding(ex: _Exchange) -> None:
        enc = (ex.resp.getheader("Content-Encoding") or "identity").lower()
        if enc != "identity":
            ex.conn.close()
            raise SourceError(
                f"origin {ex.url}: unsupported Content-Encoding {enc!r}",
                Code.UnsupportedProtocol)

    # -- the protocol --------------------------------------------------------

    def _open(self, call: WorkerCall, request: Request) -> _Exchange:
        try:
            ex = self._exchange(call, "GET", request.url,
                                dict(request.header), request.timeout)
        except (OSError, http.client.HTTPException) as e:
            raise _transport_error(e, request.url, "connect") from e
        if ex.resp.status >= 400:
            ex.conn.close()
            raise _status_error(ex.resp.status, request.url)
        self._check_encoding(ex)
        return ex

    def _read_chunk(self, call: WorkerCall, ex: _Exchange) -> bytes:
        try:
            return self._read(call, ex, CHUNK)
        except (OSError, http.client.HTTPException) as e:
            ex.conn.close()
            raise _transport_error(e, ex.url, "read") from e

    async def download(self, request: Request) -> Response:
        ex = await self._run(self._open, request)
        resp = ex.resp

        async def body() -> AsyncIterator[bytes]:
            while True:
                chunk = await self._run(self._read_chunk, ex)
                if not chunk:
                    return
                yield chunk

        async def close():
            self._checkin(ex)

        # content_length is the stream's length (for a 206, the range's).
        cl = resp.getheader("Content-Length")
        return Response(
            body(),
            status=resp.status,
            content_length=int(cl) if cl is not None else -1,
            headers=dict(resp.headers),
            support_range=(resp.status == 206
                           or resp.getheader("Accept-Ranges") == "bytes"),
            last_modified=resp.getheader("Last-Modified", ""),
            close=close,
        )

    def _probe(self, call: WorkerCall, request: Request) -> tuple[int, bool]:
        headers = {**request.header, "Range": "bytes=0-0"}
        try:
            ex = self._exchange(call, "GET", request.url, headers,
                                PROBE_TIMEOUT)
            resp = ex.resp
            if resp.status == 206:
                self._read(call, ex, None)   # the one byte: keep-alive
                self._checkin(ex)
                cr = resp.getheader("Content-Range", "")
                if "/" in cr:
                    total = cr.rsplit("/", 1)[1]
                    if total != "*":
                        return int(total), True
                return UNKNOWN_SOURCE_FILE_LEN, True
            ex.conn.close()       # a whole body may follow: never read it
            if resp.status == 200:
                cl = resp.getheader("Content-Length")
                if cl is not None and resp.getheader("Content-Encoding") \
                        is None:
                    return int(cl), False
                return UNKNOWN_SOURCE_FILE_LEN, False
            if resp.status >= 400:
                raise _status_error(resp.status, request.url)
        except (OSError, http.client.HTTPException) as e:
            raise _transport_error(e, request.url, "probe") from e
        return UNKNOWN_SOURCE_FILE_LEN, False

    async def probe(self, request: Request) -> tuple[int, bool]:
        """One 1-byte ranged GET answers both the content length and range
        support (HEAD is often served wrong)."""
        return await self._run(self._probe, request)

    async def get_content_length(self, request: Request) -> int:
        length, _ = await self.probe(request)
        return length

    async def is_support_range(self, request: Request) -> bool:
        _, support = await self.probe(request)
        return support

    def _last_modified(self, call: WorkerCall, request: Request) -> str:
        try:
            ex = self._exchange(call, "HEAD", request.url,
                                dict(request.header), PROBE_TIMEOUT)
            self._read(call, ex, None)
            self._checkin(ex)
            return ex.resp.getheader("Last-Modified", "")
        except (OSError, http.client.HTTPException):
            return ""

    async def get_last_modified(self, request: Request) -> str:
        return await self._run(self._last_modified, request)

    def _page(self, call: WorkerCall, request: Request) -> str:
        try:
            ex = self._exchange(call, "GET", request.url,
                                dict(request.header), LIST_TIMEOUT)
            if ex.resp.status >= 400:
                ex.conn.close()
                raise _status_error(ex.resp.status, request.url)
            self._check_encoding(ex)
            raw = self._read(call, ex, None)
            self._checkin(ex)
        except (OSError, http.client.HTTPException) as e:
            raise _transport_error(e, request.url, "list") from e
        charset = ex.resp.headers.get_content_charset() or "utf-8"
        return raw.decode(charset, "replace")

    async def list_metadata(self, request: Request) -> list[ListEntry]:
        """The hrefs of an HTML index page, below the request's path (a
        recursive download's listing)."""
        text = await self._run(self._page, request)

        class _HrefParser(html.parser.HTMLParser):
            def __init__(self):
                super().__init__()
                self.hrefs: list[str] = []

            def handle_starttag(self, tag, attrs):
                if tag == "a":
                    for k, v in attrs:
                        if k == "href" and v and not v.startswith(
                                ("?", "#", "../")):
                            self.hrefs.append(v)

        p = _HrefParser()
        p.feed(text)
        base = request.url if request.url.endswith("/") else request.url + "/"
        entries = []
        for href in p.hrefs:
            absolute = urljoin(base, href)
            if not absolute.startswith(base):   # only descend
                continue
            name = urlsplit(absolute).path.rstrip("/").rsplit("/", 1)[-1]
            entries.append(ListEntry(url=absolute, name=name,
                                     is_dir=absolute.endswith("/")))
        return entries
