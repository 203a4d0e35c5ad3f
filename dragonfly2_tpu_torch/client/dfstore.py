"""Dfstore: the HTTP client of the daemon's object-storage gateway,
standard library only.

The port's copy of ``dragonfly2_tpu/client/dfstore.py``: the same
methods, signatures, routes, query strings and headers, the same status
checks and error texts. The JAX client rides ``aiohttp``, which the card
machine does not have, so this one speaks the same HTTP/1.1 through
``http.client``:

- Requests run on the client's own worker threads
  (``ThreadPoolExecutor``, ``df-dfstore-*``), each with one keep-alive
  connection of its own (``http.client`` connections are not
  thread-safe). A stream holds a connection of its own while it lasts.
- ``timeout`` bounds one request from its send to the end of its body;
  ``read_timeout`` bounds each socket wait of a streamed read (the
  streams and ranged reads have no total bound, as in the JAX client's
  ``stream_timeout``). 0 means unbounded.
- A cancelled call does not return until its worker has stopped: the
  caller's buffer (``read_object_range(buf=)``) is not written after
  the cancel propagates, so the dataset plane's pooled span buffers can
  be released in the caller's ``finally``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import AsyncIterator
from urllib.parse import quote, urlencode, urlsplit

from dragonfly2_tpu_torch.pkg.bufpool import WorkerCall, await_worker

# Bytes a streamed read hands out at a time (the JAX client's
# ``iter_chunked(1 << 20)``). Each chunk is exactly this long but the last.
STREAM_CHUNK = 1 << 20
# Worker threads (and so kept-alive connections) of one client.
WORKERS = 32

# How a kept-alive connection that the server (or a cancel) has cut shows
# when it is used again; the card machine's network stack reports a cut
# socket as ECONNABORTED where Linux says EPIPE or ECONNRESET.
_STALE = ConnectionError


class DfstoreError(Exception):
    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


@dataclass
class ObjectInfo:
    key: str
    content_length: int = -1
    content_type: str = ""
    etag: str = ""
    digest: str = ""


def _text(raw: bytes) -> str:
    return raw.decode("utf-8", "replace")


class Dfstore:
    """Async client; endpoint is the daemon gateway, e.g.
    ``http://127.0.0.1:65004``."""

    def __init__(self, endpoint: str, *, timeout: float = 60.0,
                 read_timeout: float = 60.0):
        self.endpoint = endpoint.rstrip("/")
        parts = urlsplit(self.endpoint)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"bad gateway endpoint {endpoint!r}")
        self._host = parts.hostname
        self._port = parts.port
        self._base = parts.path
        self.timeout = timeout or None
        self.read_timeout = read_timeout or None
        self._mu = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._local = threading.local()
        self._conns: set[http.client.HTTPConnection] = set()

    # -- transport -----------------------------------------------------------

    def _executor(self) -> ThreadPoolExecutor:
        with self._mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=WORKERS, thread_name_prefix="df-dfstore")
            return self._pool

    def _new_conn(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self._host, self._port)
        with self._mu:
            self._conns.add(conn)
        return conn

    def _drop_conn(self, conn) -> None:
        conn.close()
        with self._mu:
            self._conns.discard(conn)

    def _thread_conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = self._new_conn()
        return conn

    async def _run(self, fn, *args):
        """``fn(call, *args)`` on a worker; a cancel cuts its connections
        and waits for it to stop."""
        call = WorkerCall()
        fut = self._executor().submit(fn, call, *args)
        return await await_worker(fut, call.abort)

    @staticmethod
    def _send(conn, call: WorkerCall, method: str, path: str, headers: dict,
              body, timeout):
        """Send one request and read its status line and headers:
        ``(resp, sock)``, each socket wait bounded by ``timeout``. A
        kept-alive connection the server has closed meanwhile is opened
        again once, for a body that can be sent twice."""
        resendable = body is None or isinstance(body, (bytes, bytearray,
                                                       memoryview))
        while True:
            reused = conn.sock is not None
            conn.timeout = timeout
            try:
                if reused:
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=body, headers=headers)
                sock = conn.sock
                call.check()
                return conn.getresponse(), sock
            except _STALE:
                conn.close()
                if not (reused and resendable) or call.stopped:
                    raise

    @staticmethod
    def _read_body(resp, sock, t_end: float | None) -> bytes:
        """The whole body, each socket wait bounded by what is left until
        ``t_end``."""
        parts = []
        while True:
            if t_end is not None:
                left = t_end - time.monotonic()
                if left <= 0:
                    raise TimeoutError("request timed out")
                sock.settimeout(left)
            chunk = resp.read(STREAM_CHUNK)
            if not chunk:
                if resp.length:
                    raise http.client.IncompleteRead(b"".join(parts),
                                                     resp.length)
                return b"".join(parts)
            parts.append(chunk)

    def _roundtrip(self, call: WorkerCall, method: str, path: str,
                   headers: dict, body):
        """One request on this worker's connection, bounded by
        ``timeout``: ``(status, headers, body bytes)``. The body is read
        to its end, so the connection stays alive."""
        conn = self._thread_conn()
        call.attach(conn)
        try:
            t_end = None if self.timeout is None else (
                time.monotonic() + self.timeout)
            resp, sock = self._send(conn, call, method, path, headers, body,
                                    self.timeout)
            return resp.status, resp.headers, self._read_body(resp, sock,
                                                              t_end)
        except BaseException:
            conn.close()
            raise
        finally:
            call.detach(conn)

    async def _request(self, method: str, path: str, *, headers=None,
                       body=None):
        return await self._run(self._roundtrip, method, path,
                               dict(headers or {}), body)

    async def close(self) -> None:
        with self._mu:
            pool, self._pool = self._pool, None
            conns, self._conns = self._conns, set()
        if pool is not None:
            pool.shutdown(wait=False)
        for conn in conns:
            conn.close()

    def _bucket_path(self, bucket: str) -> str:
        return f"{self._base}/buckets/{quote(bucket, safe='')}"

    def _object_path(self, bucket: str, key: str) -> str:
        return self._bucket_path(bucket) + f"/objects/{quote(key)}"

    # -- buckets -------------------------------------------------------------

    async def create_bucket(self, bucket: str) -> None:
        status, _, raw = await self._request("PUT", self._bucket_path(bucket))
        if status not in (200, 201):
            raise DfstoreError(_text(raw), status)

    async def delete_bucket(self, bucket: str) -> None:
        status, _, raw = await self._request("DELETE",
                                             self._bucket_path(bucket))
        if status != 200:
            raise DfstoreError(_text(raw), status)

    async def list_buckets(self) -> list[str]:
        status, _, raw = await self._request("GET", self._base + "/buckets")
        if status != 200:
            raise DfstoreError(_text(raw), status)
        return [b["name"] for b in json.loads(raw)]

    # -- objects -------------------------------------------------------------

    async def put_object(self, bucket: str, key: str, data: bytes,
                         *, mode: str = "async_write_back") -> str:
        """Returns the stored sha256 digest string."""
        path = self._object_path(bucket, key) + f"?mode={mode}"
        status, _, raw = await self._request(
            "PUT", path, body=data,
            headers={"Content-Type": "application/octet-stream"})
        if status != 200:
            raise DfstoreError(_text(raw), status)
        return json.loads(raw).get("digest", "")

    async def get_object(self, bucket: str, key: str,
                         range_header: str = "") -> bytes:
        headers = {"Range": range_header} if range_header else {}
        status, _, raw = await self._request(
            "GET", self._object_path(bucket, key), headers=headers)
        if status not in (200, 206):
            raise DfstoreError(_text(raw), status)
        return raw

    def _open_stream(self, call: WorkerCall, path: str, headers: dict):
        """A GET on a connection of the stream's own, its status and
        headers read: ``(conn, resp)``."""
        conn = self._new_conn()
        call.attach(conn)
        try:
            resp, _ = self._send(conn, call, "GET", path, headers, None,
                                 self.read_timeout)
            if resp.status not in (200, 206):
                raise DfstoreError(_text(resp.read()), resp.status)
            return conn, resp
        except BaseException:
            self._drop_conn(conn)
            raise
        finally:
            call.detach(conn)

    @staticmethod
    def _read_chunk(call: WorkerCall, conn, resp) -> bytes:
        call.attach(conn)
        try:
            chunk = resp.read(STREAM_CHUNK)
            if not chunk and resp.length:
                raise http.client.IncompleteRead(b"", resp.length)
            return chunk
        finally:
            call.detach(conn)

    async def stream_object(self, bucket: str, key: str,
                            range_header: str = "") -> AsyncIterator[bytes]:
        """Streaming GET (webdataset tar shards, delta manifests).
        ``range_header`` ("a-b" or "bytes=a-b") streams just that span.
        Each socket wait is bounded by ``read_timeout``, the whole stream
        by nothing: a cold multi-GB shard must not die mid-stream.
        Chunks are ``STREAM_CHUNK`` bytes but the last."""
        headers = {}
        if range_header:
            v = range_header.strip()
            headers["Range"] = v if v.startswith("bytes=") else f"bytes={v}"
        conn, resp = await self._run(self._open_stream,
                                     self._object_path(bucket, key), headers)

        async def chunks() -> AsyncIterator[bytes]:
            try:
                while True:
                    chunk = await self._run(self._read_chunk, conn, resp)
                    if not chunk:
                        return
                    yield chunk
            finally:
                self._drop_conn(conn)

        return chunks()

    def _read_range(self, call: WorkerCall, path: str, headers: dict,
                    start: int, end: int, buf):
        n = end - start
        conn = self._thread_conn()
        call.attach(conn)
        try:
            resp, _ = self._send(conn, call, "GET", path, headers, None,
                                 self.read_timeout)
            if resp.status not in (200, 206):
                raise DfstoreError(_text(resp.read()), resp.status)
            attrs = {
                "from_reuse": resp.getheader("X-Dragonfly-From-Reuse") == "1",
                "task_id": resp.getheader("X-Dragonfly-Task-Id", ""),
            }
            if buf is None:
                data = resp.read()
                if len(data) != n:
                    raise DfstoreError(
                        f"range [{start}, {end}) returned {len(data)}B")
                return attrs, data
            view = memoryview(buf).cast("B")
            filled = 0
            while filled < n:
                call.check()
                got = resp.readinto(view[filled:min(n, filled + STREAM_CHUNK)])
                if not got:
                    break
                filled += got
            if filled == n:
                extra = resp.read(STREAM_CHUNK)
                if extra:
                    raise DfstoreError(
                        f"range [{start}, {end}) over-delivered "
                        f"({filled + len(extra)}B)")
            if filled != n:
                raise DfstoreError(
                    f"range [{start}, {end}) returned {filled}B")
            return attrs, None
        except BaseException:
            conn.close()
            raise
        finally:
            call.detach(conn)

    async def read_object_range(self, bucket: str, key: str, start: int,
                                end: int, *, ranged_task: bool = True,
                                buf: "memoryview | bytearray | None" = None):
        """Read the half-open byte span ``[start, end)``.

        With ``ranged_task`` (default) the daemon serves it as a dedicated
        RANGED P2P task (`?ranged_task=1`): on a cold cache only the
        span's bytes are fetched from origin, and every host reading the
        same span shares one task identity (the dataset plane's
        sample-read primitive). Without it, the span rides a plain ranged
        GET over the whole-object stream task.

        Returns ``(attrs, data)``; with ``buf`` given the bytes are
        written in place and data is None. attrs: {"from_reuse", "task_id"}.
        A cancelled call writes nothing into ``buf`` after it returns.
        """
        n = end - start
        if n <= 0:
            raise ValueError(f"empty range [{start}, {end})")
        if buf is not None and len(buf) < n:
            raise ValueError(f"buffer {len(buf)}B < span {n}B")
        path = self._object_path(bucket, key)
        if ranged_task:
            path += "?ranged_task=1"
        headers = {"Range": f"bytes={start}-{end - 1}"}
        return await self._run(self._read_range, path, headers, start, end,
                               buf)

    async def stat_object(self, bucket: str, key: str) -> ObjectInfo:
        status, headers, _ = await self._request(
            "HEAD", self._object_path(bucket, key))
        if status != 200:
            raise DfstoreError(f"object {bucket}/{key}: HTTP {status}", status)
        return ObjectInfo(
            key=key,
            content_length=int(headers.get("Content-Length", -1)),
            content_type=headers.get("Content-Type", ""),
            etag=headers.get("ETag", ""),
            digest=headers.get("X-Dragonfly-Digest", ""))

    async def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            await self.stat_object(bucket, key)
            return True
        except DfstoreError:
            return False

    async def delete_object(self, bucket: str, key: str) -> None:
        status, _, raw = await self._request(
            "DELETE", self._object_path(bucket, key))
        if status != 200:
            raise DfstoreError(_text(raw), status)

    def _copy(self, call: WorkerCall, src_path: str, dst_path: str):
        src, resp = self._open_stream(call, src_path, {})

        def body():
            while True:
                chunk = self._read_chunk(call, src, resp)
                if not chunk:
                    return
                yield chunk

        conn = self._thread_conn()
        call.attach(conn)
        try:
            put, _ = self._send(conn, call, "PUT", dst_path,
                                {"Content-Type": "application/octet-stream"},
                                body(), self.read_timeout)
            return put.status, put.read()
        except BaseException:
            conn.close()
            raise
        finally:
            call.detach(conn)
            self._drop_conn(src)

    async def copy_object(self, bucket: str, src_key: str, dst_key: str,
                          *, mode: str = "async_write_back") -> str:
        """Streaming copy (GET + chunked PUT): the source streams
        chunk by chunk into the PUT, so a multi-GB shard copy holds one
        chunk in memory, not the object. Returns the stored digest."""
        dst = self._object_path(bucket, dst_key) + f"?mode={mode}"
        status, raw = await self._run(
            self._copy, self._object_path(bucket, src_key), dst)
        if status != 200:
            raise DfstoreError(_text(raw), status)
        return json.loads(raw).get("digest", "")

    async def prefetch_object(self, bucket: str, key: str,
                              device: str = "",
                              range_header: str = "") -> dict:
        """Warm the daemon's stores with an object without downloading it
        here: piece store always, and with device="tpu" the daemon also
        lands verified pieces in its device sink. ``range_header`` ("a-b")
        warms just that span as a ranged task. Returns {state, task_id,
        content_length, device_verified, ...}."""
        path = self._bucket_path(bucket) + f"/prefetch/{quote(key, safe='/')}"
        params = {}
        if device:
            params["device"] = device
        if range_header:
            params["range"] = range_header
        if params:
            path += "?" + urlencode(params)
        status, _, raw = await self._request(
            "POST", path)
        if status != 200:
            raise DfstoreError(_text(raw), status)
        return json.loads(raw)

    async def list_objects(self, bucket: str, prefix: str = "",
                           limit: int = 1000) -> list[ObjectInfo]:
        path = (self._bucket_path(bucket)
                + f"/metadatas?prefix={quote(prefix, safe='')}&limit={limit}")
        status, _, raw = await self._request(
            "GET", path)
        if status != 200:
            raise DfstoreError(_text(raw), status)
        metas = json.loads(raw)["metadatas"]
        return [ObjectInfo(key=m["key"], content_length=m["content_length"],
                           content_type=m.get("content_type", ""),
                           etag=m.get("etag", ""), digest=m.get("digest", ""))
                for m in metas]
