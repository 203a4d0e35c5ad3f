"""The object gateway, an S3-like HTTP service on the daemon: the port's
copy of ``dragonfly2_tpu/daemon/objectstorage.py``, on ``http.server``
(``pkg/httpserver.py``; the JAX gateway is an ``aiohttp`` application, and
the card machine has no ``aiohttp``).

Routes, statuses, headers and JSON bodies are the JAX gateway's:

  GET    /healthy                                {ok, backend}
  GET    /buckets                                [{name, created_at}]
  PUT    /buckets/{bucket}                       201; 400 on a bad name
  DELETE /buckets/{bucket}                       404 when missing
  GET    /buckets/{bucket}/metadatas?prefix=&marker=&limit=
  HEAD   /buckets/{bucket}/objects/{key}         Content-Length,
                                                 X-Dragonfly-Digest, ETag
  GET    /buckets/{bucket}/objects/{key}         through a stream task
  PUT    /buckets/{bucket}/objects/{key}?mode=   {ok, digest}, replicated
  DELETE /buckets/{bucket}/objects/{key}
  POST   /buckets/{bucket}/prefetch/{key}?device=tpu&range=a-b

(GET routes answer HEAD too; an unknown path is 404, a known one asked
with another method 405 with ``Allow``.)

- A GET rides the P2P fabric: the backend's ``object_url`` (``file://``
  for ``fs``) is the stream task's origin and the bucket its tag
  (``P2PTransport.fetch``), so every gateway gives one object one task
  id. A window that ``P2PTransport.sendfile_window`` allows (a complete
  store, or landed bytes of a running one) goes from the store's data
  file to the socket by ``os.sendfile`` with the store pinned; any other
  streams from the task's body iterator. A fetch that fails is 502, a
  range past the end 416 with ``Content-Range: bytes */{total}``.
- ``?ranged_task=1`` with ``Range``: the span as a ranged file task of its
  own (a cold read fetches only the span; a warm whole-object store
  serves it locally), its store's file sent whole with
  ``X-Dragonfly-Task-Id`` and ``X-Dragonfly-From-Reuse``.
- PUT spools the body through a ``SpooledTemporaryFile`` (64 MiB in
  memory), answers its sha256 digest and replicates to the known seed
  peers (``trigger_seed``, the seeds' ``Peer.TriggerDownloadTask``), in
  the background unless ``mode=write_back``.
- The prefetch lands an object in this daemon's stores without sending
  it back; ``?device=tpu`` also lands it in the daemon's device sink on
  the card (``DeviceSinkManager``), and the answer's ``device_verified``
  says it was verified there. It runs detached from the request: a
  client that goes away does not cancel it.

Threads: one ``df-gateway`` thread a connection. A handler runs the
route's coroutine on the daemon's event loop
(``asyncio.run_coroutine_threadsafe``) and writes the answer itself;
a streamed body is pulled one chunk a call. A connection cut mid-body
closes the body iterator on the loop, which releases its store pin.

Metric families: ``objectstorage_requests_total{method,result}`` and
``objectstorage_bytes_total{direction}``, in the port's registry.

A GET adopts the caller's ``traceparent`` (``pkg/tracing``): the
``gateway.get_object`` span joins the caller's trace, as in JAX.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import os
import tempfile
import threading
from email.utils import formatdate
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, unquote, urlsplit

from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    DEVICE_SINK,
    FileTaskRequest,
)
from dragonfly2_tpu_torch.daemon.transport import P2PTransport
from dragonfly2_tpu_torch.pkg import dflog, idgen, metrics, tracing
from dragonfly2_tpu_torch.pkg import digest as pkgdigest
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.pkg.httpserver import ThreadedServer
from dragonfly2_tpu_torch.pkg.objectstorage import (
    ObjectStorage,
    ObjectStorageError,
)
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.proto.common import UrlMeta

log = dflog.get("daemon.objectstorage")

OBJ_REQUESTS = metrics.counter("objectstorage_requests_total",
                               "Object gateway requests", ("method", "result"))
OBJ_BYTES = metrics.counter("objectstorage_bytes_total",
                            "Object gateway bytes", ("direction",))

# Write-back modes of a PUT's replication.
MODE_WRITE_BACK = "write_back"            # replicate before answering
MODE_ASYNC_WRITE_BACK = "async_write_back"  # replicate in the background

SPOOL_MAX = 64 << 20
BODY_CHUNK = 1 << 20

_REASONS = {400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed",
            416: "Requested Range Not Satisfiable",
            502: "Bad Gateway"}
_OCTETS = "application/octet-stream"
_TEXT = "text/plain; charset=utf-8"
_END = object()


class _Answer:
    """A whole answer. A ``Content-Length`` in ``headers`` (a HEAD's)
    stands for the body's."""

    def __init__(self, status: int, body: bytes = b"", headers=None,
                 content_type: str | None = _TEXT):
        self.status = status
        self.body = body
        self.headers = headers or {}
        self.content_type = content_type


def _json(data, status: int = 200) -> _Answer:
    return _Answer(status, json.dumps(data).encode(),
                   content_type="application/json; charset=utf-8")


def _error(status: int, text: str = "", headers=None) -> _Answer:
    return _Answer(status, (text or f"{status}: {_REASONS[status]}").encode(),
                   headers)


class _File:
    """``count`` bytes at ``offset`` of a pinned store's data file, sent by
    ``sendfile``: 206 with ``Content-Range`` over ``total`` when ``total``
    is given, else 200. The store is unpinned once the send ends, and the
    GET counted as the JAX gateway counts it (the window's bytes, even
    for a send cut short)."""

    def __init__(self, store, offset: int, count: int,
                 total: int | None = None, headers=None):
        self.store = store
        self.offset = offset
        self.count = count
        self.total = total
        self.headers = headers or {}


class _Stream:
    """A body pulled from an async iterator on the loop, one chunk a call;
    chunked when ``headers`` has no ``Content-Length``."""

    def __init__(self, status: int, headers: dict, body):
        self.status = status
        self.headers = headers
        self.body = body


async def _next_chunk(it):
    try:
        return await anext(it)
    except StopAsyncIteration:
        return _END


async def _aclose(it) -> None:
    await it.aclose()


def _route(path: str):
    """({method: handler name}, path parameters), or None for no route."""
    if path == "/healthy":
        return {"GET": "_healthy", "HEAD": "_healthy"}, {}
    if path == "/buckets":
        return {"GET": "_list_buckets", "HEAD": "_list_buckets"}, {}
    segs = path.split("/")
    if len(segs) < 3 or segs[0] or segs[1] != "buckets" or not segs[2]:
        return None
    bucket = unquote(segs[2])
    if len(segs) == 3:
        return ({"PUT": "_create_bucket", "DELETE": "_delete_bucket"},
                {"bucket": bucket})
    if len(segs) == 4 and segs[3] == "metadatas":
        return ({"GET": "_list_metadatas", "HEAD": "_list_metadatas"},
                {"bucket": bucket})
    if len(segs) >= 5 and segs[3] in ("objects", "prefetch"):
        params = {"bucket": bucket, "key": unquote("/".join(segs[4:]))}
        if segs[3] == "prefetch":
            return {"POST": "_prefetch_object"}, params
        return ({"HEAD": "_head_object", "GET": "_get_object",
                 "PUT": "_put_object", "DELETE": "_delete_object"}, params)
    return None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def _dispatch(self):
        svc = self.server.service
        self._body_left = self._content_length()
        parts = urlsplit(self.path)
        query = {k: v[0] for k, v in parse_qs(parts.query).items()}
        route = _route(parts.path)
        try:
            if route is None:
                answer = _error(404)
            else:
                methods, params = route
                name = methods.get(self.command)
                if name is None:
                    answer = _error(405, headers={
                        "Allow": ",".join(sorted(methods))})
                elif name == "_put_object":
                    answer = svc._put_object(self, query, **params)
                else:
                    answer = svc._call(getattr(svc, name)(
                        self.headers, query, **params))
        except concurrent.futures.CancelledError:
            self.close_connection = True   # the gateway is closing
            return
        except Exception:
            log.error("gateway handler failed", path=self.path,
                      exc_info=True)
            answer = _Answer(500, b"500 Internal Server Error\n\n"
                             b"Server got itself in trouble")
        if self._body_left:
            # An unread request body would be taken for the next request.
            self.close_connection = True
        try:
            if isinstance(answer, _File):
                self._send_file(answer)
            elif isinstance(answer, _Stream):
                self._send_stream(svc, answer)
            else:
                self._send_answer(answer)
        except concurrent.futures.CancelledError:
            self.close_connection = True   # the gateway closed mid-body

    do_GET = do_HEAD = do_PUT = do_DELETE = do_POST = do_PATCH = _dispatch
    do_OPTIONS = _dispatch

    # -- the request body --------------------------------------------------

    def _content_length(self) -> int:
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            return -1
        return int(self.headers.get("Content-Length") or 0)

    def body_chunks(self):
        """The request body, in chunks of at most BODY_CHUNK bytes."""
        if self._body_left < 0:
            while True:
                size = int(self.rfile.readline().split(b";")[0], 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    break
                left = size
                while left:
                    chunk = self.rfile.read(min(BODY_CHUNK, left))
                    if not chunk:
                        raise ConnectionResetError("request body cut")
                    left -= len(chunk)
                    yield chunk
                self.rfile.readline()
            self._body_left = 0
            return
        while self._body_left > 0:
            chunk = self.rfile.read(min(BODY_CHUNK, self._body_left))
            if not chunk:
                raise ConnectionResetError("request body cut")
            self._body_left -= len(chunk)
            yield chunk

    @property
    def content_type(self) -> str:
        """The body's media type, ``application/octet-stream`` by default
        (aiohttp's ``request.content_type``)."""
        value = self.headers.get("Content-Type")
        if value is None:
            return _OCTETS
        return value.split(";", 1)[0].strip().lower()

    # -- writing answers ---------------------------------------------------

    def _send_answer(self, a: _Answer) -> None:
        self.send_response(a.status)
        if a.content_type is not None:
            self.send_header("Content-Type", a.content_type)
        for k, v in a.headers.items():
            self.send_header(k, v)
        if "Content-Length" not in a.headers:
            self.send_header("Content-Length", str(len(a.body)))
        self.end_headers()
        if self.command != "HEAD" and a.body:
            self.wfile.write(a.body)

    def _send_file(self, f: _File) -> None:
        sent = 0
        try:
            fd = os.open(f.store.data_path, os.O_RDONLY)
            try:
                st = os.fstat(fd)
                self.send_response(200 if f.total is None else 206)
                self.send_header("Content-Type", _OCTETS)
                self.send_header("Accept-Ranges", "bytes")
                # The validators aiohttp's FileResponse derives from the
                # data file (conditional requests are not answered).
                self.send_header("Etag",
                                 f'"{st.st_mtime_ns:x}-{st.st_size:x}"')
                self.send_header("Last-Modified",
                                 formatdate(st.st_mtime, usegmt=True))
                for k, v in f.headers.items():
                    self.send_header(k, v)
                if f.total is not None:
                    self.send_header(
                        "Content-Range",
                        f"bytes {f.offset}-{f.offset + f.count - 1}/{f.total}")
                self.send_header("Content-Length", str(f.count))
                self.end_headers()
                out = self.connection.fileno()
                while sent < f.count:
                    n = os.sendfile(out, fd, f.offset + sent, f.count - sent)
                    if n == 0:
                        raise ConnectionResetError("sendfile sent nothing")
                    sent += n
            finally:
                os.close(fd)
        finally:
            f.store.unpin()
            OBJ_BYTES.labels("out").inc(f.count)
            OBJ_REQUESTS.labels("GET", "ok").inc()

    def _send_stream(self, svc, s: _Stream) -> None:
        chunked = "Content-Length" not in s.headers
        self.send_response(s.status)
        self.send_header("Content-Type", _OCTETS)
        for k, v in s.headers.items():
            self.send_header(k, v)
        if chunked:
            self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        sent, ended = 0, False
        try:
            while True:
                chunk = svc._call(_next_chunk(s.body))
                if chunk is _END:
                    ended = True
                    break
                if chunked:
                    self.wfile.write(b"%x\r\n" % len(chunk))
                self.wfile.write(chunk)
                if chunked:
                    self.wfile.write(b"\r\n")
                sent += len(chunk)
            if chunked:
                self.wfile.write(b"0\r\n\r\n")
        finally:
            OBJ_BYTES.labels("out").inc(sent)
            if not ended:
                # A cut connection (or a closing gateway): the iterator's
                # finally releases its store pin on the loop.
                svc._release(s.body)
        OBJ_REQUESTS.labels("GET", "ok").inc()


class ObjectStorageService:
    def __init__(self, backend: ObjectStorage, transport, *,
                 get_seed_peers=None, trigger_seed=None):
        """``transport`` is the daemon's ``P2PTransport``;
        ``get_seed_peers()`` gives the seed peers ([{ip, port}]) a PUT
        replicates to; ``trigger_seed(peer, spec)`` sends one
        ``Peer.TriggerDownloadTask``."""
        self.backend = backend
        self.transport = transport
        self.get_seed_peers = get_seed_peers or (lambda: [])
        self.trigger_seed = trigger_seed
        self._server: ThreadedServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._port = 0
        self._mu = threading.Lock()
        self._closing = False
        # The handlers' calls on the loop, cancelled at close.
        self._pending: set[concurrent.futures.Future] = set()
        # Strong references to detached prefetches and replications: the
        # loop keeps only weak ones.
        self._background: set[asyncio.Future] = set()

    async def serve(self, host: str, port: int = 0) -> int:
        self._loop = asyncio.get_running_loop()
        self._server = ThreadedServer((host, port), _Handler, "gateway")
        self._server.service = self
        self._port = self._server.start()
        log.info("object storage gateway up", port=self._port,
                 backend=self.backend.name)
        return self._port

    @property
    def port(self) -> int:
        return self._port

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            with self._mu:
                self._closing = True
                pending = list(self._pending)
            for fut in pending:
                fut.cancel()
            await asyncio.to_thread(server.close)
        await self.backend.close()

    # -- handler threads onto the loop -------------------------------------

    def _call(self, coro):
        """Run ``coro`` on the daemon's loop and wait for its result (from
        a handler thread). Raises ``CancelledError`` once closing."""
        with self._mu:
            if self._closing:
                coro.close()
                raise concurrent.futures.CancelledError()
            fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
            self._pending.add(fut)
        try:
            return fut.result()
        finally:
            with self._mu:
                self._pending.discard(fut)

    def _release(self, body) -> None:
        """Close a body iterator on the loop, waiting a bounded time."""
        fut = asyncio.run_coroutine_threadsafe(_aclose(body), self._loop)
        try:
            fut.result(timeout=10.0)
        except Exception:
            log.warning("closing a cut stream failed", exc_info=True)

    def _detach(self, coro) -> asyncio.Future:
        fut = asyncio.ensure_future(coro)
        self._background.add(fut)
        fut.add_done_callback(self._background.discard)
        return fut

    # -- buckets -----------------------------------------------------------

    async def _healthy(self, headers, query) -> _Answer:
        return _json({"ok": True, "backend": self.backend.name})

    async def _list_buckets(self, headers, query) -> _Answer:
        try:
            buckets = await self.backend.list_buckets()
        except ObjectStorageError as e:
            return _error(502, str(e))
        return _json([{"name": b.name, "created_at": b.created_at}
                      for b in buckets])

    async def _create_bucket(self, headers, query, bucket: str) -> _Answer:
        try:
            await self.backend.create_bucket(bucket)
        except ObjectStorageError as e:
            return _error(400, str(e))
        return _json({"ok": True}, status=201)

    async def _delete_bucket(self, headers, query, bucket: str) -> _Answer:
        try:
            await self.backend.delete_bucket(bucket)
        except ObjectStorageError as e:
            return _error(404, str(e))
        return _json({"ok": True})

    async def _list_metadatas(self, headers, query, bucket: str) -> _Answer:
        try:
            metas = await self.backend.list_object_metadatas(
                bucket, prefix=query.get("prefix", ""),
                marker=query.get("marker", ""),
                limit=int(query.get("limit", 1000)))
        except ObjectStorageError as e:
            return _error(404, str(e))
        return _json({"metadatas": [{
            "key": m.key, "content_length": m.content_length,
            "content_type": m.content_type, "etag": m.etag,
            "digest": m.digest} for m in metas]})

    # -- objects -----------------------------------------------------------

    async def _head_object(self, headers, query, bucket: str,
                           key: str) -> _Answer:
        try:
            meta = await self.backend.get_object_metadata(bucket, key)
        except ObjectStorageError:
            return _error(404)
        out = {"Content-Length": str(max(meta.content_length, 0)),
               "X-Dragonfly-Digest": meta.digest, "ETag": meta.etag or ""}
        return _Answer(200, headers=out,
                       content_type=meta.content_type or None)

    async def _prefetch_object(self, headers, query, bucket: str,
                               key: str) -> _Answer:
        """Land an object in this daemon's stores without sending it back;
        ``device=tpu`` also lands it in the device sink. A whole-object
        prefetch has the task id of the gateway's GETs (url, tag=bucket),
        so later GETs hit it; ``range=a-b`` warms that span's ranged task
        instead."""
        device = query.get("device", "")
        if device not in ("", DEVICE_SINK):
            return _error(400, f"unknown device {device!r}")
        rng = ""
        if query.get("range"):
            try:
                rng = Range.normalize_header(query["range"])
            except ValueError as e:
                return _error(400, f"bad range {query['range']!r}: {e}")
        url = self.backend.object_url(bucket, key)
        req = FileTaskRequest(url=url, output="",
                              meta=UrlMeta(tag=bucket, range=rng),
                              device=device)
        if rng:
            req.range = Range.parse_http(rng)

        async def run_prefetch():
            final = None
            async for p in self.transport.task_manager.start_file_task(req):
                final = p
            return final

        # Detached from the request: a client's timeout or disconnect must
        # not cancel the download (a cancel invalidates the warmed store).
        fut = self._detach(run_prefetch())
        try:
            final = await asyncio.shield(fut)
        except asyncio.CancelledError:
            fut.add_done_callback(
                lambda f: f.exception() if not f.cancelled() else None)
            raise
        except DfError as e:
            OBJ_REQUESTS.labels("PREFETCH", "error").inc()
            return _error(502, f"prefetch failed: {e}")
        if final is None or final.state != "done":
            OBJ_REQUESTS.labels("PREFETCH", "error").inc()
            err = (final.error or {}) if final is not None else {}
            return _error(
                502, f"prefetch failed: {err.get('message', 'no result')}")
        OBJ_REQUESTS.labels("PREFETCH", "ok").inc()
        return _json({
            "state": final.state,
            "task_id": final.task_id,
            "content_length": final.content_length,
            "from_reuse": final.from_reuse,
            "from_p2p": final.from_p2p,
            "device_verified": final.device_verified,
        })

    async def _get_object_ranged_task(self, bucket: str, key: str,
                                      rng_header: str):
        """The span as a ranged file task of its own, its store's data
        file (exactly the span) sent whole."""
        try:
            rng = Range.normalize_header(rng_header)
        except ValueError as e:
            return _error(400, f"bad range {rng_header!r}: {e}")
        url = self.backend.object_url(bucket, key)
        req = FileTaskRequest(url=url, output="",
                              meta=UrlMeta(tag=bucket, range=rng))
        req.range = Range.parse_http(rng)
        final = None
        try:
            async for p in self.transport.task_manager.start_file_task(req):
                if p.state == "failed":
                    raise DfError.from_wire(p.error or {})
                final = p
        except DfError as e:
            OBJ_REQUESTS.labels("GET", "error").inc()
            return _error(502, f"ranged task failed: {e}")
        if final is None or final.state != "done":
            OBJ_REQUESTS.labels("GET", "error").inc()
            return _error(502, "ranged task ended without result")
        store = self.transport.task_manager.storage.find_completed_task(
            final.task_id)
        if store is None:
            OBJ_REQUESTS.labels("GET", "error").inc()
            return _error(502, "ranged task store missing")
        count = store.metadata.content_length
        store.pin()
        return _File(store, 0, count, headers={
            "X-Dragonfly-Task-Id": final.task_id,
            "X-Dragonfly-From-Reuse": "1" if final.from_reuse else "0"})

    async def _get_object(self, headers, query, bucket: str, key: str):
        """A GET through the P2P fabric: a stream task, served by sendfile
        off its store when the window allows, else streamed. The caller's
        trace context is adopted: the gateway hop joins its trace."""
        tp = headers.get(tracing.TRACEPARENT, "")
        with tracing.extract({tracing.TRACEPARENT: tp} if tp else None,
                             "gateway.get_object", bucket=bucket):
            return await self._get_object_inner(headers, query, bucket, key)

    async def _get_object_inner(self, headers, query, bucket: str,
                                key: str):
        url = self.backend.object_url(bucket, key)
        fetch_headers = {"X-Dragonfly-Tag": bucket}
        rng_header = headers.get("Range", "")
        if rng_header and query.get("ranged_task"):
            return await self._get_object_ranged_task(bucket, key,
                                                      rng_header)
        if rng_header:
            fetch_headers["Range"] = rng_header
        try:
            attrs, body_iter = await self.transport.fetch(url, fetch_headers)
        except (DfError, ValueError) as e:
            OBJ_REQUESTS.labels("GET", "error").inc()
            return _error(502, f"p2p fetch failed: {e}")
        rng = attrs.get("range")
        total = attrs.get("content_length", -1)
        window = P2PTransport.sendfile_window(attrs, rng, total)
        if window is not None:
            await body_iter.aclose()  # not started: it holds no pin yet
            store, offset, count = window
            store.pin()
            return _File(store, offset, count,
                         total=None if rng is None else total)
        if rng is not None and total < 0:
            # A range of an origin of unknown length: satisfiable once it
            # resolved, streamed with an unknown total.
            return _Stream(206, {"Content-Range": f"bytes {rng.start}-"
                                 f"{rng.start + rng.length - 1}/*"},
                           body_iter)
        if rng is not None:
            resp_len = min(rng.length, max(total - rng.start, 0))
            if resp_len <= 0:
                await body_iter.aclose()
                return _error(416, headers={
                    "Content-Range": f"bytes */{total}"})
            return _Stream(206, {
                "Content-Range":
                    f"bytes {rng.start}-{rng.start + resp_len - 1}/{total}",
                "Content-Length": str(resp_len)}, body_iter)
        if total >= 0:
            return _Stream(200, {"Content-Length": str(total)}, body_iter)
        return _Stream(200, {}, body_iter)

    def _put_object(self, h: _Handler, query: dict, bucket: str,
                    key: str) -> _Answer:
        """PUT (on the handler thread): the body spooled and hashed, then
        handed to the backend on the loop, then replicated to the seed
        peers."""
        mode = query.get("mode", MODE_ASYNC_WRITE_BACK)
        hasher = pkgdigest.new_hasher(pkgdigest.ALGORITHM_SHA256)
        size = 0
        with tempfile.SpooledTemporaryFile(max_size=SPOOL_MAX) as spool:
            for chunk in h.body_chunks():
                hasher.update(chunk)
                spool.write(chunk)
                size += len(chunk)
            spool.seek(0)
            digest = f"{pkgdigest.ALGORITHM_SHA256}:{hasher.hexdigest()}"
            try:
                self._call(self.backend.put_object(
                    bucket, key, spool, digest=digest,
                    content_type=h.content_type))
            except ObjectStorageError as e:
                OBJ_REQUESTS.labels("PUT", "error").inc()
                return _error(502, str(e))
        OBJ_BYTES.labels("in").inc(size)
        OBJ_REQUESTS.labels("PUT", "ok").inc()
        self._call(self._replicate(bucket, key, digest,
                                   wait=mode == MODE_WRITE_BACK))
        return _json({"ok": True, "digest": digest})

    async def _replicate(self, bucket: str, key: str, digest: str, *,
                         wait: bool) -> None:
        replication = self._replicate_to_seeds(bucket, key, digest)
        if wait:
            await replication
        else:
            self._detach(replication)

    async def _replicate_to_seeds(self, bucket: str, key: str,
                                  digest: str) -> None:
        """Ask every known seed peer to prefetch the object's origin URL,
        under the task id a gateway GET gives it (url, tag=bucket, no
        digest), so the replicas serve GETs; the digest rides along for
        the seed's whole-content check."""
        if self.trigger_seed is None:
            return
        seeds = list(self.get_seed_peers() or [])
        if not seeds:
            return
        url = self.backend.object_url(bucket, key)
        task_id = idgen.task_id_v1(url, tag=bucket)
        spec = {"task_id": task_id, "url": url, "tag": bucket,
                "digest": digest}
        results = await asyncio.gather(
            *(self.trigger_seed(s, spec) for s in seeds),
            return_exceptions=True)
        ok = sum(1 for r in results if r is True)
        log.info("object replicated to seeds", bucket=bucket, key=key,
                 ok=ok, total=len(seeds))

    async def _delete_object(self, headers, query, bucket: str,
                             key: str) -> _Answer:
        try:
            await self.backend.delete_object(bucket, key)
        except ObjectStorageError as e:
            return _error(404, str(e))
        OBJ_REQUESTS.labels("DELETE", "ok").inc()
        return _json({"ok": True})
