"""The upload server other peers pull piece payloads from: the port's copy
of ``dragonfly2_tpu/daemon/upload.py``, on ``http.server`` (the JAX one is
an ``aiohttp.web`` application, and the card machine has no ``aiohttp``).

Routes, queries, statuses and headers are the JAX server's:

  GET /download/{task_prefix}/{task_id}?peerId=...            Range: bytes=a-b
  GET /download/{task_prefix}/{task_id}?peerId=...&pieceNum=N (a whole piece)
  GET /healthy, GET /metrics

- An unknown task is 404; over the concurrency limit 429; a ``pieceNum``
  that is not an integer 400, one not landed 404; no ``pieceNum`` and no
  ``Range`` 400, an unparsable ``Range`` 400, one the store does not hold
  416.
- A payload is 206 with ``Content-Range: bytes a-b/{total}``, where the
  total is the task's content length even while the store is still
  downloading (its data file is then shorter than the content).
- The bytes go from the store's data file to the socket by
  ``os.sendfile``; the store is pinned while it is served, so the
  storage GC cannot remove it mid-send.
- ``rate_limit`` (bytes/s, 0 = none) is one token bucket the serving
  threads share; ``concurrent_limit`` (0 = none) counts requests in
  flight. Metric families: ``upload_bytes_total``,
  ``upload_requests_total{result}``, ``upload_concurrency``.

Each payload served stamps the task's flight on this daemon
(``pkg/flight.for_task``): ``EV_UPLOAD_SERVE`` with the piece number (-1
for a range) and the bytes.

HTTP/1.1 with keep-alive on ``pkg/httpserver.py``: one ``df-upload``
thread a connection, and ``close`` waits for them. The
``tenant`` query is accepted and not accounted (the QoS plane is not
ported). Not ported either: the native upload server and TLS.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlsplit

from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg.httpserver import ThreadedServer
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.pkg.ratelimit import BlockingLimiter

log = dflog.get("daemon.upload")

UPLOAD_BYTES = metrics.counter("upload_bytes_total",
                               "Piece bytes served to other peers")
UPLOAD_REQUESTS = metrics.counter("upload_requests_total",
                                  "Piece upload requests", ("result",))
CONCURRENT_UPLOADS = metrics.gauge("upload_concurrency",
                                   "In-flight piece uploads")


class _Reply(Exception):
    """An error answer: the status and its text body."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parts = urlsplit(self.path)
        route = parts.path.split("/")
        mgr = self.server.manager
        try:
            if parts.path == "/healthy":
                self._send(200, b"ok", "text/plain; charset=utf-8")
            elif parts.path == "/metrics":
                body, ctype = metrics.render()
                self._send(200, body, ctype.split(";")[0])
            elif len(route) == 4 and route[1] == "download" and route[3]:
                mgr._serve(self, route[3], parse_qs(parts.query))
            else:
                raise _Reply(404, "404: Not Found")
        except _Reply as r:
            self._send(r.status, r.text.encode(), "text/plain; charset=utf-8")


class UploadManager:
    def __init__(self, storage, *, rate_limit: int = 0,
                 concurrent_limit: int = 0):
        self.storage = storage
        self.limiter = BlockingLimiter(rate_limit if rate_limit > 0
                                       else float("inf"))
        self.concurrent_limit = concurrent_limit
        self.concurrent = 0
        self._mu = threading.Lock()
        self._server: ThreadedServer | None = None
        self._port = 0

    def serve(self, host: str, port: int = 0) -> int:
        """Listen on ``host:port`` (0: a free port) on a thread of its own;
        returns the port."""
        self._server = ThreadedServer((host, port), _Handler, "upload")
        self._server.manager = self
        self._port = self._server.start()
        log.info("upload server up", port=self._port)
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    def _acquire(self) -> None:
        with self._mu:
            if self.concurrent_limit and self.concurrent >= self.concurrent_limit:
                UPLOAD_REQUESTS.labels("throttled").inc()
                raise _Reply(429, "429: Too Many Requests")
            self.concurrent += 1
        CONCURRENT_UPLOADS.inc()

    def _release(self) -> None:
        with self._mu:
            self.concurrent -= 1
        CONCURRENT_UPLOADS.dec()

    @staticmethod
    def _window(store, query: dict, range_header: str | None):
        """The byte window a request asks of ``store``."""
        piece_num = query.get("pieceNum", [None])[-1]
        if piece_num is not None:
            try:
                rec = store.metadata.pieces.get(int(piece_num))
            except ValueError:
                UPLOAD_REQUESTS.labels("bad_request").inc()
                raise _Reply(400, f"bad pieceNum {piece_num!r}")
            if rec is None:
                UPLOAD_REQUESTS.labels("piece_missing").inc()
                raise _Reply(404, f"piece {piece_num} not found")
            return rec.offset, rec.size
        if not range_header:
            UPLOAD_REQUESTS.labels("bad_request").inc()
            raise _Reply(400, "Range or pieceNum required")
        try:
            rng = Range.parse_http(range_header, store.metadata.content_length)
        except ValueError as e:
            UPLOAD_REQUESTS.labels("bad_request").inc()
            raise _Reply(400, str(e))
        if not store.covers_range(rng.start, rng.length):
            UPLOAD_REQUESTS.labels("piece_missing").inc()
            raise _Reply(416, "416: Range Not Satisfiable")
        return rng.start, rng.length

    def _serve(self, h: _Handler, task_id: str, query: dict) -> None:
        store = self.storage.try_get(task_id)
        if store is None:
            UPLOAD_REQUESTS.labels("not_found").inc()
            raise _Reply(404, f"task {task_id} not found")
        self._acquire()
        store.pin()
        try:
            start, length = self._window(store, query,
                                         h.headers.get("Range"))
            self.limiter.wait(length)
            fd = os.open(store.data_path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                if length <= 0 or start >= size:
                    raise _Reply(416, "416: Range Not Satisfiable")
                length = min(length, size - start)
                total = store.metadata.content_length
                UPLOAD_REQUESTS.labels("ok").inc()
                piece_num = query.get("pieceNum", [None])[-1]
                flightlib.for_task(task_id).record(
                    flightlib.EV_UPLOAD_SERVE,
                    int(piece_num) if piece_num is not None else -1,
                    float(length))
                h.send_response(206)
                h.send_header("Content-Type", "application/octet-stream")
                h.send_header("Accept-Ranges", "bytes")
                h.send_header("Content-Range",
                              f"bytes {start}-{start + length - 1}/"
                              f"{total if total >= 0 else size}")
                h.send_header("Content-Length", str(length))
                h.end_headers()
                out = h.connection.fileno()
                sent = 0
                try:
                    while sent < length:
                        n = os.sendfile(out, fd, start + sent, length - sent)
                        if n == 0:
                            raise ConnectionResetError("sendfile sent nothing")
                        sent += n
                finally:
                    # The bytes that left, not the bytes promised.
                    UPLOAD_BYTES.inc(sent)
            finally:
                os.close(fd)
        finally:
            store.unpin()
            self._release()
