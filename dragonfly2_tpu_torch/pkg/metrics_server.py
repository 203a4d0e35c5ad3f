"""The daemon's metrics endpoint: the port's copy of the ``/metrics`` and
``/healthy`` routes of ``dragonfly2_tpu/pkg/metrics_server.py``, on
``http.server`` (``pkg/httpserver.py``, threads named ``df-metrics``).

``GET /metrics`` is ``pkg/metrics.render()``, the Prometheus text format
of the port's own registry; ``GET /healthy`` is ``{"ok": true}``. The JAX
server's ``/debug/*`` routes (stacks, tasks, profiles, flights, pod
timelines, SLOs, the runtime observatory, fleet and cluster views) are
not ported.
"""

from __future__ import annotations

import asyncio
from http.server import BaseHTTPRequestHandler

from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.httpserver import ThreadedServer

log = dflog.get("metrics_server")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, *metrics.render())
        elif path == "/healthy":
            self._send(200, b'{"ok": true}', "application/json; charset=utf-8")
        else:
            self._send(404, b"404: Not Found", "text/plain; charset=utf-8")

    do_HEAD = do_GET


class MetricsServer:
    ROUTES = ("/metrics", "/healthy")

    def __init__(self):
        self._server: ThreadedServer | None = None

    async def serve(self, host: str, port: int) -> int:
        self._server = ThreadedServer((host, port), _Handler, "metrics")
        port = self._server.start()
        log.info("metrics server up", port=port)
        return port

    @property
    def port(self) -> int:
        return self._server.port if self._server is not None else 0

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            await asyncio.to_thread(server.close)
