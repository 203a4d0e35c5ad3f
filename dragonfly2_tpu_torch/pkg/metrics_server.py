"""The daemon's metrics endpoint: the port's copy of the ``/metrics`` and
``/healthy`` routes of ``dragonfly2_tpu/pkg/metrics_server.py``, on
``http.server`` (``pkg/httpserver.py``, threads named ``df-metrics``).

``GET /metrics`` is ``pkg/metrics.render()``, the Prometheus text format
of the port's own registry; ``GET /healthy`` is ``{"ok": true}``. A
server given a fleet observatory (``pkg/fleet.py``; the scheduler's)
also serves the JAX server's fleet family with its query parameters,
bodies and statuses: ``/debug/fleet`` (``?window=``), ``/debug/fleet/
hosts`` (``?n=``), ``/debug/fleet/decisions`` (``?host= &task= &kind=
&n= &since= &before=``) and ``/debug/fleet/info``; without one they are
404. The JAX server's other ``/debug/*`` routes (stacks, tasks,
profiles, flights, pod timelines, SLOs, the runtime observatory, cluster
views) are not ported.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
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
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            self._send(200, *metrics.render())
        elif path == "/healthy":
            self._send(200, b'{"ok": true}', _JSON)
        elif path in _FLEET_ROUTES:
            fleet = self.server.df_fleet
            q = {k: v[0] for k, v in urllib.parse.parse_qs(
                query, keep_blank_values=True).items()}
            # The observatory is fed on the scheduler's loop: read it there.
            status, body = (_fleet_answer(None, path, q) if fleet is None
                            else self.server.df_on_loop(
                                lambda: _fleet_answer(fleet, path, q)))
            self._send(status, *body)
        else:
            self._send(404, b"404: Not Found", _TEXT)

    do_HEAD = do_GET


_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
_FLEET_ROUTES = ("/debug/fleet", "/debug/fleet/hosts",
                 "/debug/fleet/decisions", "/debug/fleet/info")


def _json(data) -> tuple[bytes, str]:
    return json.dumps(data).encode(), _JSON


def _text(text: str) -> tuple[bytes, str]:
    return text.encode(), _TEXT


def _fleet_answer(fleet, path: str, q: dict) -> tuple[int, tuple]:
    """(status, (body, content type)) of one ``/debug/fleet*`` GET, as
    the JAX server answers it."""
    if fleet is None:
        return 404, _text("no fleet observatory on this binary "
                          "(scheduler-only)\n")
    if path == "/debug/fleet":
        try:
            window = max(1.0, float(q.get("window", "600")))
        except ValueError:
            return 400, _text("bad window value\n")
        return 200, _json(fleet.snapshot(window))
    if path == "/debug/fleet/hosts":
        try:
            limit = min(max(int(q.get("n", "256")), 1), 4096)
        except ValueError:
            return 400, _text("bad n value\n")
        return 200, _json(fleet.hosts_report(limit))
    if path == "/debug/fleet/decisions":
        try:
            limit = min(max(int(q.get("n", "256")), 1), 4096)
            since = float(q.get("since", "0") or 0)
            before = float(q.get("before", "0") or 0)
        except ValueError:
            return 400, _text("bad n/since/before value\n")
        return 200, _json(fleet.decisions.query(
            host=q.get("host", ""), task=q.get("task", ""),
            kind=q.get("kind", ""), limit=limit, since=since,
            before=before))
    return 200, _json(fleet.info())


class MetricsServer:
    ROUTES = ("/metrics", "/healthy")

    def __init__(self, *, fleet=None):
        self._server: ThreadedServer | None = None
        self._fleet = fleet

    async def serve(self, host: str, port: int) -> int:
        loop = asyncio.get_running_loop()

        async def call(fn):
            return fn()

        self._server = ThreadedServer((host, port), _Handler, "metrics")
        self._server.df_fleet = self._fleet
        self._server.df_on_loop = lambda fn: asyncio.run_coroutine_threadsafe(
            call(fn), loop).result(timeout=60.0)
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
