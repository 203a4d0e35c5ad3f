"""The metrics and debug endpoint of every role: the port's copy of
``dragonfly2_tpu/pkg/metrics_server.py``, on ``http.server``
(``pkg/httpserver.py``, threads named ``df-metrics``).

Routes, query parameters, statuses and bodies are the JAX server's:

- ``GET /metrics``: ``pkg/metrics.render()``, the Prometheus text format
  of the port's own registry; ``GET /healthy``: ``{"ok": true}``;
- ``/debug/stacks`` (every thread's stack), ``/debug/tasks`` (the role
  loop's asyncio tasks), ``/debug/profile?seconds=N`` (cProfile of the
  loop's thread, 0.1-60 s; 409 while one runs), ``/debug/heap?topn=N``
  (tracemalloc; the first call arms it);
- with a flight recorder (the daemon's): ``/debug/flight`` and
  ``/debug/flight/{task_id}[?format=text]``;
- with a pod aggregator (the scheduler's): ``/debug/pod/{task_id}``;
  with a pod-timeline provider (the scheduler's pod lens, an async
  callable that may pull missing flight digests over drpc):
  ``/debug/pod/{task_id}/timeline[?format=text]``;
- with an SLO engine: ``/debug/slo``;
- with a runtime observatory (``pkg/prof``): ``/debug/prof?topn=``,
  ``/debug/prof/flame?format=folded`` and ``/debug/prof/runtime``;
- with a fleet observatory (the scheduler's ``pkg/fleet.py``):
  ``/debug/fleet?window=``, ``/debug/fleet/hosts?n=``,
  ``/debug/fleet/decisions?host= &task= &kind= &n= &since= &before=``
  and ``/debug/fleet/info``.

A route whose provider the role did not pass answers 404 with the JAX
text. The JAX server's ``/debug/cluster*`` family (the manager's control
tower, ``pkg/cluster``) is not ported: those paths answer 404.

The JAX server runs its handlers on the role's loop; these run on the
server's threads, so every route that reads state the loop writes (the
tasks, the cProfile window, flights, the pod aggregator and lens, the
SLO engine, the loop-lag probes, the fleet) runs its read on the role's
loop through ``asyncio.run_coroutine_threadsafe``.
"""

from __future__ import annotations

import asyncio
import io
import json
import sys
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler

from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg.httpserver import ThreadedServer

log = dflog.get("metrics_server")

_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
# The longest a loop-side read may take: a profile window (60 s cap) plus
# the loop's own delay.
_ON_LOOP_TIMEOUT = 120.0


def _json(data) -> tuple[bytes, str]:
    return json.dumps(data).encode(), _JSON


def _text(text: str) -> tuple[bytes, str]:
    return text.encode(), _TEXT


def _thread_stacks() -> str:
    out = io.StringIO()
    for thread_id, frame in sys._current_frames().items():
        out.write(f"--- thread {thread_id} ---\n")
        traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


def _task_dump() -> str:
    out = io.StringIO()
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:
        return "no running loop\n"
    for task in tasks:
        out.write(f"--- {task.get_name()} "
                  f"{'cancelled' if task.cancelled() else 'pending'} ---\n")
        task.print_stack(file=out)
        out.write("\n")
    return out.getvalue()


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
        q = {k: v[0] for k, v in urllib.parse.parse_qs(
            query, keep_blank_values=True).items()}
        ms: MetricsServer = self.server.df_metrics
        routed = ms.route(path)
        if routed is None:
            self._send(404, *_text("404: Not Found"))
            return
        name, arg = routed
        if name == "_metrics":
            self._send(200, *metrics.render())
            return
        status, body = getattr(ms, name)(q, arg)
        self._send(status, *body)

    do_HEAD = do_GET


def _not_found(text: str) -> tuple[int, tuple]:
    return 404, _text(text)


class MetricsServer:
    # The HTTP surface: (path, handler attribute name), the JAX table less
    # the /debug/cluster* family.
    ROUTES = (
        ("/metrics", "_metrics"),
        ("/healthy", "_healthy"),
        ("/debug/stacks", "_stacks"),
        ("/debug/tasks", "_tasks"),
        ("/debug/profile", "_profile"),
        ("/debug/heap", "_heap"),
        ("/debug/flight", "_flight_index"),
        ("/debug/flight/{task_id}", "_flight_task"),
        ("/debug/pod/{task_id}", "_pod_task"),
        ("/debug/pod/{task_id}/timeline", "_pod_timeline"),
        ("/debug/slo", "_slo"),
        ("/debug/prof", "_prof"),
        ("/debug/prof/flame", "_prof_flame"),
        ("/debug/prof/runtime", "_prof_runtime"),
        ("/debug/fleet", "_fleet_snapshot"),
        ("/debug/fleet/hosts", "_fleet_hosts"),
        ("/debug/fleet/decisions", "_fleet_decisions"),
        ("/debug/fleet/info", "_fleet_info"),
    )

    def __init__(self, *, flight=None, pod_flight=None, fleet=None,
                 slo=None, pod_timeline=None, prof=None):
        # Optional providers, as the JAX server takes them: the daemon
        # passes its flight recorder, the scheduler its pod aggregator,
        # fleet observatory, SLO engine and pod-timeline assembler; every
        # role its runtime observatory.
        self._flight = flight
        self._pod_flight = pod_flight
        self._fleet = fleet
        self._slo_engine = slo
        self._pod_timeline_provider = pod_timeline
        self._prof_obs = prof
        self._server: ThreadedServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._profiling = False
        fixed, patterns = {}, []
        for path, name in self.ROUTES:
            if "{task_id}" in path:
                head, tail = path.split("{task_id}")
                patterns.append((head, tail, name))
            else:
                fixed[path] = name
        self._fixed = fixed
        self._patterns = patterns

    @classmethod
    def debug_routes(cls) -> list:
        """Every registered /debug route pattern."""
        return [path for path, _name in cls.ROUTES
                if path.startswith("/debug/")]

    def route(self, path: str) -> "tuple[str, str] | None":
        """(handler name, the ``{task_id}`` segment or "") of a path, as
        aiohttp's router matches it (a segment holds no ``/``)."""
        name = self._fixed.get(path)
        if name is not None:
            return name, ""
        for head, tail, name in self._patterns:
            if path.startswith(head) and path.endswith(tail):
                seg = path[len(head):len(path) - len(tail)]
                if seg and "/" not in seg:
                    return name, urllib.parse.unquote(seg)
        return None

    async def serve(self, host: str, port: int) -> int:
        self._loop = asyncio.get_running_loop()
        self._server = ThreadedServer((host, port), _Handler, "metrics")
        self._server.df_metrics = self
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

    # -- the role's loop ---------------------------------------------------

    def _on_loop(self, fn):
        """``fn()`` run on the role's loop (a coroutine function's result
        awaited there); its value, here on the handler's thread."""
        async def call():
            out = fn()
            return await out if asyncio.iscoroutine(out) else out

        return asyncio.run_coroutine_threadsafe(call(), self._loop).result(
            timeout=_ON_LOOP_TIMEOUT)

    # -- routes --------------------------------------------------------------

    def _healthy(self, q, arg):
        return 200, _json({"ok": True})

    def _stacks(self, q, arg):
        return 200, _text(_thread_stacks())

    def _tasks(self, q, arg):
        return 200, _text(self._on_loop(_task_dump))

    def _profile(self, q, arg):
        """CPU profile of the loop's thread for ?seconds=N (default 5, cap
        60): cProfile runs while the loop keeps serving, then pstats text
        comes back."""
        try:
            seconds = min(max(float(q.get("seconds", "5")), 0.1), 60.0)
        except ValueError:
            return 400, _text("bad seconds value\n")
        return self._on_loop(lambda: self._profile_on_loop(seconds))

    async def _profile_on_loop(self, seconds: float):
        import cProfile
        import pstats

        if self._profiling:
            return 409, _text("a profile is already running\n")
        self._profiling = True
        prof = cProfile.Profile()
        try:
            try:
                prof.enable()
            except ValueError as e:  # another profiler is active
                return 409, _text(f"{e}\n")
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.disable()
        finally:
            self._profiling = False
        out = io.StringIO()
        stats = pstats.Stats(prof, stream=out)
        stats.sort_stats("cumulative").print_stats(60)
        return 200, _text(out.getvalue())

    def _heap(self, q, arg):
        """Heap allocation snapshot via tracemalloc (armed on the first
        call)."""
        import tracemalloc

        try:
            topn = min(int(q.get("topn", "30")), 200)
        except ValueError:
            return 400, _text("bad topn value\n")
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return 200, _text("tracemalloc armed; call again for a "
                              "snapshot\n")
        snapshot = tracemalloc.take_snapshot()
        current, peak = tracemalloc.get_traced_memory()
        lines = [f"traced current={current / 1e6:.1f}MB "
                 f"peak={peak / 1e6:.1f}MB", ""]
        for stat in snapshot.statistics("lineno")[:topn]:
            lines.append(str(stat))
        return 200, _text("\n".join(lines) + "\n")

    def _flight_index(self, q, arg):
        if self._flight is None:
            return _not_found("no flight recorder on this binary\n")
        return 200, _json({"tasks": self._on_loop(self._flight.summary)})

    def _flight_task(self, q, arg):
        """The task's phase breakdown and per-piece waterfall;
        ``?format=text`` renders the waterfall ``dfget --explain``
        prints."""
        if self._flight is None:
            return _not_found("no flight recorder on this binary\n")

        def read():
            tf = self._flight.get(arg)
            return None if tf is None else flightlib.analyze(tf)

        report = self._on_loop(read)
        if report is None:
            return _not_found(f"no flight data for {arg}\n")
        if q.get("format") == "text":
            return 200, _text(flightlib.render_waterfall(report) + "\n")
        return 200, _json(report)

    def _pod_task(self, q, arg):
        if self._pod_flight is None:
            return _not_found("no pod aggregator on this binary\n")
        report = self._on_loop(lambda: self._pod_flight.report(arg))
        if report is None:
            return _not_found(f"no pod data for {arg}\n")
        return 200, _json(report)

    def _pod_timeline(self, q, arg):
        """The pod lens's merged cross-host timeline; ``?format=text``
        renders the waterfall ``dfget --pod`` prints."""
        if self._pod_timeline_provider is None:
            return _not_found("no pod lens on this binary "
                              "(scheduler-only)\n")
        report = self._on_loop(lambda: self._pod_timeline_provider(arg))
        if report is None:
            return _not_found(f"no shipped flight digests for {arg}\n")
        if q.get("format") == "text":
            from dragonfly2_tpu_torch.pkg import podlens

            return 200, _text(podlens.render_timeline(report) + "\n")
        return 200, _json(report)

    def _slo(self, q, arg):
        if self._slo_engine is None:
            return _not_found("no SLO engine on this binary\n")
        return 200, _json(self._on_loop(self._slo_engine.report))

    def _need_prof(self):
        if self._prof_obs is None:
            return _not_found("no runtime observatory on this binary "
                              "(prof.enabled=false?)\n")
        return None

    def _prof(self, q, arg):
        """The sampler's top-N self-time frames per thread (``?topn=``,
        default 20, cap 200). The trie is the sampler's, under its lock."""
        missing = self._need_prof()
        if missing is not None:
            return missing
        try:
            topn = min(max(int(q.get("topn", "20")), 1), 200)
        except ValueError:
            return 400, _text("bad topn value\n")
        return 200, _json(self._prof_obs.profile_report(topn))

    def _prof_flame(self, q, arg):
        missing = self._need_prof()
        if missing is not None:
            return missing
        if q.get("format", "folded") != "folded":
            return 400, _text("only format=folded is supported\n")
        return 200, _text(self._prof_obs.folded())

    def _prof_runtime(self, q, arg):
        missing = self._need_prof()
        if missing is not None:
            return missing
        return 200, _json(self._on_loop(self._prof_obs.runtime_report))

    def _need_fleet(self):
        if self._fleet is None:
            return _not_found("no fleet observatory on this binary "
                              "(scheduler-only)\n")
        return None

    def _fleet_snapshot(self, q, arg):
        missing = self._need_fleet()
        if missing is not None:
            return missing
        try:
            window = max(1.0, float(q.get("window", "600")))
        except ValueError:
            return 400, _text("bad window value\n")
        return 200, _json(self._on_loop(lambda: self._fleet.snapshot(window)))

    def _fleet_hosts(self, q, arg):
        missing = self._need_fleet()
        if missing is not None:
            return missing
        try:
            limit = min(max(int(q.get("n", "256")), 1), 4096)
        except ValueError:
            return 400, _text("bad n value\n")
        return 200, _json(self._on_loop(
            lambda: self._fleet.hosts_report(limit)))

    def _fleet_decisions(self, q, arg):
        missing = self._need_fleet()
        if missing is not None:
            return missing
        try:
            limit = min(max(int(q.get("n", "256")), 1), 4096)
            since = float(q.get("since", "0") or 0)
            before = float(q.get("before", "0") or 0)
        except ValueError:
            return 400, _text("bad n/since/before value\n")
        return 200, _json(self._on_loop(lambda: self._fleet.decisions.query(
            host=q.get("host", ""), task=q.get("task", ""),
            kind=q.get("kind", ""), limit=limit, since=since,
            before=before)))

    def _fleet_info(self, q, arg):
        missing = self._need_fleet()
        if missing is not None:
            return missing
        return 200, _json(self._on_loop(self._fleet.info))
