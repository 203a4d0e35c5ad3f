"""The port's metrics server (``dragonfly2_tpu_torch/pkg/metrics_server.py``,
``http.server``) against the JAX one (``dragonfly2_tpu/pkg/metrics_server.py``,
aiohttp): every ``/debug/*`` route but the fleet's (``test_torch_fleet``)
and the cluster's, over providers built alike in each package.

- The flight recorder: the same seeded events on one injected clock in
  each package's recorder; ``/debug/flight`` and
  ``/debug/flight/{task}`` (JSON and ``?format=text``) answer the same
  statuses, content types and bodies, 404 for an absent task.
- The pod aggregator (``/debug/pod/{task}``), the pod lens
  (``/debug/pod/{task}/timeline``, JSON and text, through an async
  provider run on the server's loop) and the SLO engine (``/debug/slo``)
  fed the same reports, digests and completions.
- The runtime observatory: ``/debug/prof`` (``?topn=``), ``/flame`` and
  ``/runtime`` answer the same statuses and errors; their sampled bodies
  differ by nature, so their keys are compared.
- ``/debug/stacks``, ``/debug/tasks`` (the serving loop's tasks),
  ``/debug/profile`` (``?seconds=``, bad values, a second profile while
  one runs: 409) and ``/debug/heap`` (``?topn=``).
- With no provider each route answers the JAX 404 text. The four
  ``/debug/cluster*`` routes (the manager's control tower, not ported)
  and unknown paths answer 404 ``404: Not Found``.
"""

from __future__ import annotations

import asyncio
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.pkg import flight as jflight
from dragonfly2_tpu.pkg import metrics_server as jms
from dragonfly2_tpu.pkg import podlens as jlens
from dragonfly2_tpu.pkg import prof as jprof
from dragonfly2_tpu.pkg import slo as jslo
from dragonfly2_tpu_torch.pkg import flight as pflight
from dragonfly2_tpu_torch.pkg import metrics_server as pms
from dragonfly2_tpu_torch.pkg import podlens as plens
from dragonfly2_tpu_torch.pkg import prof as pprof
from dragonfly2_tpu_torch.pkg import slo as pslo

TASK = "debug-task"


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (jflight, pflight):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=c, time=lambda: 1.7e9 + c.now))
        monkeypatch.setattr(mod, "_WALL_ANCHOR", 1.7e9)
        monkeypatch.setattr(mod, "_PC_ANCHOR", 900.0)
    return c


def _record(mod, clock: Clock, seed: int) -> object:
    """A recorder with one finished and one running task, the same seeded
    events stamped at the same instants."""
    rng = np.random.RandomState(seed)
    clock.now = 1000.0
    rec = mod.FlightRecorder(max_tasks=8)
    for task, pieces, state in ((TASK, 12, "done"), ("running", 3, None)):
        tf = rec.task(task)
        tf.record(mod.EV_REGISTER)
        clock.now += 0.01
        tf.record(mod.EV_SCHEDULED, -1, 0.0, "normal_task")
        for n in range(pieces):
            clock.now += float(rng.uniform(0.001, 0.05))
            tf.record(mod.EV_REQUEST, n, 0.0, "10.0.0.2:65002")
            clock.now += float(rng.uniform(0.001, 0.05))
            tf.record(mod.EV_FIRST_BYTE, n)
            clock.now += float(rng.uniform(0.001, 0.05))
            tf.record(mod.EV_LANDED, n, 3.0, "cross")
        clock.now += 0.02
        tf.record(mod.EV_HBM_START)
        clock.now += 0.03
        tf.record(mod.EV_HBM_LANDED)
        if state:
            rec.finish_task(task, state)
    return rec


def _digest(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    phases = {ph: round(float(rng.uniform(0, 2)), 6) for ph in jflight.PHASES}
    return {"v": 1, "task_id": TASK, "state": "done", "note": "",
            "start_wall": 2000.0 + seed, "wall_s": 5.0 + seed,
            "phases": phases, "other_s": 0.1, "dominant_phase": "dcn",
            "segments": [[0.0, 1.0, "dcn"], [1.0, 2.5, "stall"]],
            "pieces": [[0, 1, 0.0, 0.1, 0.2, 1, "", "p:1"]],
            "pieces_total": 1, "clock": [[2000.0 + seed, 2000.002 + seed,
                                          2000.001]]}


def _providers(pkg: str, clock: Clock) -> dict:
    flight, lens_mod, slo = ((jflight, jlens, jslo) if pkg == "jax"
                             else (pflight, plens, pslo))
    rec = _record(flight, clock, 3)
    pod = flight.PodAggregator()
    for h in range(3):
        for n in range(5):
            pod.note_piece(TASK, f"h{h}", {"dcn_ms": 10 * h + n,
                                           "stall_ms": h, "store_ms": 1})
    pod.note_failure(TASK, "h2", "timeout")
    lens = lens_mod.PodLens(clock_estimator=lens_mod.ClockEstimator(
        clock=lambda: 5.0))
    for h in range(3):
        lens.note_flight(TASK, f"h{h}", _digest(h), peer_id=f"p{h}")
    engine = slo.SLOEngine(clock=lambda: 100.0)
    for i in range(5):
        engine.note_completion(f"h{i}", 10.0 * i, ttfb_s=0.5 * i,
                               stall_frac=0.1 * i, now=50.0 + i)

    async def timeline(task_id):
        await asyncio.sleep(0)
        return lens.timeline(task_id)

    return {"flight": rec, "pod_flight": pod, "slo": engine,
            "pod_timeline": timeline}


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


EQUAL_PATHS = (
    "/healthy", "/debug/flight", f"/debug/flight/{TASK}",
    f"/debug/flight/{TASK}?format=text", "/debug/flight/running",
    "/debug/flight/absent", f"/debug/pod/{TASK}", "/debug/pod/absent",
    f"/debug/pod/{TASK}/timeline", f"/debug/pod/{TASK}/timeline?format=text",
    "/debug/pod/absent/timeline", "/debug/slo", "/debug/prof?topn=x",
    "/debug/prof/flame?format=svg", "/debug/profile?seconds=x",
    "/debug/heap?topn=x", "/nope", "/debug/flight/a/b",
)
SHAPE_PATHS = ("/debug/prof", "/debug/prof?topn=3",
               "/debug/prof/flame", "/debug/prof/runtime", "/debug/stacks",
               "/debug/tasks", "/debug/profile?seconds=0.1")


def _serve_all(run_async, servers: dict, paths) -> dict:
    async def run():
        out = {}
        for name, server in servers.items():
            port = await server.serve("127.0.0.1", 0)
            base = f"http://127.0.0.1:{port}"
            try:
                out[name] = [await asyncio.to_thread(_get, base, p)
                             for p in paths]
            finally:
                await server.close()
        return out

    return run_async(run(), timeout=120)


def _body(ctype: str, body: bytes):
    return json.loads(body) if ctype.startswith("application/json") \
        else body


def test_debug_routes_answer_as_the_jax_server(clock, run_async):
    jp, pp = _providers("jax", clock), _providers("port", clock)
    jobs = jprof.RuntimeObservatory(jprof.ProfConfig(enabled=False))
    pobs = pprof.RuntimeObservatory(pprof.ProfConfig(enabled=False))
    out = _serve_all(run_async, {
        "jax": jms.MetricsServer(prof=jobs, **jp),
        "port": pms.MetricsServer(prof=pobs, **pp)},
        EQUAL_PATHS + SHAPE_PATHS)
    n = len(EQUAL_PATHS)
    for path, (js, jt, jb), (ps, pt, pb) in zip(
            EQUAL_PATHS, out["jax"][:n], out["port"][:n]):
        assert (ps, pt) == (js, jt), path
        assert _body(pt, pb) == _body(jt, jb), path
    statuses = dict(zip(EQUAL_PATHS, (s for s, _, _ in out["port"][:n])))
    for path in ("/debug/flight", f"/debug/flight/{TASK}",
                 "/debug/flight/running", f"/debug/pod/{TASK}",
                 f"/debug/pod/{TASK}/timeline", "/debug/slo"):
        assert statuses[path] == 200, path
    for path in ("/debug/flight/absent", "/debug/pod/absent/timeline",
                 "/nope", "/debug/flight/a/b"):
        assert statuses[path] == 404, path
    for path, (js, jt, jb), (ps, pt, pb) in zip(
            SHAPE_PATHS, out["jax"][n:], out["port"][n:]):
        assert (ps, pt) == (js, jt) == (200, pt), path
        if pt.startswith("application/json"):
            assert set(json.loads(pb)) == set(json.loads(jb)), path
    runtime = json.loads(out["port"][n + 3][2])
    assert set(runtime["gc"]) == set(json.loads(out["jax"][n + 3][2])["gc"])
    # The port reads the loop's tasks on the loop that serves.
    assert b"pending" in out["port"][n + 5][2]
    assert b"cumulative" in out["port"][n + 6][2]


def test_debug_routes_without_providers_answer_as_the_jax_server(
        run_async):
    paths = ("/debug/flight", f"/debug/flight/{TASK}", f"/debug/pod/{TASK}",
             f"/debug/pod/{TASK}/timeline", "/debug/slo", "/debug/prof",
             "/debug/prof/flame", "/debug/prof/runtime", "/metrics")
    out = _serve_all(run_async, {"jax": jms.MetricsServer(),
                                 "port": pms.MetricsServer()}, paths)
    for path, (js, jt, jb), (ps, pt, pb) in zip(paths, out["jax"],
                                                out["port"]):
        assert ps == js, path
        if path != "/metrics":
            assert (ps, pt, pb) == (js, jt, jb), path
    assert [s for s, _, _ in out["port"]] == [404] * 8 + [200]


def test_the_route_tables_match_less_the_cluster_family():
    cluster = [p for p in jms.MetricsServer.debug_routes()
               if p.startswith("/debug/cluster")]
    assert len(cluster) == 4
    assert [r for r in jms.MetricsServer.ROUTES
            if not r[0].startswith("/debug/cluster")] == list(
        pms.MetricsServer.ROUTES)
    assert pms.MetricsServer.debug_routes() == [
        p for p in jms.MetricsServer.debug_routes() if p not in cluster]


def test_the_cluster_routes_and_a_second_profile(run_async):
    """The cluster family is 404 on the port; a profile asked while one
    runs is 409, as in JAX."""
    async def run():
        server = pms.MetricsServer()
        port = await server.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            got = [await asyncio.to_thread(_get, base, p) for p in (
                "/debug/cluster", "/debug/cluster/schedulers",
                "/debug/cluster/slo", "/debug/cluster/events")]
            first = asyncio.ensure_future(asyncio.to_thread(
                _get, base, "/debug/profile?seconds=1"))
            await asyncio.sleep(0.4)
            second = await asyncio.to_thread(_get, base,
                                             "/debug/profile?seconds=0.1")
            return got, await first, second
        finally:
            await server.close()

    got, first, second = run_async(run(), timeout=60)
    assert [(s, b) for s, _, b in got] == [(404, b"404: Not Found")] * 4
    assert first[0] == 200
    assert second[:3] == (409, "text/plain; charset=utf-8",
                          b"a profile is already running\n")


def test_heap_arms_then_snapshots(run_async):
    import tracemalloc

    async def run():
        server = pms.MetricsServer()
        port = await server.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        try:
            return [await asyncio.to_thread(_get, base, "/debug/heap?topn=3")
                    for _ in range(2)]
        finally:
            await server.close()

    was = tracemalloc.is_tracing()
    try:
        first, second = run_async(run(), timeout=60)
    finally:
        if not was:
            tracemalloc.stop()
    if not was:
        assert first[2] == b"tracemalloc armed; call again for a snapshot\n"
    assert second[0] == 200 and second[2].startswith(b"traced current=")
