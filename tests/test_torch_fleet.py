"""The port's fleet observatory (``dragonfly2_tpu_torch/pkg/fleet.py``)
against the JAX one, and the scheduler that feeds it.

- The observatories alone: the same seeded events on one injected clock
  (each series' and scorecards' ``_clock``, each module's ``time``) give
  equal ``snapshot``, ``hosts_report``, ``info``, decision queries,
  straggler sets, totals and gauges; the port's ``now=``/``wall=`` feed
  equals its clock-injected run.
- The four ``/debug/fleet*`` routes of the port's metrics server answer
  what the JAX (``aiohttp``) metrics server answers, JSON for JSON, with
  the same 400s and the same 404 without an observatory.
- The scheduler with ``fleet.enabled=True`` in both packages: the
  scripted session of ``test_torch_scheduler_service`` gives the same
  answers (announce scorecards included), counters, decisions and host
  reports; a fleet with one slow parent flags it, drops it from a
  child's candidates with a ``straggler_filter`` decision and hands out
  the same parents in both packages.
"""

from __future__ import annotations

import asyncio
import json
import random
import urllib.error
import urllib.request

import pytest

from dragonfly2_tpu.pkg import fleet as jfleet
from dragonfly2_tpu.pkg import metrics_server as jms
from dragonfly2_tpu.proto import reportcodec as jcodec
from dragonfly2_tpu.scheduler.config import SchedulerConfig as JConfig
from dragonfly2_tpu.scheduler.service import SchedulerService as JService
from dragonfly2_tpu_torch.pkg import fleet as pfleet
from dragonfly2_tpu_torch.pkg import metrics_server as pms
from dragonfly2_tpu_torch.proto import reportcodec as pcodec
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from tests.test_torch_scheduler_service import (  # noqa: F401 (fixture)
    FakeSeedClients,
    Session,
    _host,
    _reports,
    _scripted,
    upload_server,
)

from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu_torch.pkg.errors import DfError

WALL0 = 1_800_000_000.0


class Clock:
    """One clock for both packages: monotonic seconds and wall seconds
    that advance together."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return WALL0 + self.t


def _observatory(mod, clock: Clock, **kw):
    obs = mod.FleetObservatory(**kw)
    obs.series._clock = clock.monotonic
    obs.series._wall_anchor = WALL0
    obs.scorecards._clock = clock.monotonic
    obs.started_wall = clock.time()
    return obs


@pytest.fixture
def clocked(monkeypatch):
    """Both fleet modules read ``time`` from one fake clock."""
    clock = Clock()
    monkeypatch.setattr(jfleet, "time", clock)
    monkeypatch.setattr(pfleet, "time", clock)
    return clock


def _events(seed: int, n: int = 400):
    """A seeded event script: (advance_s, method, args, kwargs)."""
    rng = random.Random(seed)
    hosts = [f"h{i}" for i in range(12)]
    slow = "h7"
    out = []
    for _ in range(n):
        dt = rng.choice((0.0, 0.01, 0.5, 1.3, 6.0))
        kind = rng.random()
        if kind < 0.45:
            host = rng.choice(hosts)
            by_parent = {}
            k = rng.randint(1, 6)
            for _ in range(rng.randint(1, 3)):
                p = rng.choice(hosts + [""])
                if p == host:
                    continue
                cost = (400.0 if p == slow else 20.0) + rng.random() * 5
                col = rng.choice((jfleet.C_BYTES_INTRA, jfleet.C_BYTES_CROSS,
                                  jfleet.C_BYTES_UNLABELED))
                agg = by_parent.setdefault(p, [0, 0.0, 0, col])
                agg[0] += k
                agg[1] += cost * k
                agg[2] += k << 20
            n_pieces = sum(a[0] for a in by_parent.values())
            cost_total = sum(a[1] for a in by_parent.values())
            timings = ({"dcn_ms": rng.randint(0, 9), "stall_ms": 1,
                        "store_ms": 2} if rng.random() < 0.5 else None)
            out.append((dt, "note_pieces", (host, n_pieces, cost_total),
                        {"by_parent": by_parent, "timings": timings}))
        elif kind < 0.55:
            host, parent = rng.sample(hosts, 2)
            out.append((dt, "note_piece",
                        (host, jfleet.C_BYTES_INTRA, 1 << 20,
                         400.0 if parent == slow else 15.0, parent,
                         {"dcn_ms": 3}), {}))
        elif kind < 0.62:
            out.append((dt, "note_piece_failed",
                        (rng.choice(hosts + [""]),
                         rng.choice(jfleet.REASONS + ("weird",))), {}))
        elif kind < 0.66:
            out.append((dt, "note_quarantine",
                        (f"t{rng.randint(0, 3)}", rng.choice(hosts),
                         "corrupt"), {"reporter": "p1"}))
        elif kind < 0.70:
            out.append((dt, "note_back_source",
                        (f"t{rng.randint(0, 3)}", "p2", rng.choice(hosts),
                         "no parents"), {}))
        elif kind < 0.80:
            chosen = tuple(rng.sample(hosts, 2))
            out.append((dt, "note_handout",
                        (f"t{rng.randint(0, 3)}", f"p{rng.randint(0, 9)}",
                         rng.choice(hosts), chosen,
                         tuple(rng.sample(hosts, 3))), {}))
        elif kind < 0.84:
            out.append((dt, "note_stripe",
                        (f"t{rng.randint(0, 3)}", "p3", rng.choice(hosts),
                         rng.random() < 0.5), {}))
        elif kind < 0.86:
            out.append((dt, "note_straggler_filter",
                        ("t1", "p4", slow), {}))
        elif kind < 0.88:
            out.append((dt, "note_schedule_failed",
                        ("t2", "p5", rng.choice(hosts), "no parents"), {}))
        elif kind < 0.90:
            out.append((dt, "note_admission", ("tenant-a",),
                        {"decision": rng.choice(("deny", "restore")),
                         "burn": rng.random() * 3,
                         "retry_after_s": rng.choice((0.0, 2.5)),
                         "source": "burn_book"}))
        elif kind < 0.92:
            out.append((dt, "note_throttle", ("tenant-b",),
                        {"task_id": "t3", "host_id": "h1",
                         "reason": "burn_rate_handout",
                         "limit": rng.choice((0, 2))}))
        elif kind < 0.96:
            out.append((dt, "note_register", (),
                        {"reconnect": rng.random() < 0.3}))
        else:
            out.append((dt, "note_announce", (), {}))
    return out


def _gauges(state={"n": 0}):
    def sample():
        state["n"] += 1
        return {"hosts_total": 12, "hosts_seed": 1,
                "hosts_quarantined": state["n"] % 3, "peers_running": 4,
                "tasks_active": 2, "straggler_hosts": 1}
    return sample


def _feed(obs, clock: Clock, events) -> None:
    for dt, name, args, kw in events:
        clock.t += dt
        getattr(obs, name)(*args, **kw)


def _read(obs) -> dict:
    return {
        "snapshot": obs.snapshot(600.0),
        "snapshot_short": obs.snapshot(30.0),
        "hosts": obs.hosts_report(),
        "hosts_3": obs.hosts_report(3),
        "info": obs.info(),
        "decisions": obs.decisions.query(),
        "by_host": obs.decisions.query(host="h7"),
        "by_task": obs.decisions.query(task="t1", limit=5),
        "by_kind": obs.decisions.query(kind="handout", limit=3),
        "since": obs.decisions.query(since=WALL0 + 1100.0),
        "stragglers": sorted(obs.scorecards._stragglers),
        "totals": obs.series.totals(3600.0, jfleet.COUNTERS),
        "gauge": obs.series.gauge_column("hosts_quarantined", 3600.0),
        "gauges_last": obs.series.gauges_last(600.0),
        "kind_counts": dict(obs.decisions.kind_counts),
        "zscores": {h: obs.scorecards.zscore(h)
                    for h in sorted(obs.scorecards._hosts)},
    }


def test_the_module_keeps_the_jax_columns_and_families():
    assert pfleet.COUNTERS == jfleet.COUNTERS
    assert pfleet.GAUGES == jfleet.GAUGES
    assert pfleet.REASONS == jfleet.REASONS
    for name in dir(jfleet):
        if name.startswith("C_"):
            assert getattr(pfleet, name) == getattr(jfleet, name), name
    for r in jfleet.REASONS + ("weird",):
        assert pfleet.failed_col(r) == jfleet.failed_col(r)
    assert pfleet.DECISION_COUNT.name == "scheduler_decisions_total"
    assert pfleet.STRAGGLER_GAUGE.name == "fleet_straggler_hosts"
    # The port's registry, not prometheus_client's.
    from dragonfly2_tpu_torch.pkg import metrics as pmetrics

    assert isinstance(pfleet.DECISION_COUNT, pmetrics.Counter)


@pytest.mark.parametrize("seed,max_hosts", [(0, 1024), (1, 1024), (2, 10)])
def test_the_same_events_give_the_same_reports(clocked, seed, max_hosts):
    kw = dict(bucket_s=5.0, buckets=64, decision_cap=128,
              max_hosts=max_hosts, min_serve_samples=4, min_population=6)
    j = _observatory(jfleet, clocked, sampler=_gauges({"n": 0}),
                     config_snapshot={"cluster_id": 1}, **kw)
    p = _observatory(pfleet, clocked, sampler=_gauges({"n": 0}),
                     config_snapshot={"cluster_id": 1}, **kw)
    events = _events(seed)
    start = clocked.t
    _feed(j, clocked, events)
    jr = _read(j)
    clocked.t = start
    _feed(p, clocked, events)
    pr = _read(p)
    assert pr == jr
    assert p.scorecards.recompute_stragglers() == \
        j.scorecards.recompute_stragglers()
    if max_hosts > 12:
        # The script flags its slow parent.
        assert p.scorecards.recompute_stragglers() == {"h7"}
    else:
        # Twelve hosts through ten cards: evictions ran.
        assert pr["hosts"]["hosts_tracked"] <= max_hosts


def test_now_and_wall_arguments_equal_the_injected_clock(clocked):
    """The port's ``now=`` (series and scorecards) and ``wall=``
    (decisions, uptime) give what its clock-injected run gives."""
    kw = dict(bucket_s=5.0, buckets=64, decision_cap=128,
              min_serve_samples=4, min_population=6)
    events = _events(5, 250)
    start = clocked.t
    injected = _observatory(pfleet, clocked, sampler=_gauges({"n": 0}), **kw)
    _feed(injected, clocked, events)
    expect = _read(injected)

    clocked.t = start
    explicit = _observatory(pfleet, clocked, sampler=_gauges({"n": 0}), **kw)
    frozen = Clock(-1e9)        # read only where no argument was given
    explicit.series._clock = frozen.monotonic
    explicit.scorecards._clock = frozen.monotonic
    t = start
    wall_kinds = {"note_quarantine", "note_back_source", "note_handout",
                  "note_stripe"}
    for dt, name, args, kwargs in events:
        t += dt
        extra = {}
        if name in {"note_pieces", "note_piece", "note_piece_failed",
                    "note_register", "note_announce"} | wall_kinds:
            extra["now"] = t
        if name in wall_kinds | {"note_straggler_filter",
                                 "note_schedule_failed", "note_admission",
                                 "note_throttle"}:
            extra["wall"] = WALL0 + t
        getattr(explicit, name)(*args, **kwargs, **extra)
    # Straggler recomputes and failure decay read the scorecards' clock
    # only through the explicit ``now`` values above.
    clocked.t = t
    explicit.series._clock = clocked.monotonic
    explicit.scorecards._clock = clocked.monotonic
    assert _read(explicit) == expect
    # The read side takes the clock as arguments too (the gauge sampler
    # and resident bytes move with every read, so only the clocked parts).
    snap = explicit.snapshot(600.0, now=t, wall=WALL0 + t)
    assert snap["series"] == expect["snapshot"]["series"]
    assert snap["uptime_s"] == expect["snapshot"]["uptime_s"]
    assert explicit.hosts_report(now=t) == expect["hosts"]
    assert explicit.info(wall=WALL0 + t)["uptime_s"] == \
        expect["info"]["uptime_s"]


def _fleet_get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


FLEET_PATHS = (
    "/debug/fleet", "/debug/fleet?window=30", "/debug/fleet?window=x",
    "/debug/fleet?window=0", "/debug/fleet/hosts", "/debug/fleet/hosts?n=2",
    "/debug/fleet/hosts?n=bad", "/debug/fleet/decisions",
    "/debug/fleet/decisions?host=h7&n=4",
    "/debug/fleet/decisions?task=t1&kind=handout",
    "/debug/fleet/decisions?since=1800001100&before=1800001300",
    "/debug/fleet/decisions?n=1&since=x", "/debug/fleet/info",
)


def test_the_debug_fleet_routes_answer_as_the_jax_server(clocked, run_async):
    kw = dict(bucket_s=5.0, buckets=64, decision_cap=128,
              min_serve_samples=4, min_population=6)
    events = _events(1)
    start = clocked.t
    j = _observatory(jfleet, clocked, sampler=_gauges({"n": 0}), **kw)
    _feed(j, clocked, events)
    end = clocked.t
    clocked.t = start
    p = _observatory(pfleet, clocked, sampler=_gauges({"n": 0}), **kw)
    _feed(p, clocked, events)
    assert clocked.t == end

    async def run():
        out = {}
        for name, server in (
                ("jax", jms.MetricsServer(fleet=j)),
                ("port", pms.MetricsServer(fleet=p)),
                ("jax none", jms.MetricsServer()),
                ("port none", pms.MetricsServer())):
            port = await server.serve("127.0.0.1", 0)
            base = f"http://127.0.0.1:{port}"
            try:
                got = []
                for path in FLEET_PATHS:
                    got.append(await asyncio.to_thread(_fleet_get, base,
                                                       path))
                out[name] = got
            finally:
                await server.close()
        return out

    out = run_async(run(), timeout=60)
    for a, b in (("jax", "port"), ("jax none", "port none")):
        for path, (js, jt, jb), (ps, pt, pb) in zip(FLEET_PATHS, out[a],
                                                    out[b]):
            assert (ps, pt) == (js, jt), path
            if jt.startswith("application/json"):
                assert json.loads(pb) == json.loads(jb), path
            else:
                assert pb == jb, path
    assert [s for s, _, _ in out["port"]].count(400) == 3
    assert {s for s, _, _ in out["port none"]} == {404}


# -- the scheduler with the fleet on ---------------------------------------

def _config(pkg: str, **fleet):
    cfg = JConfig() if pkg == "jax" else SchedulerConfig()
    assert cfg.fleet.enabled            # the default, in both packages
    cfg.podlens.enabled = False
    cfg.scheduling.retry_interval = 0.02
    cfg.scheduling.retry_back_to_source_limit = 1
    cfg.scheduling.retry_limit = 2
    for k, v in fleet.items():
        setattr(cfg.fleet, k, v)
    return cfg


def _service(pkg: str, clock: Clock, **fleet):
    cfg = _config(pkg, **fleet)
    svc = JService(cfg) if pkg == "jax" else SchedulerService(cfg)
    svc.fleet.series._clock = clock.monotonic
    svc.fleet.series._wall_anchor = WALL0
    svc.fleet.scorecards._clock = clock.monotonic
    svc.fleet.started_wall = clock.time()
    svc.seed_clients = FakeSeedClients()
    return svc


def _masked_decisions(fleet) -> list:
    return [{k: v for k, v in d.items() if k != "ts"}
            for d in fleet.decisions.query(limit=4096)["decisions"]]


def _masked_hosts(fleet) -> dict:
    rep = fleet.hosts_report()
    for row in rep["hosts"]:
        row.pop("idle_s")
    return rep


def test_the_scripted_session_feeds_both_fleets_alike(clocked,
                                                      upload_server):
    """The scheduler-service session of ``test_torch_scheduler_service``
    with the fleet on: every answer (the announce scorecards among
    them) and the fleet's counters, decisions and host reports."""
    def run(pkg):
        clocked.t = 1000.0

        async def go():
            svc = _service(pkg, clocked)
            sess = Session(svc, jcodec if pkg == "jax" else pcodec,
                           JDfError if pkg == "jax" else DfError)
            await _scripted(sess, upload_server.server_address[1])
            # A second announce of every host now carries its scorecard.
            for h in ("hA", "hB", "hC", "hD"):
                await sess.call(f"announce {h} again", svc.announce_host,
                                _host(h, 0))
            return svc, sess

        return asyncio.run(asyncio.wait_for(go(), 60))

    jsvc, jsess = run("jax")
    psvc, psess = run("port")
    assert psess.log == jsess.log
    assert any("scorecard" in out for what, out in psess.log
               if what.startswith("announce hA again"))
    # The keepalive's burn snapshot (and its admission decisions); the JAX
    # payload adds the cluster fleet frame, which the port does not build.
    jpayload = jsvc.manager_payload()
    assert set(jpayload) == {"tenant_burn", "fleet_frame"}
    assert psvc.manager_payload() == {"tenant_burn": jpayload["tenant_burn"]}
    assert psvc.fleet.series.totals(3600.0, pfleet.COUNTERS) == \
        jsvc.fleet.series.totals(3600.0, jfleet.COUNTERS)
    assert _masked_decisions(psvc.fleet) == _masked_decisions(jsvc.fleet)
    kinds = {d["kind"] for d in _masked_decisions(psvc.fleet)}
    assert {"handout", "quarantine", "back_source"} <= kinds
    assert _masked_hosts(psvc.fleet) == _masked_hosts(jsvc.fleet)
    assert psvc._fleet_gauges() == jsvc._fleet_gauges()


async def _straggler_session(sess: Session, clock: Clock) -> dict:
    """Five parents of one task; a reporter on hR says h4 serves at 50x
    the others' cost; then a child registers: h4 is flagged and
    filtered."""
    svc = sess.svc
    hosts = {n: _host(n, 7000 + i, 9000 + i)
             for i, n in enumerate(("h0", "h1", "h2", "h3", "h4", "hR",
                                    "hC"))}
    for h in hosts.values():
        await sess.call("announce", svc.announce_host, dict(h))
    streams = []
    for i in range(5):
        s = await sess.open(f"p{i}", "ts", hosts[f"h{i}"])
        streams.append(s)
        await sess.send(s, {"type": "register"})
        await sess.answer(s, f"p{i} register")
        await sess.send(s, {"type": "download_started",
                            "content_length": 4 << 20,
                            "piece_size": 1 << 20, "total_piece_count": 4},
                        {"type": "pieces_finished",
                         "pieces": _reports(range(4))},
                        {"type": "download_finished",
                         "content_length": 4 << 20, "piece_size": 1 << 20,
                         "total_piece_count": 4})
    r = await sess.open("pR", "tr", hosts["hR"])
    await sess.send(r, {"type": "register"})
    await sess.answer(r, "pR register")
    for round_ in range(3):
        for i in range(5):
            clock.t += 0.5
            cost = 500 if i == 4 else 10
            await sess.send(r, {"type": "pieces_finished", "pieces": [
                {**p, "piece_num": p["piece_num"] + 4 * (5 * round_ + i)}
                for p in _reports(range(4), parent=f"p{i}", cost=cost)]})
    clock.t += 5.0
    c = await sess.open("pC", "ts", hosts["hC"])
    await sess.send(c, {"type": "register"})
    await sess.answer(c, "pC register")
    for s in streams + [r, c]:
        await s.to_sched.put(None)
    await asyncio.wait_for(asyncio.gather(*sess.serving), 10)
    return {"stragglers": sorted(svc.fleet.scorecards._stragglers)}


def test_a_slow_parent_is_flagged_and_filtered_in_both(clocked):
    def run(pkg):
        clocked.t = 1000.0

        async def go():
            svc = _service(pkg, clocked, min_serve_samples=4,
                           min_population=4)
            sess = Session(svc, jcodec if pkg == "jax" else pcodec,
                           JDfError if pkg == "jax" else DfError)
            out = await _straggler_session(sess, clocked)
            return svc, sess, out

        return asyncio.run(asyncio.wait_for(go(), 60))

    jsvc, jsess, jout = run("jax")
    psvc, psess, pout = run("port")
    assert pout == jout == {"stragglers": ["h4"]}
    assert psess.log == jsess.log
    handout = next(out for what, out in psess.log if what == "pC register")
    assert handout["type"] == "normal_task"
    assert "h4" not in {p["host"]["id"] for p in handout["parents"]}
    decisions = _masked_decisions(psvc.fleet)
    assert decisions == _masked_decisions(jsvc.fleet)
    filtered = [d for d in decisions if d["kind"] == "straggler_filter"]
    assert filtered and {d["host"] for d in filtered} == {"h4"}
    assert all(d["task"] == "ts" and d["peer"] == "pC" for d in filtered)
    assert _masked_hosts(psvc.fleet) == _masked_hosts(jsvc.fleet)
