"""The port's runtime observatory (``dragonfly2_tpu_torch/pkg/prof.py``)
against the JAX one (``dragonfly2_tpu/pkg/prof.py``).

- ``ProfConfig``: the same fields and defaults, and the daemon's, the
  scheduler's and the manager's ``prof`` blocks are this class.
- The loop-lag probe's summary and its SLO feed (``wedged_seconds``)
  equal for the same injected lags at injected instants; the GC
  observatory's summary equal for the same injected ``gc.callbacks``
  phases on one patched ``perf_counter``.
- The flight stamps: a slow tick and a slow pause stamp the same typed
  events into the running flights of each package's recorder, none into
  a finished one; a failed task's post-mortem bundle carries the
  ``runtime`` snapshot with the same keys.
- The sampler: both samplers folded over one parked, named thread give
  the same report and folded stacks for it.
- ``install``/``release`` refcount one process singleton in each
  package, and ``fallback_snapshot`` has the JAX keys.

The cases of ``tests/test_prof.py`` that need no daemon run on both
packages. The sampler's own threads carry ``df-`` names (the port-rules
scan checks every port source).
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import threading
import time

import pytest

from dragonfly2_tpu.pkg import flight as jflight
from dragonfly2_tpu.pkg import prof as jprof
from dragonfly2_tpu_torch.pkg import flight as pflight
from dragonfly2_tpu_torch.pkg import prof as pprof

PKGS = {"jax": (jprof, jflight), "port": (pprof, pflight)}


def test_the_config_matches_and_backs_every_role():
    from dragonfly2_tpu_torch.daemon.config import DaemonConfig
    from dragonfly2_tpu_torch.manager.config import ManagerConfig
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig

    assert dataclasses.asdict(jprof.ProfConfig()) == dataclasses.asdict(
        pprof.ProfConfig())
    for cfg in (DaemonConfig(), SchedulerConfig(), ManagerConfig()):
        assert type(cfg.prof) is pprof.ProfConfig
    over = {"prof": {"enabled": False, "hz": 7.0, "lag_ring": 64}}
    for cfg in (DaemonConfig.from_dict(over),
                SchedulerConfig.from_dict(over),
                ManagerConfig.from_dict(over)):
        assert (cfg.prof.enabled, cfg.prof.hz, cfg.prof.lag_ring) == (
            False, 7.0, 64)


def test_metric_families_keep_the_jax_names():
    for name in ("SAMPLES_TOTAL", "TRUNCATED_TOTAL", "LAG_SECONDS",
                 "SLOW_TICKS_TOTAL", "GC_PAUSE_SECONDS",
                 "GC_COLLECTIONS_TOTAL", "RSS_BYTES", "OPEN_FDS",
                 "THREADS_GAUGE", "CTX_SWITCHES"):
        j, p = getattr(jprof, name), getattr(pprof, name)
        assert j._original_name == p.name, name
        assert tuple(j._labelnames) == p.labelnames, name
    assert jprof._LAG_EDGES == pprof._LAG_EDGES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_lag_summaries_and_slo_feed_match(seed, monkeypatch):
    """The same lags at the same monotonic instants (each module's
    ``time.monotonic`` patched to one fake clock), a ring that wraps,
    then ``wedged_seconds`` over several windows and thresholds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clock = [1000.0]
    for mod in (jprof, pprof):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    probes = [mod.LoopLagProbe(mod.RuntimeObservatory(
        mod.ProfConfig(enabled=False)), "ut", 0.05, 0.25, 128)
        for mod in (jprof, pprof)]
    for _ in range(300):
        clock[0] += float(rng.uniform(0.0, 0.5))
        lag = float(rng.choice([0.0005, 0.003, 0.02, 0.3, 1.2, 6.0],
                               p=[0.5, 0.2, 0.15, 0.1, 0.04, 0.01]))
        for p in probes:
            p.note_lag(lag)
    assert probes[0].summary() == probes[1].summary()
    for window in (1.0, 10.0, 60.0, 3600.0):
        for threshold in (0.01, 0.25, 1.0):
            assert probes[0].wedged_seconds(window, threshold) == \
                probes[1].wedged_seconds(window, threshold)
    obs = [p.obs for p in probes]
    for o, p in zip(obs, probes):
        o.probes["ut"] = p
    assert obs[0].slo_probes()["loop_lag"](300.0, 0.25) == \
        obs[1].slo_probes()["loop_lag"](300.0, 0.25)


def test_gc_summaries_match(monkeypatch):
    """Injected ``gc.callbacks`` phases (start/stop pairs, a stop with no
    start, generations out of range) on one patched ``perf_counter``."""
    clock = [5.0]
    for mod in (jprof, pprof):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
    gcs = [mod.GCObservatory(mod.RuntimeObservatory(
        mod.ProfConfig(enabled=False)), slow_s=0.05)
        for mod in (jprof, pprof)]
    script = [("stop", {"generation": 0}, 0.0)]
    for i, pause in enumerate((0.001, 0.2, 0.0004, 0.07, 0.03)):
        script.append(("start", {"generation": i % 4}, 0.0))
        script.append(("stop", {"generation": i % 4 - 1, "collected": i,
                                "uncollectable": i // 2}, pause))
    for phase, info, advance in script:
        clock[0] += advance
        for g in gcs:
            g._cb(phase, info)
    j, p = (g.summary() for g in gcs)
    j.pop("tracked"), p.pop("tracked")
    assert j == p
    assert j["slow_pauses"] == 2 and sum(j["collections"]) == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_slow_tick_and_pause_stamp_running_flights(pkg):
    prof, flight = PKGS[pkg]
    rec = flight.FlightRecorder(max_tasks=8)
    rec.task("t-run")
    rec.task("t-done")
    rec.finish_task("t-done", "done")
    obs = prof.RuntimeObservatory(prof.ProfConfig(enabled=False),
                                  recorder=rec)
    p = prof.LoopLagProbe(obs, "ut", interval_s=0.05, slow_s=0.25)
    p.note_lag(0.8)
    p.note_lag(0.1)
    obs.gc.slow_s = 0.0
    obs.gc._cb("start", {"generation": 1})
    obs.gc._cb("stop", {"generation": 1})
    running = [(e[1], e[2], e[4]) for e in rec.get("t-run").events()]
    assert (flight.EV_LOOP_LAG, -1, "loop_lag") in running
    assert (flight.EV_GC_PAUSE, -1, "gc_pause") in running
    lag = [e for e in rec.get("t-run").events() if e[1] == flight.EV_LOOP_LAG]
    assert len(lag) == 1 and lag[0][3] == pytest.approx(0.8)
    assert not [e for e in rec.get("t-done").events()
                if e[1] in (flight.EV_LOOP_LAG, flight.EV_GC_PAUSE)]


def test_the_stamped_flights_analyze_alike():
    """The same runtime events in each package's flight fold into the
    same ``runtime`` summary and the same advisory line."""
    reports = []
    for _, flight in PKGS.values():
        tf = flight.TaskFlight("rt-task")
        tf.record(flight.EV_REGISTER)
        tf.record(flight.EV_LOOP_LAG, -1, 0.7, "loop_lag")
        tf.record(flight.EV_LOOP_LAG, -1, 0.3, "loop_lag")
        tf.record(flight.EV_GC_PAUSE, -1, 0.12, "gc_pause")
        tf.finish("done", "")
        rep = flight.analyze(tf)
        reports.append((rep["runtime"], flight.runtime_advisory(rep)))
    assert reports[0] == reports[1]
    assert "event loop wedged 2x" in reports[0][1]


@pytest.mark.parametrize("pkg", PKGS)
def test_postmortem_bundle_embeds_runtime_snapshot(pkg, tmp_path):
    prof, flight = PKGS[pkg]
    rec = flight.FlightRecorder(dump_dir=str(tmp_path), max_tasks=8)
    obs = prof.RuntimeObservatory(prof.ProfConfig(enabled=False),
                                  recorder=rec)
    rec.runtime = obs
    obs.probes["ut"] = p = prof.LoopLagProbe(obs, "ut")
    rec.task("doomed")
    p.note_lag(0.9)
    rec.finish_task("doomed", "failed", "chaos")
    bundles = glob.glob(str(tmp_path / "flight-*.json.gz"))
    assert len(bundles) == 1
    with gzip.open(bundles[0], "rt") as f:
        bundle = json.load(f)
    rt = bundle["runtime"]
    assert set(rt) == {"prof", "loops", "gc", "proc"}
    assert set(rt["prof"]) == {"samples", "truncated", "threads"}
    assert rt["loops"][0]["slow_ticks"] == 1
    assert bundle["report"]["runtime"]["loop_lag"]["count"] == 1


def test_postmortem_and_runtime_report_keys_match():
    obs = [mod.RuntimeObservatory(mod.ProfConfig(enabled=False))
           for mod in (jprof, pprof)]
    j, p = (o.postmortem() for o in obs)
    assert set(j) == set(p) and set(j["prof"]) == set(p["prof"])
    assert set(j["gc"]) == set(p["gc"]) and set(j["proc"]) == set(p["proc"])
    j, p = (o.runtime_report() for o in obs)
    assert set(j) == set(p) == {"loops", "gc", "proc", "uptime_s"}
    assert set(jprof.proc_stats()) == set(pprof.proc_stats())
    assert set(jprof.fallback_snapshot()) == set(pprof.fallback_snapshot())


def test_both_samplers_fold_one_parked_thread_alike():
    """A thread parked in a known frame, sampled 25 times by each
    package's sampler (``_sample_once`` called here, no sampler thread):
    its per-thread report and its folded lines are equal."""
    stop = threading.Event()
    ready = threading.Event()

    def park_here():
        ready.set()
        stop.wait(30)

    t = threading.Thread(target=park_here, daemon=True,
                         name="df-ut-parked")
    t.start()
    ready.wait(10)
    time.sleep(0.05)
    samplers = [mod.StackSampler(hz=50) for mod in (jprof, pprof)]
    try:
        for _ in range(25):
            for s in samplers:
                with s._lock:
                    s._sample_once()
    finally:
        stop.set()
        t.join(5)
    j, p = (s.report(10) for s in samplers)
    assert j["threads"]["df-ut-parked"] == p["threads"]["df-ut-parked"]
    assert j["threads"]["df-ut-parked"]["samples"] == 25
    assert any(f["frame"].endswith(":wait")
               for f in j["threads"]["df-ut-parked"]["top_self"])

    def parked(s):
        return [line for line in s.folded().splitlines()
                if line.startswith("df-ut-parked;")]

    assert parked(samplers[0]) == parked(samplers[1]) != []
    assert j["samples"] == p["samples"] == 25


@pytest.mark.parametrize("pkg", PKGS)
def test_node_cap_degrades_to_truncation_counter(pkg):
    """A stack 30 frames deep against a 4-node trie: the trie stops
    growing and counts the truncation."""
    prof, _ = PKGS[pkg]
    release, ready = threading.Event(), threading.Event()

    def deep(n):
        if n:
            return deep(n - 1)
        ready.set()
        release.wait(30)

    t = threading.Thread(target=deep, args=(30,), daemon=True,
                         name="df-ut-deep")
    t.start()
    ready.wait(10)
    s = prof.StackSampler(hz=1, max_nodes=4, max_depth=48)
    try:
        with s._lock:
            s._sample_once()
    finally:
        release.set()
        t.join(10)
    assert s.nodes <= 4 and s.truncated >= 1
    rep = s.report()
    assert rep["max_nodes"] == 4 and rep["truncated"] == s.truncated


def test_install_and_release_refcount_one_singleton_per_package():
    held = pprof.observatory()   # one another test left installed, if any
    a = pprof.install(pprof.ProfConfig(hz=50))
    b = pprof.install(pprof.ProfConfig(hz=7))
    try:
        assert a is b and pprof.observatory() is a
        assert a.cfg.hz == (50 if held is None else held.cfg.hz)
        names = [x.name for x in threading.enumerate()]
        # One sampler thread for the port's singleton (the JAX package's
        # singleton, when one runs here, names its thread alike).
        assert 1 <= names.count("df-prof-sampler") <= 2
    finally:
        pprof.release(b)
        assert pprof.observatory() is a
        pprof.release(a)
    assert pprof.observatory() is held
    private = pprof.RuntimeObservatory(pprof.ProfConfig())
    private.start()
    pprof.release(private)
    assert private.sampler._thread is None


def test_an_armed_probe_measures_a_real_wedge(run_async):
    async def body():
        obs = pprof.RuntimeObservatory(pprof.ProfConfig(
            enabled=False, lag_interval_s=0.02, lag_slow_s=0.15))
        p = obs.arm_loop("ut-wedge")
        try:
            await __import__("asyncio").sleep(0.08)
            time.sleep(0.3)
            await __import__("asyncio").sleep(0.08)
        finally:
            p.disarm()
        s = p.summary()
        assert s["max_lag_s"] >= 0.2 and s["slow_ticks"] >= 1

    run_async(body(), timeout=30)
