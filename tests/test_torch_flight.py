"""The port's flight recorder against the JAX package's.

``dragonfly2_tpu_torch/pkg/flight.py`` is a copy of
``dragonfly2_tpu/pkg/flight.py`` (its ring takes a lock, since the port's
downloader and upload server record from worker threads). Each module's
clock is replaced by the same injected one (``time.perf_counter`` and the
anchors of ``anchored_wall``), and the same seeded event sequences (numpy
``RandomState``) go to a ``TaskFlight`` of each package: ``analyze``,
``render_waterfall``, ``digest`` (with clock samples, under tight byte
caps too) and every piece's ``piece_report_timings`` must be equal, ring
overflow included. ``FlightRecorder``'s eviction, ``summary``,
``finish_task`` (the ``peer_task_phase_seconds`` histogram, whose
exposition is compared line for line, and the post-mortem bundle) and
``PodAggregator`` are held the same way. Tolerance 0.
"""

from __future__ import annotations

import gzip
import json
import time
import types
import uuid

import numpy as np
import pytest

from dragonfly2_tpu.pkg import flight as jflight
from dragonfly2_tpu.pkg import metrics as jmetrics
from dragonfly2_tpu_torch.pkg import flight as pflight
from dragonfly2_tpu_torch.pkg import metrics as pmetrics


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    """One injected monotonic clock in both modules, and the same anchors
    for their anchored wall clocks."""
    c = Clock()
    for mod in (jflight, pflight):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=c, time=time.time))
        monkeypatch.setattr(mod, "_WALL_ANCHOR", 1.7e9)
        monkeypatch.setattr(mod, "_PC_ANCHOR", 900.0)
    return c


def _events(seed: int, pieces: int) -> list:
    """A seeded task timeline: (step_s, code, piece, aux, note)."""
    rng = np.random.RandomState(seed)
    out = [(0.001, jflight.EV_REGISTER, -1, 0.0, ""),
           (float(rng.uniform(0.001, 0.3)), jflight.EV_SCHEDULED, -1, 0.0,
            "normal_task")]
    parents = ["10.0.0.1:65002", "10.0.0.2:65002", "10.0.0.3:65002"]
    for n in rng.permutation(pieces):
        n = int(n)
        kind = rng.randint(10)
        parent = parents[rng.randint(len(parents))]
        if kind == 0:        # an origin piece
            out.append((float(rng.uniform(0, 0.05)),
                        jflight.EV_SOURCE_LANDED, n,
                        float(rng.uniform(0.1, 40.0)), ""))
        elif kind == 1:      # a failed attempt, then a landing
            out += [(float(rng.uniform(0, 0.02)), jflight.EV_REQUEST, n,
                     0.0, parent),
                    (float(rng.uniform(0, 0.6)), jflight.EV_FAILED, n, 0.0,
                     ["stall", "corrupt", "transport"][rng.randint(3)]),
                    (0.001, jflight.EV_REQUEST, n, 0.0, parent),
                    (float(rng.uniform(0, 0.05)), jflight.EV_LANDED, n,
                     float(rng.randint(1, 60)), "cross")]
        elif kind == 2:      # landed with no recorded request
            out.append((float(rng.uniform(0, 0.05)), jflight.EV_LANDED, n,
                        float(rng.randint(0, 50)),
                        ["intra", "cross", "unlabeled"][rng.randint(3)]))
        elif kind == 3:      # a request still open at the end
            out.append((float(rng.uniform(0, 0.01)), jflight.EV_REQUEST, n,
                        0.0, parent))
            continue
        else:                # request, first byte, store, landing, device
            out += [(float(rng.uniform(0, 0.02)), jflight.EV_REQUEST, n,
                     0.0, parent),
                    (float(rng.choice([0.001, 0.3])), jflight.EV_FIRST_BYTE,
                     n, 0.0, ""),
                    (float(rng.uniform(0, 0.05)), jflight.EV_STORE_START, n,
                     0.0, ""),
                    (float(rng.uniform(0, 0.02)), jflight.EV_STORED, n, 0.0,
                     ""),
                    (0.0005, jflight.EV_LANDED, n, float(rng.randint(1, 80)),
                     "unlabeled")]
        out += [(float(rng.uniform(0, 0.01)), jflight.EV_HBM_START, n, 0.0,
                 ""),
                (float(rng.uniform(0, 0.03)), jflight.EV_HBM_LANDED, n, 0.0,
                 "")]
        extra = rng.randint(12)
        if extra == 0:
            out += [(0.01, jflight.EV_RESCHEDULE, -1, 0.0, "starvation"),
                    (float(rng.uniform(0, 0.5)), jflight.EV_SCHED_ANSWER, -1,
                     0.0, "")]
        elif extra == 1:
            out.append((0.0, jflight.EV_PARENT_DROP, -1, 0.0, "peer-x"))
        elif extra == 2:
            out.append((0.0, jflight.EV_QUARANTINE, -1, 0.0,
                        f"{parent}|corrupt"))
        elif extra == 3:
            out.append((0.0, [jflight.EV_LOOP_LAG, jflight.EV_GC_PAUSE][
                rng.randint(2)], -1, float(rng.uniform(0, 2)), ""))
        elif extra == 4:
            out.append((float(rng.uniform(0, 0.01)),
                        [jflight.EV_DELTA_REUSE, jflight.EV_DELTA_FETCH][
                            rng.randint(2)], -1,
                        float(rng.uniform(0, 30)), "1048576"))
        elif extra == 5:
            out.append((0.0, jflight.EV_SCHED_PUSH, -1, 0.0, "normal_task"))
    out += [(0.002, jflight.EV_VERIFY_START, -1, 0.0, ""),
            (float(rng.uniform(0, 1)), jflight.EV_VERIFIED, -1, 0.0, "")]
    return out


def _play(clock, events, tfs) -> None:
    for step, code, piece, aux, note in events:
        clock.now += step
        for tf in tfs:
            tf.record(code, piece, aux, note)


CASES = [(seed, pieces, cap) for seed, pieces, cap in (
    (0, 12, 2048), (1, 40, 2048), (2, 149, 2048), (3, 149, 256),
    (4, 300, 4096), (5, 8, 64), (6, 64, 2048), (7, 200, 512))]


@pytest.mark.parametrize("seed,pieces,cap", CASES,
                         ids=[f"seed{c[0]}-{c[1]}p-cap{c[2]}" for c in CASES])
@pytest.mark.parametrize("state", ["done", "failed", "running"])
def test_the_same_events_fold_to_the_same_reports(clock, seed, pieces, cap,
                                                  state):
    jtf = jflight.TaskFlight("task-" + str(seed), cap, piece_track_cap=128,
                             wall_offset=0.25)
    ptf = pflight.TaskFlight("task-" + str(seed), cap, piece_track_cap=128,
                             wall_offset=0.25)
    events = _events(seed, pieces)
    _play(clock, events, (jtf, ptf))
    clock.now += 0.05
    if state != "running":
        jtf.finish(state, "boom" if state == "failed" else "")
        ptf.finish(state, "boom" if state == "failed" else "")
    clock.now += 0.5
    assert ptf.events() == jtf.events()
    assert (ptf.events_total, ptf.events_dropped) == (jtf.events_total,
                                                      jtf.events_dropped)
    for kw in ({}, {"max_waterfall": 16, "max_segments": 8},
               {"stall_ttfb_s": 0.05}):
        jr, pr = jflight.analyze(jtf, **kw), pflight.analyze(ptf, **kw)
        assert pr == jr
        assert pflight.render_waterfall(pr) == jflight.render_waterfall(jr)
        assert pflight.runtime_advisory(pr) == jflight.runtime_advisory(jr)
    samples = [(1.7e9 + i, 1.7e9 + i + 0.002, 1.7e9 + i + 0.0013)
               for i in range(6)]
    for kw in ({}, {"clock_samples": samples}, {"max_bytes": 2048},
               {"max_bytes": 600, "max_pieces": 32}):
        jd, pd = jflight.digest(jtf, **kw), pflight.digest(ptf, **kw)
        assert pd == jd
        assert pflight.digest_piece_rows(pd) == jflight.digest_piece_rows(jd)
        assert json.dumps(pd, separators=(",", ":")) == json.dumps(
            jd, separators=(",", ":"))
    for n in range(-1, pieces + 1):
        assert ptf.piece_report_timings(n) == jtf.piece_report_timings(n)
    assert ptf.wall_now() == jtf.wall_now()


def test_the_vocabulary_is_the_jax_one():
    names = [n for n in dir(jflight) if n.startswith("EV_")]
    assert names == [n for n in dir(pflight) if n.startswith("EV_")]
    for n in names:
        assert getattr(pflight, n) == getattr(jflight, n)
    assert pflight.EVENT_NAMES == jflight.EVENT_NAMES
    assert pflight.PHASES == jflight.PHASES
    assert pflight._PRIORITY == jflight._PRIORITY
    assert (pflight.STALL_TTFB_S, pflight.DIGEST_MAX_BYTES,
            pflight.DIGEST_PIECE_FIELDS) == (jflight.STALL_TTFB_S,
                                             jflight.DIGEST_MAX_BYTES,
                                             jflight.DIGEST_PIECE_FIELDS)
    assert pflight.PHASE_SECONDS.name == "peer_task_phase_seconds"
    assert pflight.PHASE_SECONDS.labelnames == ("phase",)
    assert pflight.PHASE_SECONDS.buckets[:-1] == tuple(
        jflight.PHASE_SECONDS._upper_bounds[:-1])


@pytest.mark.parametrize("seed", range(4))
def test_eviction_and_finish_task_match(clock, seed):
    rng = np.random.RandomState(seed)
    jrec = jflight.FlightRecorder(capacity=64, max_tasks=5)
    prec = pflight.FlightRecorder(capacity=64, max_tasks=5)
    ids = [f"t{i}" for i in range(12)]
    for _ in range(80):
        clock.now += float(rng.uniform(0, 0.2))
        tid = ids[rng.randint(len(ids))]
        op = rng.randint(4)
        if op == 0:
            state = ["done", "failed"][rng.randint(2)]
            jt = jrec.finish_task(tid, state, "n")
            pt = prec.finish_task(tid, state, "n")
            assert (pt is None) == (jt is None)
            if pt is not None:
                assert (pt.state, pt.note) == (jt.state, jt.note)
        else:
            code = [jflight.EV_REQUEST, jflight.EV_LANDED,
                    jflight.EV_HBM_START][op - 1]
            piece = int(rng.randint(8))
            jrec.task(tid).record(code, piece, 3.0, "p")
            prec.task(tid).record(code, piece, 3.0, "p")
        assert list(prec._tasks) == list(jrec._tasks)
        assert prec.summary() == jrec.summary()
        assert (prec.get(tid) is None) == (jrec.get(tid) is None)
    jrec.stamp_running(jflight.EV_LOOP_LAG, 0.4, "lag")
    prec.stamp_running(pflight.EV_LOOP_LAG, 0.4, "lag")
    for tid in jrec._tasks:
        assert prec.get(tid).events() == jrec.get(tid).events()


def _samples(text: str, name: str) -> list[str]:
    """The sample lines of one family, the namespace and the
    ``_created`` series left out."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        line = line.removeprefix("dragonfly_tpu_")
        if line.startswith(name) and not line.startswith(name + "_created"):
            out.append(line)
    return out


def test_finish_task_observes_the_same_histogram(clock, monkeypatch):
    """The phase histogram's exposition, line for line, after the same
    tasks finish in both packages (each module's histogram replaced by a
    fresh family of one name and the JAX buckets)."""
    name = "test_phase_seconds_" + uuid.uuid4().hex[:8]
    buckets = tuple(jflight.PHASE_SECONDS._upper_bounds[:-1])
    monkeypatch.setattr(jflight, "PHASE_SECONDS", jmetrics.histogram(
        name, "phases", ("phase",), buckets=buckets))
    monkeypatch.setattr(pflight, "PHASE_SECONDS", pmetrics.histogram(
        name, "phases", ("phase",), buckets=buckets))
    jrec, prec = jflight.FlightRecorder(), pflight.FlightRecorder()
    for seed in range(6):
        tid = f"task-{seed}"
        _play(clock, _events(seed, 30), (jrec.task(tid), prec.task(tid)))
        clock.now += 0.1
        jrec.finish_task(tid, "done")
        prec.finish_task(tid, "done")
    # A second finish is a no-op in both.
    assert prec.finish_task("task-0", "failed").state == "done"
    assert jrec.finish_task("task-0", "failed").state == "done"
    jtext = jmetrics.render()[0].decode()
    ptext = pmetrics.render()[0].decode()
    assert _samples(ptext, name) == _samples(jtext, name)
    assert len(_samples(ptext, name)) > 0
    assert f"# TYPE {name} histogram" in ptext


def test_a_failed_task_dumps_the_same_bundle(clock, tmp_path):
    bundles = {}
    for pkg, mod in (("jax", jflight), ("port", pflight)):
        rec = mod.FlightRecorder(dump_dir=str(tmp_path / pkg),
                                 keep_bundles=2)
        for seed in range(3):
            tid = f"failing-{seed}"
            _play(Clock(), _events(seed, 10), (rec.task(tid),))
            rec.finish_task(tid, "failed", "boom")
            time.sleep(0.002)   # distinct millisecond names
        files = sorted((tmp_path / pkg).iterdir())
        assert len(files) == 2           # pruned to keep_bundles
        bundles[pkg] = [json.load(gzip.open(f, "rt")) for f in files]
    strip = [{**b, "report": {**b["report"], "started_at": 0}}
             for b in bundles["jax"]]
    assert [{**b, "report": {**b["report"], "started_at": 0}}
            for b in bundles["port"]] == strip


def test_the_pod_aggregator_rolls_up_as_the_jax_one():
    rng = np.random.RandomState(3)
    jagg, pagg = jflight.PodAggregator(max_tasks=3), \
        pflight.PodAggregator(max_tasks=3)
    hosts = ["h1", "h2", "h3"]
    for _ in range(300):
        task = f"t{rng.randint(5)}"
        host = hosts[rng.randint(3)]
        op = rng.randint(5)
        if op == 0:
            args = (task, host, None, int(rng.randint(50)))
            jagg.note_piece(*args)
            pagg.note_piece(*args)
        elif op == 1:
            args = (task, host, {"dcn_ms": int(rng.randint(30)),
                                 "stall_ms": int(rng.randint(3)),
                                 "store_ms": int(rng.randint(9))})
            jagg.note_piece(*args)
            pagg.note_piece(*args)
        elif op == 2:
            args = (task, host, int(rng.randint(1, 9)),
                    (int(rng.randint(90)), int(rng.randint(9)),
                     int(rng.randint(20))))
            jagg.note_pieces(*args)
            pagg.note_pieces(*args)
        elif op == 3:
            jagg.note_failure(task, host, "corrupt")
            pagg.note_failure(task, host, "corrupt")
        else:
            jagg.note_quarantine(task, host, "stall")
            pagg.note_quarantine(task, host, "stall")
    for t in range(6):
        assert pagg.report(f"t{t}") == jagg.report(f"t{t}")


def test_worker_threads_record_into_one_ring_without_losing_events():
    """The port's ring takes a lock: more recording threads than cores,
    with a short switch interval, lose no event and leave no hole."""
    import os
    import sys
    import threading

    workers, each = 2 * (os.cpu_count() or 4) + 4, 400
    tf = pflight.TaskFlight("stress", capacity=workers * each,
                            piece_track_cap=workers * each)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(w):
            for i in range(each):
                tf.record(pflight.EV_REQUEST, w * each + i, 0.0, "")

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    events = tf.events()
    assert tf.events_total == len(events) == workers * each
    assert sorted(e[2] for e in events) == list(range(workers * each))
    assert len(tf._piece_track) == workers * each
