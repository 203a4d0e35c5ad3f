"""The port's pod lens (``dragonfly2_tpu_torch/pkg/podlens.py``) against
the JAX one (``dragonfly2_tpu/pkg/podlens.py``), exactly.

The same seeded digests and clock samples (numpy, fixed seeds) go through
both modules on one injected clock: ``ClockEstimator`` estimates,
``note_flight`` reductions (the stored MessagePack bytes: the port packs
with its own codec, JAX with ``msgpack``), ``timeline``,
``render_timeline``, ``resident_bytes``, the LRU cut and
``completion_stats``. Then a JAX and a port ``SchedulerService``, both
with the pod lens on, given the same daemons' announces and terminal
flights, answer ``Scheduler.PodTimeline`` alike. The cases of
``tests/test_podlens.py``'s timeline and estimator classes run on both
packages. Tolerance 0 throughout: the same float operations in the same
order.
"""

from __future__ import annotations

import asyncio
import random

import numpy as np
import pytest

from dragonfly2_tpu.pkg import flight as jflight
from dragonfly2_tpu.pkg import podlens as jlens
from dragonfly2_tpu_torch.pkg import flight as pflight
from dragonfly2_tpu_torch.pkg import podlens as plens

PKGS = {"jax": jlens, "port": plens}


def _digest(rng: np.random.Generator, task: str, host_wall0: float, *,
            pieces: int = 6, clock=None) -> dict:
    """A digest of the shape ``pkg/flight.digest`` ships, seeded."""
    phases = {ph: round(float(rng.uniform(0.0, 2.0)), 6)
              for ph in jflight.PHASES}
    wall = round(sum(phases.values()) + float(rng.uniform(0.0, 0.5)), 6)
    segs, t = [], 0.0
    for ph in rng.permutation(list(jflight.PHASES))[:5]:
        d = float(rng.uniform(0.01, 0.4))
        segs.append([round(t, 4), round(t + d, 4), str(ph)])
        t += d
    rows = []
    for n in range(pieces):
        tr = round(float(rng.uniform(0, 1)), 4)
        fb = round(tr + float(rng.uniform(0, 0.1)), 4) if n % 3 else -1.0
        rows.append([n, 1, tr, fb, round(tr + 0.2, 4), 1, "", "10.0.0.1:1"])
    d = {"v": 1, "task_id": task, "state": "done", "note": "",
         "start_wall": host_wall0, "wall_s": wall, "phases": phases,
         "other_s": round(float(rng.uniform(0, 0.3)), 6),
         "dominant_phase": max(phases, key=phases.get), "segments": segs,
         "pieces": rows, "pieces_total": pieces, "pieces_truncated": False,
         "events": [[0.1, "register", -1, ""]], "events_total": 9,
         "events_dropped": 0, "bytes": 1234}
    if clock:
        d["clock"] = clock
    return d


def _pair(**kw):
    """A JAX and a port lens, each on its own fixed fake clock."""
    clock = [500.0]
    return clock, tuple(
        m.PodLens(clock_estimator=m.ClockEstimator(
            clock=lambda: clock[0], **kw.pop("est", {})), **kw)
        for m in (jlens, plens))


def test_constants_match():
    for name in ("DRIFT_PPM", "MIN_ERR_S", "UNALIGNED_ERR_S",
                 "PHASE_CHARS"):
        assert getattr(jlens, name) == getattr(plens, name), name
    assert jlens.PodLens._KEEP == plens.PodLens._KEEP
    assert jlens.PodLens._MAX_SEGMENTS == plens.PodLens._MAX_SEGMENTS


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clock_estimator_matches(seed):
    """Seeded samples with jitter and asymmetric legs, malformed ones
    among them, an LRU host cap, and estimates as the samples age."""
    rng = np.random.default_rng(seed)
    clock = [0.0]
    ests = [m.ClockEstimator(max_hosts=8, clock=lambda: clock[0])
            for m in (jlens, plens)]
    for i in range(200):
        host = f"h{int(rng.integers(0, 12))}"
        ts = float(rng.uniform(1, 1000))
        off = float(rng.uniform(-2, 2))
        up, down = rng.uniform(0.0005, 0.04, 2)
        t0, t1, echo = ts + off, ts + up + down + off, ts + up
        if i % 17 == 0:
            t1 = t0 - 1.0                  # negative rtt: rejected
        if i % 23 == 0:
            echo = 0.0                     # no echo: rejected
        clock[0] += float(rng.uniform(0, 30))
        assert ests[0].add_sample(host, t0, t1, echo) == ests[1].add_sample(
            host, t0, t1, echo)
    assert ests[0].hosts_tracked() == ests[1].hosts_tracked() == 8
    for age in (0.0, 60.0, 3600.0):
        clock[0] += age
        for h in range(12):
            assert ests[0].estimate(f"h{h}") == ests[1].estimate(f"h{h}")
    assert list(ests[0]._hosts) == list(ests[1]._hosts)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_note_flight_timeline_render_and_resident_bytes_match(seed):
    """The reductions' bytes, the merged timeline, its text, the stored
    hosts and ``resident_bytes`` are equal; with ``extra`` digests too."""
    rng = np.random.default_rng(seed)
    clock, (j, p) = _pair()
    for t in range(3):
        task = f"task-{seed}-{t}"
        for h in range(5):
            off = float(rng.uniform(-1, 1))
            sched = 1000.0 + t
            clock_samples = [[round(sched - 0.001 + off, 6),
                              round(sched + 0.002 + off, 6), sched]]
            d = _digest(rng, task, round(sched + off, 6),
                        pieces=int(rng.integers(0, 9)),
                        clock=clock_samples if h % 2 else None)
            if h == 4:
                d["segments"] = d["segments"] * 20   # over _MAX_SEGMENTS
            for lens in (j, p):
                lens.note_flight(task, f"host-{h}", d, peer_id=f"peer-{h}")
        for host in range(5):
            assert j._tasks[task][f"host-{host}"] == \
                p._tasks[task][f"host-{host}"]
        extra = {"pulled": _digest(rng, task, 1000.5)}
        assert j.digests_for(task) == p.digests_for(task)
        assert j.shipped_hosts(task) == p.shipped_hosts(task)
        jr, pr = j.timeline(task, extra=extra), p.timeline(task, extra=extra)
        assert jr == pr
        for width in (24, 48, 80):
            assert jlens.render_timeline(jr, width) == \
                plens.render_timeline(pr, width)
    assert j.tasks() == p.tasks()
    assert j.resident_bytes() == p.resident_bytes()
    assert j.timeline("absent") is None and p.timeline("absent") is None


def test_lru_cut_and_unserializable_digest_match():
    clock, (j, p) = _pair(max_tasks=4)
    rng = np.random.default_rng(5)
    for i in range(12):
        d = _digest(rng, f"t{i}", 10.0 + i)
        for lens in (j, p):
            lens.note_flight(f"t{i}", "h", d)
    assert list(j._tasks) == list(p._tasks) == [f"t{i}" for i in range(8, 12)]
    bad = _digest(rng, "bad", 1.0)
    bad["note"] = object()
    for lens in (j, p):
        lens.note_flight("t11", "h2", bad)        # dropped, not stored
        lens.note_flight("t11", "h3", "not a dict")
        assert set(lens.shipped_hosts("t11")) == {"h"}
    assert j.resident_bytes() == p.resident_bytes()


@pytest.mark.parametrize("seed", range(6))
def test_completion_stats_match(seed):
    rng = np.random.default_rng(seed)
    d = _digest(rng, "t", 1.0, pieces=int(rng.integers(0, 7)))
    if seed == 5:
        d["pieces"].append(["malformed"])
        d["wall_s"] = 0.0
    assert jlens.completion_stats(d) == plens.completion_stats(d)


# The cases of tests/test_podlens.py's estimator and merge classes, run
# on both packages.

@pytest.mark.parametrize("pkg", PKGS)
def test_error_within_bound_under_jitter_and_asymmetry(pkg):
    m = PKGS[pkg]
    rng = random.Random(1234)
    clock = [0.0]
    est = m.ClockEstimator(clock=lambda: clock[0])
    truths = {}
    for h in range(100):
        true_off = rng.uniform(-2.0, 2.0)
        truths[f"h{h}"] = true_off
        for _ in range(6):
            ts = rng.uniform(0, 1000)
            d_up = rng.uniform(0.0005, 0.040)
            d_down = rng.uniform(0.0005, 0.040)
            assert est.add_sample(f"h{h}", ts + true_off,
                                  ts + d_up + d_down + true_off, ts + d_up)
    for host, true_off in truths.items():
        off, err, n = est.estimate(host)
        assert n >= 1 and abs(off - true_off) <= err
        assert err <= 0.040 / 2 + 0.005


@pytest.mark.parametrize("pkg", PKGS)
def test_slowest_host_dominant_phase_and_render(pkg):
    m = PKGS[pkg]

    def mk(wall, stall=0.0, dcn=1.0):
        segs = ([[0.0, stall, "stall"]] if stall else []) + [
            [stall, stall + dcn, "dcn"]]
        return {"v": 1, "task_id": "m", "state": "done", "start_wall": 10.0,
                "wall_s": wall, "phases": {
                    "sched_wait": 0.0, "dcn": dcn, "ici": 0.0,
                    "verify": 0.0, "store": 0.0, "stall": stall,
                    "origin": 0.0},
                "other_s": 0.0, "dominant_phase": "dcn", "segments": segs,
                "pieces": [[0, 1, 0.0, 0.01, dcn, 1, "", "p:1"]],
                "pieces_total": 1}

    lens = m.PodLens()
    lens.note_flight("m", "fast", mk(0.5, dcn=0.5))
    lens.note_flight("m", "laggard", mk(4.0, stall=3.0, dcn=1.0))
    rep = lens.timeline("m")
    assert rep["slowest_host"] == "laggard"
    assert rep["dominant_phase"] == "stall"
    assert rep["hosts"][0]["host"] == "laggard"
    text = m.render_timeline(rep)
    assert "slowest=laggard" in text and "*laggard" in text
    assert "!" in text and "=" in text and "legend:" in text


# --------------------------------------------------------------------- #
# Scheduler.PodTimeline: a JAX and a port scheduler, the same flights
# --------------------------------------------------------------------- #

def _flight(mod, task: str, pieces: int, offset: float, clock_samples):
    """A finished task flight's digest through a package's flight
    module."""
    tf = mod.TaskFlight(task)
    tf.start_wall = 2000.0 + offset
    tf.record(mod.EV_REGISTER)
    tf.record(mod.EV_SCHEDULED, -1, 0.0, "normal_task")
    for n in range(pieces):
        tf.record(mod.EV_REQUEST, n, 0.0, "10.0.0.1:80")
        tf.record(mod.EV_FIRST_BYTE, n)
        tf.record(mod.EV_LANDED, n, 3.0, "cross")
    tf.record(mod.EV_HBM_START)
    tf.record(mod.EV_HBM_LANDED)
    tf.finish("done")
    return mod.digest(tf, clock_samples=clock_samples)


class FakeStream:
    def __init__(self, open_body):
        self.open_body = open_body
        self.to_sched: asyncio.Queue = asyncio.Queue()
        self.to_peer: asyncio.Queue = asyncio.Queue()

    async def send(self, body):
        await self.to_peer.put(body)

    async def recv(self, timeout=None):
        return await self.to_sched.get()


def _services(**podlens) -> dict:
    """A JAX and a port service, seed peer and fleet off (the fleet's own
    file holds it), the pod lens as given."""
    from dragonfly2_tpu.scheduler.config import SchedulerConfig as JConfig
    from dragonfly2_tpu.scheduler.service import SchedulerService as JSvc
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService

    jcfg = JConfig()
    jcfg.seed_peer_enabled = False
    jcfg.fleet.enabled = False
    jcfg.scheduling.retry_interval = 0.05
    for k, v in podlens.items():
        setattr(jcfg.podlens, k, v)
    pcfg = SchedulerConfig.from_dict({
        "seed_peer_enabled": False, "fleet": {"enabled": False},
        "scheduling": {"retry_interval": 0.05}, "podlens": podlens})
    return {"jax": JSvc(jcfg), "port": SchedulerService(pcfg)}


async def _session(svc, task: str, hosts, digests, *, ship: int):
    """Each host announces (its clock sample) and registers on ``task``;
    the first ``ship`` hosts ship their terminal digest."""
    for i, (h, off) in enumerate(hosts):
        await svc.announce_host({
            "id": h, "hostname": h, "ip": "127.0.0.1", "port": 9000 + i,
            "upload_port": 9100 + i,
            "clock": {"t0": 1999.0 + off, "t1": 1999.002 + off,
                      "echo": 1999.001}}, None)
        stream = FakeStream({
            "host": {"id": h, "hostname": h, "ip": "127.0.0.1",
                     "port": 9000 + i, "upload_port": 9100 + i},
            "peer_id": f"peer-{i}", "task_id": task, "url": "http://o/f"})
        server = asyncio.ensure_future(svc.announce_peer(stream, None))
        await stream.to_sched.put({"type": "register"})
        await asyncio.wait_for(stream.to_peer.get(), timeout=30)
        if i < ship:
            await stream.to_sched.put({"type": "download_finished",
                                       "content_length": 8,
                                       "flight": digests[h]})
        await stream.to_sched.put(None)
        await asyncio.wait_for(server, timeout=30)


def test_pod_timeline_of_a_jax_and_a_port_scheduler_match(run_async):
    """Both services with the pod lens on: three hosts announce and
    register, two ship their digests, and the third's is pulled on demand
    (``pull_missing``) from a fake seed-client pool. The
    ``Scheduler.PodTimeline`` answers (report and text) are equal, and
    so are the SLO engines' reports. The digests are built by the JAX
    flight module and handed to both; the port's flight module builds
    the same keys."""
    services = _services()
    task = "pod-task"
    hosts = [("host-0", -0.5), ("host-1", 0.25), ("host-2", 0.8)]
    digests = {h: _flight(jflight, task, 4 + i, off, [
        [2000.0 + off - 0.001, 2000.0 + off + 0.001, 2000.0]])
        for i, (h, off) in enumerate(hosts)}
    port_digest = _flight(pflight, task, 4, hosts[0][1], [])
    assert set(port_digest) | {"clock"} == set(digests["host-0"])

    async def drive(svc):
        pulled = []

        async def fake_pull(host, task_id):
            pulled.append((host.id, task_id))
            return digests.get(host.id)

        svc.seed_clients.flight_digest = fake_pull
        await _session(svc, task, hosts, digests, ship=2)
        out = await svc.pod_timeline({"task_id": task}, None)
        assert await svc.pod_timeline_report("absent") is None
        return out, svc.slo.evaluate(now=1e6), pulled

    got = {name: run_async(drive(svc), timeout=60)
           for name, svc in services.items()}
    (jans, jslo, jpulled), (pans, pslo, ppulled) = got["jax"], got["port"]
    assert jans == pans
    assert jpulled == ppulled == [("host-2", task)]
    assert jans["report"]["hosts_total"] == 3
    assert {h["host"] for h in jans["report"]["hosts"]} == {
        h for h, _ in hosts}
    assert jslo == pslo
    assert jslo["completions_total"] == 2
    for name, svc in services.items():
        assert set(svc.pod_lens.digests_for(task)) == {"host-0", "host-1"}


@pytest.mark.parametrize("over", [{"enabled": False},
                                  {"slo_enabled": False},
                                  {"pull_missing": 0}],
                         ids=["lens-off", "slo-off", "no-pull"])
def test_podlens_options_match(run_async, over):
    """The pod lens's options as the JAX service reads them: off removes
    the lens and the engine (``Scheduler.PodTimeline`` answers
    PeerTaskNotFound), ``slo_enabled=False`` the engine only,
    ``pull_missing=0`` merges the shipped digests alone."""
    from dragonfly2_tpu.pkg.errors import DfError as JDfError
    from dragonfly2_tpu_torch.pkg.errors import DfError

    services = _services(**over)
    task = "opt-task"
    hosts = [("h0", 0.1), ("h1", -0.1)]
    digests = {h: _flight(jflight, task, 3, off, []) for h, off in hosts}

    async def drive(svc, err):
        async def fake_pull(host, task_id):
            return digests.get(host.id)

        svc.seed_clients.flight_digest = fake_pull
        await _session(svc, task, hosts, digests, ship=1)
        try:
            answer = await svc.pod_timeline({"task_id": task}, None)
        except err as e:
            answer = (int(e.code), e.message)
        return (answer, svc.pod_lens is None, svc.slo is None)

    j = run_async(drive(services["jax"], JDfError), timeout=60)
    p = run_async(drive(services["port"], DfError), timeout=60)
    assert j == p
    if over.get("pull_missing") == 0:
        assert j[0]["report"]["hosts_total"] == 1
