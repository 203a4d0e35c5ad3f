"""The port's scheduler parts against the JAX package's, unit by unit.

- The peer and task FSMs: every event from every state gives the same
  state or the same ``TransitionError`` text; the event tables match.
- The DAG: seeded sequences of edits give the same results, the same
  refusals (cycles, duplicates, missing vertices) and the same graph;
  ``random_vertices`` samples the same ids from a port ``Random(s)`` as
  the JAX DAG from the global generator after ``random.seed(s)``.
- The evaluator's scores are equal as floats over hypothesis-drawn hosts,
  peers and topologies (same slice, cross slice, no slice), and so is
  ``is_bad_node``; ``find_candidate_parents`` and
  ``schedule_candidate_parents`` return the same ids on seeded tasks
  larger than the filter limit; ``plan_stripe`` and the stripe piece
  math match over hypothesis-drawn memberships.
- The cases of ``tests/test_scheduler_unit.py`` and the scheduler cases
  of ``tests/test_stripe.py``, run again by package (``pkg``: "jax" or
  "port"); every JAX service here is built with ``fleet.enabled=False``
  and ``podlens.enabled=False``, as the port's is.

Tolerance 0 throughout: scores compare with ``==``.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import dragonfly2_tpu.pkg.dag as jdag
import dragonfly2_tpu.pkg.fsm as jfsm
import dragonfly2_tpu.scheduler.resource.peer as jpeer
import dragonfly2_tpu.scheduler.resource.task as jtask
import dragonfly2_tpu_torch.pkg.dag as pdag
import dragonfly2_tpu_torch.pkg.fsm as pfsm
import dragonfly2_tpu_torch.scheduler.resource.peer as ppeer
import dragonfly2_tpu_torch.scheduler.resource.task as ptask
from dragonfly2_tpu.pkg.piece import PieceInfo as JPieceInfo
from dragonfly2_tpu.pkg.types import HostType as JHostType
from dragonfly2_tpu.scheduler import config as jconfig
from dragonfly2_tpu.scheduler.resource import Host as JHost
from dragonfly2_tpu.scheduler.resource import Peer as JPeer
from dragonfly2_tpu.scheduler.resource import Task as JTask
from dragonfly2_tpu.scheduler.scheduling import Evaluator as JEvaluator
from dragonfly2_tpu.scheduler.scheduling import Scheduling as JScheduling
from dragonfly2_tpu.scheduler.scheduling import stripe as jstripe
from dragonfly2_tpu.scheduler.scheduling.scheduling import (
    ScheduleResult as JScheduleResult,
)
from dragonfly2_tpu.scheduler.service import SchedulerService as JService
from dragonfly2_tpu_torch.pkg.piece import PieceInfo
from dragonfly2_tpu_torch.pkg.types import HostType
from dragonfly2_tpu_torch.scheduler import config as pconfig
from dragonfly2_tpu_torch.scheduler.resource import Host, Peer, Task
from dragonfly2_tpu_torch.scheduler.scheduling import Evaluator, Scheduling
from dragonfly2_tpu_torch.scheduler.scheduling import stripe as pstripe
from dragonfly2_tpu_torch.scheduler.scheduling.scheduling import (
    ScheduleResult,
)
from dragonfly2_tpu_torch.scheduler.service import SchedulerService


def _jax_service(cfg=None):
    cfg = cfg or jconfig.SchedulerConfig()
    cfg.fleet.enabled = False
    cfg.podlens.enabled = False
    return JService(cfg)


def _port_service(cfg=None):
    cfg = cfg or pconfig.SchedulerConfig()
    cfg.fleet.enabled = False
    cfg.podlens.enabled = False
    return SchedulerService(cfg)


PKGS = {
    "jax": SimpleNamespace(
        Host=JHost, Peer=JPeer, Task=JTask, PeerState=jpeer.PeerState,
        TaskState=jtask.TaskState, HostType=JHostType, Evaluator=JEvaluator,
        Scheduling=JScheduling, ScheduleResult=JScheduleResult,
        config=jconfig, stripe=jstripe, PieceInfo=JPieceInfo,
        Service=JService, service=_jax_service),
    "port": SimpleNamespace(
        Host=Host, Peer=Peer, Task=Task, PeerState=ppeer.PeerState,
        TaskState=ptask.TaskState, HostType=HostType, Evaluator=Evaluator,
        Scheduling=Scheduling, ScheduleResult=ScheduleResult,
        config=pconfig, stripe=pstripe, PieceInfo=PieceInfo,
        Service=SchedulerService, service=_port_service),
}


@pytest.fixture(params=sorted(PKGS))
def ns(request):
    return PKGS[request.param]


# --------------------------------------------------------------------- #
# FSMs and the DAG
# --------------------------------------------------------------------- #

def _fsm_table(module_events, fsm_mod, states):
    out = {}
    for state in states:
        for ev in module_events:
            f = fsm_mod.FSM(state, module_events)
            try:
                f.event(ev.name)
                out[(state, ev.name)] = ("ok", f.current)
            except fsm_mod.TransitionError as e:
                out[(state, ev.name)] = ("error", str(e), e.event, e.state)
        f = fsm_mod.FSM(state, module_events)
        try:
            f.event("no_such_event")
        except fsm_mod.TransitionError as e:
            out[(state, "no_such_event")] = ("error", str(e))
    return out


@pytest.mark.parametrize("which", ["peer", "task"])
def test_every_event_from_every_state_matches(which):
    jmod, pmod = (jpeer, ppeer) if which == "peer" else (jtask, ptask)
    jev = jmod._PEER_EVENTS if which == "peer" else jmod._TASK_EVENTS
    pev = pmod._PEER_EVENTS if which == "peer" else pmod._TASK_EVENTS
    assert [(e.name, e.src, e.dst) for e in jev] == [
        (e.name, e.src, e.dst) for e in pev]
    cls = "PeerState" if which == "peer" else "TaskState"
    states = sorted(v for k, v in vars(getattr(jmod, cls)).items()
                    if k.isupper())
    assert states == sorted(v for k, v in vars(getattr(pmod, cls)).items()
                            if k.isupper())
    assert _fsm_table(jev, jfsm, states) == _fsm_table(pev, pfsm, states)


def test_fsm_callbacks_restore_and_can_match():
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jfsm), ("port", pfsm)):
        events = [mod.EventDesc("go", ("a",), "b"),
                  mod.EventDesc("back", ("b",), "a")]
        f = mod.FSM("a", events, {"go": lambda *a, n=name:
                                  seen[n].append(a)})
        seen[name].append((f.can("go"), f.can("back"), f.is_state("a")))
        f.event("go")
        f.restore("a")
        seen[name].append((f.current, f.can("go")))
    assert seen["jax"] == seen["port"]


def _dag_ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    ids = [f"v{i}" for i in range(12)]
    kinds = ("add_vertex", "add_edge", "add_edge", "delete_edge",
             "delete_vertex", "in_edges", "out_edges", "can_add_edge")
    return [(kinds[int(rng.integers(len(kinds)))],
             ids[int(rng.integers(len(ids)))],
             ids[int(rng.integers(len(ids)))]) for _ in range(n)]


def _apply(dag, mod, op):
    kind, a, b = op
    try:
        if kind == "add_vertex":
            return dag.add_vertex(a, a.upper())
        if kind == "add_edge":
            return dag.add_edge(a, b)
        if kind == "delete_edge":
            return dag.delete_edge(a, b)
        if kind == "delete_vertex":
            return dag.delete_vertex(a)
        if kind == "in_edges":
            return dag.delete_vertex_in_edges(a)
        if kind == "out_edges":
            return dag.delete_vertex_out_edges(a)
        return dag.can_add_edge(a, b)
    except mod.DAGError as e:
        return (type(e).__name__, str(e))


def _shape(dag):
    out = {}
    for vid in sorted(dag.vertex_ids()):
        v = dag.get_vertex(vid)
        out[vid] = (v.value, sorted(v.parents), sorted(v.children))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_dag_edits_and_refusals_match(seed):
    j, p = jdag.DAG(), pdag.DAG()
    for op in _dag_ops(seed):
        assert _apply(j, jdag, op) == _apply(p, pdag, op), op
        assert _shape(j) == _shape(p)
    assert j.vertex_count() == p.vertex_count()
    assert [v for v in j.values()] == [v for v in p.values()]
    assert j.find_value(lambda v: v > "V5") == p.find_value(
        lambda v: v > "V5")


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_random_vertices_sample_the_same_ids(seed):
    j, p = jdag.DAG(), pdag.DAG(random.Random(seed))
    for i in range(40):
        j.add_vertex(f"v{i}", i)
        p.add_vertex(f"v{i}", i)
    for i in range(0, 40, 3):
        j.delete_vertex(f"v{i}")
        p.delete_vertex(f"v{i}")
    random.seed(seed)
    for n in (1, 5, 15, 26, 27, 40):
        assert [v.id for v in j.random_vertices(n)] == [
            v.id for v in p.random_vertices(n)]


# --------------------------------------------------------------------- #
# Evaluator, candidates, stripes over drawn inputs
# --------------------------------------------------------------------- #

_STATES = ("pending", "running", "back_to_source", "succeeded")
_PATH = {"pending": (), "running": ("register_normal", "download"),
         "back_to_source": ("register_normal", "download_back_to_source"),
         "succeeded": ("register_normal", "download", "download_succeeded")}

host_st = st.fixed_dictionaries({
    "type": st.sampled_from([0, 1, 2, 3]),
    "idc": st.sampled_from(["", "pod-1", "POD-1", "pod-2"]),
    "location": st.sampled_from(["", "us|pod1|s1|h1", "us|pod1|s2",
                                 "eu|podx", "US|POD1|S1|h9|x|y"]),
    "tpu_slice": st.sampled_from(["", "slice-a", "slice-b"]),
    "limit": st.integers(0, 300),
    "busy": st.integers(0, 300),
    "uploads": st.integers(0, 50),
    "failed": st.integers(0, 50),
})
peer_st = st.fixed_dictionaries({
    "host": host_st, "state": st.sampled_from(_STATES),
    "pieces": st.integers(0, 40),
    "costs": st.lists(st.integers(1, 2000), max_size=40),
})


def _build(ns, spec: dict, hid: str, task, pid: str):
    h = spec["host"] if "host" in spec else spec
    host = ns.Host(hid, ip="10.0.0.1", port=8000, upload_port=9000,
                   host_type=ns.HostType(h["type"]), idc=h["idc"],
                   location=h["location"], tpu_slice=h["tpu_slice"],
                   concurrent_upload_limit=h["limit"])
    host.concurrent_upload_count = h["busy"]
    host.upload_count = h["uploads"] + h["failed"]
    host.upload_failed_count = h["failed"]
    peer = ns.Peer(pid, task, host)
    task.add_peer(peer)
    host.peer_ids.add(pid)
    for ev in _PATH[spec.get("state", "pending")]:
        peer.fsm.event(ev)
    for i in range(spec.get("pieces", 0)):
        peer.add_finished_piece(i)
    for c in spec.get("costs", ()):
        peer.piece_costs.append(c)
    return peer


@settings(max_examples=120, deadline=None)
@given(parent=peer_st, child=host_st, total=st.integers(-1, 50))
def test_evaluator_scores_are_equal_as_floats(parent, child, total):
    scores = []
    for ns in (PKGS["jax"], PKGS["port"]):
        task = ns.Task("t", "http://x")
        p = _build(ns, parent, "hp", task, "p")
        c = _build(ns, {"host": child}, "hc", task, "c")
        ev = ns.Evaluator()
        scores.append((ev.evaluate(p, c, total),
                       ev._topology_score(p.host, c.host),
                       ev._location_score(p.host, c.host),
                       ev._idc_score(p.host, c.host),
                       ns.Evaluator.is_bad_node(p)))
    assert scores[0] == scores[1]


@settings(max_examples=40, deadline=None)
@given(peers=st.lists(peer_st, min_size=1, max_size=30),
       child=host_st, seed=st.integers(0, 2**16),
       throttled=st.booleans())
def test_find_candidate_parents_returns_the_same_ids(peers, child, seed,
                                                     throttled):
    got = []
    for name in ("jax", "port"):
        ns = PKGS[name]
        rng = random.Random(seed)
        task = (ns.Task("t", "http://x", tenant="ten") if name == "jax"
                else ns.Task("t", "http://x", tenant="ten", rng=rng))
        task.total_piece_count = 40
        for i, spec in enumerate(peers):
            _build(ns, spec, f"h{i}", task, f"p{i}")
        c = _build(ns, {"host": child}, "hc", task, "c")
        s = ns.Scheduling(ns.config.SchedulingConfig(retry_interval=0.01))
        if throttled:
            s.wire_qos(lambda: {"ten"})
        if name == "jax":
            random.seed(seed)
        got.append([p.id for p in s.find_candidate_parents(c)])
    assert got[0] == got[1]


@settings(max_examples=15, deadline=None)
@given(peers=st.lists(peer_st, min_size=0, max_size=20),
       seed=st.integers(0, 2**16))
def test_schedule_candidate_parents_returns_the_same(peers, seed):
    got = []
    for name in ("jax", "port"):
        ns = PKGS[name]
        task = (ns.Task("t", "http://x") if name == "jax" else
                ns.Task("t", "http://x", rng=random.Random(seed)))
        task.total_piece_count = 40
        for i, spec in enumerate(peers):
            _build(ns, spec, f"h{i}", task, f"p{i}")
        c = _build(ns, {"host": {"type": 0, "idc": "", "location": "",
                                 "tpu_slice": "", "limit": 0, "busy": 0,
                                 "uploads": 0, "failed": 0}}, "hc", task, "c")
        c.fsm.event("register_normal")
        cfg = ns.config.SchedulingConfig(retry_interval=0.002,
                                         retry_back_to_source_limit=1,
                                         retry_limit=2)
        if name == "jax":
            random.seed(seed)
        r = asyncio.run(ns.Scheduling(cfg).schedule_candidate_parents(c))
        got.append((r.kind, [p.id for p in r.parents],
                    r.reason.split(" after ")[0]))
    assert got[0] == got[1]


member_st = st.tuples(st.integers(-1, 4), st.sampled_from("abcd"),
                      st.sampled_from(["p0", "p1", "p2", "p3", "p4"]))


@settings(max_examples=200, deadline=None)
@given(members=st.lists(member_st, max_size=8),
       who=st.sampled_from(["p0", "p1", "p2", "p3", "p4", "zz"]),
       total=st.integers(0, 100), size=st.integers(0, 9),
       rank=st.integers(0, 8), piece=st.integers(0, 200))
def test_plan_stripe_and_piece_math_match(members, who, total, size, rank,
                                          piece):
    assert jstripe.plan_stripe(list(members), who) == pstripe.plan_stripe(
        list(members), who)
    assert jstripe.member_key(3, "h", "p") == pstripe.member_key(3, "h", "p")
    assert jstripe.in_stripe(piece, size, rank) == pstripe.in_stripe(
        piece, size, rank)
    if size:
        assert jstripe.stripe_piece_count(total, size, rank) == \
            pstripe.stripe_piece_count(total, size, rank)


# --------------------------------------------------------------------- #
# tests/test_scheduler_unit.py's cases, by package
# --------------------------------------------------------------------- #

def make_host(ns, hid, *, host_type=None, idc="", location="", tpu_slice="",
              upload_port=9000):
    return ns.Host(hid, ip="10.0.0.1", port=8000, upload_port=upload_port,
                   host_type=host_type or ns.HostType.NORMAL, idc=idc,
                   location=location, tpu_slice=tpu_slice)


def make_peer(ns, pid, task, host, *, state=None, pieces=0):
    p = ns.Peer(pid, task, host)
    task.add_peer(p)
    host.peer_ids.add(pid)
    S = ns.PeerState
    if state == S.RUNNING:
        p.fsm.event("register_normal")
        p.fsm.event("download")
    elif state == S.SUCCEEDED:
        p.fsm.event("register_normal")
        p.fsm.event("download")
        p.fsm.event("download_succeeded")
    elif state == S.BACK_TO_SOURCE:
        p.fsm.event("register_normal")
        p.fsm.event("download_back_to_source")
    for i in range(pieces):
        p.add_finished_piece(i, cost_ms=50)
    return p


def test_unit_task_lifecycle(ns):
    t = ns.Task("t1", "http://x")
    assert t.state == ns.TaskState.PENDING
    t.fsm.event("download")
    assert t.state == ns.TaskState.RUNNING
    t.fsm.event("download_succeeded")
    assert t.state == ns.TaskState.SUCCEEDED
    t.fsm.event("download")
    assert t.state == ns.TaskState.RUNNING


def test_unit_peer_lifecycle(ns):
    t = ns.Task("t1")
    p = ns.Peer("p1", t, make_host(ns, "h1"))
    p.fsm.event("register_normal")
    p.fsm.event("download")
    p.fsm.event("download_succeeded")
    assert p.is_done()


def test_unit_peer_back_to_source_path(ns):
    t = ns.Task("t1")
    p = ns.Peer("p1", t, make_host(ns, "h1"))
    p.fsm.event("register_normal")
    p.fsm.event("download_back_to_source")
    assert p.state == ns.PeerState.BACK_TO_SOURCE
    p.fsm.event("download_succeeded")
    assert p.state == ns.PeerState.SUCCEEDED


def _task10(ns, tid="t1"):
    t = ns.Task(tid, "http://x")
    t.total_piece_count = 10
    return t


def test_unit_more_pieces_scores_higher(ns):
    t = _task10(ns)
    S = ns.PeerState
    child = make_peer(ns, "c", t, make_host(ns, "hc"))
    rich = make_peer(ns, "rich", t, make_host(ns, "h1"), state=S.RUNNING,
                     pieces=9)
    poor = make_peer(ns, "poor", t, make_host(ns, "h2"), state=S.RUNNING,
                     pieces=1)
    assert ns.Evaluator().evaluate_parents([poor, rich], child,
                                           10)[0].id == "rich"


def test_unit_seed_outranks_normal(ns):
    t = _task10(ns)
    S = ns.PeerState
    child = make_peer(ns, "c", t, make_host(ns, "hc"))
    seed = make_peer(ns, "seed", t, make_host(
        ns, "hs", host_type=ns.HostType.SUPER_SEED), state=S.SUCCEEDED,
        pieces=10)
    normal = make_peer(ns, "n", t, make_host(ns, "hn"), state=S.SUCCEEDED,
                       pieces=10)
    assert ns.Evaluator().evaluate_parents([normal, seed], child,
                                           10)[0].id == "seed"


def test_unit_same_slice_beats_cross_slice(ns):
    t = _task10(ns)
    S = ns.PeerState
    child = make_peer(ns, "c", t, make_host(ns, "hc", tpu_slice="slice-a",
                                            idc="pod-1"))
    local = make_peer(ns, "local", t, make_host(
        ns, "h1", tpu_slice="slice-a", idc="pod-1"), state=S.SUCCEEDED,
        pieces=10)
    remote = make_peer(ns, "remote", t, make_host(
        ns, "h2", tpu_slice="slice-z", idc="pod-9"), state=S.SUCCEEDED,
        pieces=10)
    assert ns.Evaluator().evaluate_parents([remote, local], child,
                                           10)[0].id == "local"


def test_unit_location_affinity_prefix(ns):
    ev = ns.Evaluator()
    a = make_host(ns, "a", location="us|pod1|slice1|host1")
    b = make_host(ns, "b", location="us|pod1|slice2|host9")
    c = make_host(ns, "c", location="eu|podx")
    assert ev._location_score(a, b) == pytest.approx(2 / 5)
    assert ev._location_score(a, c) == 0.0


def test_unit_bad_node_20x_mean(ns):
    t = ns.Task("t1")
    p = make_peer(ns, "p", t, make_host(ns, "h"))
    for _ in range(5):
        p.piece_costs.append(10)
    p.piece_costs.append(500)
    assert ns.Evaluator.is_bad_node(p)


def test_unit_bad_node_3_sigma(ns):
    t = ns.Task("t1")
    p = make_peer(ns, "p", t, make_host(ns, "h"))
    for _ in range(35):
        p.piece_costs.append(100)
    p.piece_costs.append(101)
    assert ns.Evaluator.is_bad_node(p)
    p2 = make_peer(ns, "p2", t, make_host(ns, "h2"))
    for i in range(35):
        p2.piece_costs.append(100 + (i % 5))
    p2.piece_costs.append(103)
    assert not ns.Evaluator.is_bad_node(p2)


def _filters(ns):
    s = ns.Scheduling(ns.config.SchedulingConfig(retry_interval=0.01))
    t = _task10(ns)
    return s, t, make_peer(ns, "child", t, make_host(ns, "hc"))


def test_unit_filters_self_and_same_host(ns):
    s, t, child = _filters(ns)
    make_peer(ns, "same", t, child.host, state=ns.PeerState.RUNNING,
              pieces=5)
    assert s.find_candidate_parents(child) == []


def test_unit_filters_blocklist_and_states(ns):
    s, t, child = _filters(ns)
    make_peer(ns, "good", t, make_host(ns, "h1"), state=ns.PeerState.RUNNING,
              pieces=5)
    make_peer(ns, "pend", t, make_host(ns, "h2"))
    assert [p.id for p in s.find_candidate_parents(child)] == ["good"]
    assert s.find_candidate_parents(child, {"good"}) == []


def test_unit_filters_no_free_upload(ns):
    s, t, child = _filters(ns)
    h = make_host(ns, "h1")
    h.concurrent_upload_count = h.concurrent_upload_limit
    make_peer(ns, "busy", t, h, state=ns.PeerState.RUNNING, pieces=5)
    assert s.find_candidate_parents(child) == []


def test_unit_candidate_limit(ns):
    s, t, child = _filters(ns)
    for i in range(10):
        make_peer(ns, f"p{i}", t, make_host(ns, f"h{i}"),
                  state=ns.PeerState.SUCCEEDED, pieces=10)
    assert len(s.find_candidate_parents(child)) == \
        s.config.candidate_parent_limit


def test_unit_reattach_edges(ns):
    s, t, child = _filters(ns)
    S = ns.PeerState
    p1 = make_peer(ns, "p1", t, make_host(ns, "h1"), state=S.SUCCEEDED,
                   pieces=10)
    p2 = make_peer(ns, "p2", t, make_host(ns, "h2"), state=S.SUCCEEDED,
                   pieces=10)
    s.reattach_peer(child, [p1])
    assert t.peer_out_degree("p1") == 1
    s.reattach_peer(child, [p2])
    assert t.peer_out_degree("p1") == 0
    assert t.peer_out_degree("p2") == 1


def test_unit_schedule_need_back_source_when_empty(ns, run_async):
    s, t, child = _filters(ns)
    child.fsm.event("register_normal")
    result = run_async(s.schedule_candidate_parents(child))
    assert result.kind == ns.ScheduleResult.NEED_BACK_SOURCE


def test_unit_edges_hold_and_release_slots(ns):
    t = _task10(ns)
    S = ns.PeerState
    parent = make_peer(ns, "p", t, make_host(ns, "hp"), state=S.SUCCEEDED,
                       pieces=10)
    make_peer(ns, "c1", t, make_host(ns, "h1"))
    make_peer(ns, "c2", t, make_host(ns, "h2"))
    t.add_peer_edge("p", "c1")
    t.add_peer_edge("p", "c2")
    assert parent.host.concurrent_upload_count == 2
    t.delete_peer_in_edges("c1")
    assert parent.host.concurrent_upload_count == 1
    t.delete_peer("c2")
    assert parent.host.concurrent_upload_count == 0


def test_unit_full_parent_filtered(ns):
    s = ns.Scheduling(ns.config.SchedulingConfig(retry_interval=0.01))
    t = _task10(ns)
    h = make_host(ns, "hp")
    h.concurrent_upload_limit = 1
    make_peer(ns, "p", t, h, state=ns.PeerState.SUCCEEDED, pieces=10)
    make_peer(ns, "c1", t, make_host(ns, "h1"))
    t.add_peer_edge("p", "c1")
    c2 = make_peer(ns, "c2", t, make_host(ns, "h2"))
    assert s.find_candidate_parents(c2) == []


def test_unit_download_finished_releases_parent_slots(ns):
    svc = ns.service()
    task = ns.Task("t-slots", "http://x")
    parent_host, child_host = make_host(ns, "hp"), make_host(ns, "hc")
    S = ns.PeerState
    parent = make_peer(ns, "pp", task, parent_host, state=S.RUNNING,
                       pieces=4)
    child = make_peer(ns, "pc", task, child_host, state=S.RUNNING)
    task.add_peer_edge(parent.id, child.id)
    assert parent_host.concurrent_upload_count == 1
    svc._handle_download_finished(
        {"content_length": 1024, "piece_size": 256, "total_piece_count": 4},
        task, child)
    assert child.state == S.SUCCEEDED
    assert parent_host.concurrent_upload_count == 0


def _tiny_task(ns, content: bytes, digest: str = ""):
    t = ns.Task("t-tiny", "http://x", digest=digest)
    t.content_length = len(content)
    t.piece_size = 4 * 1024 * 1024
    t.total_piece_count = 1
    t.store_piece(ns.PieceInfo(
        0, 0, len(content),
        digest="md5:" + hashlib.md5(content).hexdigest()))
    return t


def test_unit_direct_piece_accepts_matching_content(ns):
    content = b"tiny" * 10
    assert ns.Service._verify_direct_piece(_tiny_task(ns, content), content)


def test_unit_direct_piece_rejects_piece_digest_mismatch(ns):
    content = b"tiny" * 10
    assert not ns.Service._verify_direct_piece(_tiny_task(ns, content),
                                               b"x" * 40)


def test_unit_direct_piece_rejects_task_digest_mismatch(ns):
    content = b"tiny" * 10
    task = ns.Task("t-tiny2", "http://x",
                   digest="sha256:" + hashlib.sha256(b"other").hexdigest())
    task.content_length = len(content)
    assert not ns.Service._verify_direct_piece(task, content)


def test_unit_direct_piece_accepts_no_digest_on_record(ns):
    task = ns.Task("t-tiny3", "http://x")
    task.content_length = 8
    assert ns.Service._verify_direct_piece(task, b"whatever")


def test_unit_duplicate_piece_finished_is_a_noop(ns):
    svc = ns.service()
    task = ns.Task("t-dup", "http://x")
    S = ns.PeerState
    parent = make_peer(ns, "pp-dup", task, make_host(ns, "hp-dup"),
                       state=S.RUNNING, pieces=4)
    child = make_peer(ns, "pc-dup", task, make_host(ns, "hc-dup"),
                      state=S.RUNNING)
    svc.peers.load_or_store(parent)
    svc.peers.load_or_store(child)
    report = {"piece_num": 0, "range_start": 0, "range_size": 256,
              "digest": "crc32c:abc", "download_cost_ms": 12,
              "dst_peer_id": parent.id}
    for _ in range(2):
        svc._apply_piece_finished(dict(report), task, child)
        assert parent.host.upload_count == 1
        assert child.finished_pieces == {0}
        assert list(child.piece_costs) == [12]


def _ici_task(ns, tid):
    return ns.Scheduling(ns.config.SchedulingConfig(
        retry_interval=0.01)), _task10(ns, tid)


def test_unit_serving_slice_mate_outranks_cross_slice_seed(ns):
    s, t = _ici_task(ns, "t-ici")
    S = ns.PeerState
    child = make_peer(ns, "child", t, make_host(ns, "hc", tpu_slice="slice-a",
                                                idc="pod-1"))
    make_peer(ns, "seed", t, make_host(
        ns, "hs", host_type=ns.HostType.SUPER_SEED, tpu_slice="slice-z",
        idc="pod-1"), state=S.SUCCEEDED, pieces=10)
    make_peer(ns, "mate", t, make_host(ns, "hm", tpu_slice="slice-a",
                                       idc="pod-1"), state=S.RUNNING,
              pieces=1)
    assert [p.id for p in s.find_candidate_parents(child)] == ["mate", "seed"]


def test_unit_sliceless_slice_falls_back_to_cross_ingress(ns):
    s, t = _ici_task(ns, "t-ici2")
    child = make_peer(ns, "child", t, make_host(ns, "hc", tpu_slice="slice-a",
                                                idc="pod-1"))
    make_peer(ns, "seed", t, make_host(
        ns, "hs", host_type=ns.HostType.SUPER_SEED, tpu_slice="slice-z",
        idc="pod-1"), state=ns.PeerState.SUCCEEDED, pieces=10)
    assert [p.id for p in s.find_candidate_parents(child)] == ["seed"]


def test_unit_warming_slice_mate_is_a_candidate(ns):
    s, t = _ici_task(ns, "t-warm")
    S = ns.PeerState
    child = make_peer(ns, "child", t, make_host(ns, "hc",
                                                tpu_slice="slice-a"))
    seed = make_peer(ns, "seed", t, make_host(
        ns, "hs", host_type=ns.HostType.SUPER_SEED, tpu_slice="slice-z"),
        state=S.SUCCEEDED, pieces=10)
    mate = make_peer(ns, "mate", t, make_host(ns, "hm", tpu_slice="slice-a"),
                     state=S.RUNNING, pieces=0)
    assert [p.id for p in s.find_candidate_parents(child)] == ["seed"]
    t.add_peer_edge(seed.id, mate.id)
    assert [p.id for p in s.find_candidate_parents(child)] == ["mate", "seed"]


def test_unit_handout_never_only_warming_mates(ns):
    s, t = _ici_task(ns, "t-warm2")
    S = ns.PeerState
    child = make_peer(ns, "child", t, make_host(ns, "hc",
                                                tpu_slice="slice-a"))
    seed = make_peer(ns, "seed", t, make_host(
        ns, "hs", host_type=ns.HostType.SUPER_SEED, tpu_slice="slice-z"),
        state=S.SUCCEEDED, pieces=10)
    limit = s.config.candidate_parent_limit
    for i in range(limit + 1):
        m = make_peer(ns, f"mate{i}", t, make_host(ns, f"hm{i}",
                                                   tpu_slice="slice-a"),
                      state=S.RUNNING, pieces=0)
        t.add_peer_edge(seed.id, m.id)
    parents = s.find_candidate_parents(child)
    assert len(parents) == limit
    assert "seed" in [p.id for p in parents]


# --------------------------------------------------------------------- #
# tests/test_stripe.py's planner and scheduler cases, by package
# --------------------------------------------------------------------- #

N_PIECES = 10
PIECE_SIZE = 1 << 20


def test_stripe_deterministic_and_order_insensitive(ns):
    members = [(1, "hb", "pb"), (0, "ha", "pa"), (2, "hc", "pc")]
    plans = [ns.stripe.plan_stripe(list(perm), "pb")
             for perm in (members, members[::-1],
                          [members[2], members[0], members[1]])]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0]["slice_size"] == 3
    assert plans[0]["members"] == ["pa", "pb", "pc"]
    assert plans[0]["slice_rank"] == 1


def test_stripe_disjoint_exact_cover(ns):
    members = [(i % 4, f"h{i}", f"p{i}") for i in range(7)]
    plans = {m[2]: ns.stripe.plan_stripe(members, m[2]) for m in members}
    assert {p["slice_size"] for p in plans.values()} == {7}
    assert sorted(p["slice_rank"] for p in plans.values()) == list(range(7))
    for piece in range(199):
        owners = [pid for pid, p in plans.items()
                  if ns.stripe.in_stripe(piece, p["slice_size"],
                                         p["slice_rank"])]
        assert len(owners) == 1, (piece, owners)


def test_stripe_piece_counts_sum(ns):
    for total in (0, 1, 5, 16, 17):
        counts = [ns.stripe.stripe_piece_count(total, 5, r)
                  for r in range(5)]
        assert sum(counts) == total
        assert max(counts) - min(counts) <= 1


def test_stripe_lone_host_and_unknown_peer(ns):
    assert ns.stripe.plan_stripe([(0, "h", "p")], "p") is None
    assert ns.stripe.plan_stripe([(0, "h", "p"), (1, "i", "q")],
                                 "zz") is None


def test_stripe_duplicate_peer_id_collapses(ns):
    plan = ns.stripe.plan_stripe(
        [(0, "h", "p"), (5, "other", "p"), (1, "i", "q")], "q")
    assert plan["slice_size"] == 2


class FakeStream:
    def __init__(self, open_body):
        self.open_body = open_body
        self.to_sched: asyncio.Queue = asyncio.Queue()
        self.to_peer: asyncio.Queue = asyncio.Queue()

    async def send(self, body):
        await self.to_peer.put(body)

    async def recv(self, timeout=None):
        return await self.to_sched.get()


async def _serve(svc, stream):
    try:
        await svc.announce_peer(stream, None)
    except Exception:
        pass


def _body(peer_id, host_id, *, slice_name="", worker=-1, broadcast=False,
          port=8000, upload_port=9000):
    b = {"host": {"id": host_id, "hostname": host_id, "ip": "10.0.0.1",
                  "port": port, "upload_port": upload_port,
                  "tpu_slice": slice_name, "tpu_worker_index": worker},
         "peer_id": peer_id, "task_id": "stripe-task",
         "url": "http://origin/ckpt"}
    if broadcast:
        b["pod_broadcast"] = True
    return b


async def _finish_source_peer(svc) -> FakeStream:
    stream = FakeStream(_body("peer-src", "host-src"))
    asyncio.ensure_future(_serve(svc, stream))
    await stream.to_sched.put({"type": "register"})
    msg = await asyncio.wait_for(stream.to_peer.get(), 10)
    assert msg["type"] == "need_back_source", msg
    await stream.to_sched.put({
        "type": "download_started", "content_length": N_PIECES * PIECE_SIZE,
        "piece_size": PIECE_SIZE, "total_piece_count": N_PIECES})
    for n in range(N_PIECES):
        await stream.to_sched.put({
            "type": "piece_finished",
            "piece": {"piece_num": n, "range_start": n * PIECE_SIZE,
                      "range_size": PIECE_SIZE, "digest": "",
                      "download_cost_ms": 2, "dst_peer_id": ""}})
    await stream.to_sched.put({
        "type": "download_finished", "content_length": N_PIECES * PIECE_SIZE,
        "piece_size": PIECE_SIZE, "total_piece_count": N_PIECES})
    return stream


def _stripe_svc(ns):
    cfg = ns.config.SchedulerConfig()
    cfg.scheduling.retry_interval = 0.02
    cfg.scheduling.no_source_patience = 0.5
    cfg.seed_peer_enabled = False
    return ns.service(cfg)


def test_stripe_handout_reshuffle_and_lone_fallback(ns, run_async):
    async def body():
        svc = _stripe_svc(ns)
        await _finish_source_peer(svc)
        a = FakeStream(_body("peer-a", "host-a", slice_name="slice-0",
                             worker=0, broadcast=True, port=8001,
                             upload_port=9001))
        serve_a = asyncio.ensure_future(_serve(svc, a))
        await a.to_sched.put({"type": "register"})
        msg_a = await asyncio.wait_for(a.to_peer.get(), 10)
        assert msg_a["type"] == "normal_task"
        assert "stripe" not in msg_a
        b = FakeStream(_body("peer-b", "host-b", slice_name="slice-0",
                             worker=1, broadcast=True, port=8002,
                             upload_port=9002))
        serve_b = asyncio.ensure_future(_serve(svc, b))
        await b.to_sched.put({"type": "register"})
        msg_b = await asyncio.wait_for(b.to_peer.get(), 10)
        stripe_b = msg_b["stripe"]
        assert (stripe_b["slice_size"], stripe_b["slice_rank"]) == (2, 1)
        assert stripe_b["members"] == ["peer-a", "peer-b"]
        assert [m["id"] for m in stripe_b["mates"]] == ["peer-a"]
        push_a = await asyncio.wait_for(a.to_peer.get(), 10)
        stripe_a = push_a["stripe"]
        assert (stripe_a["slice_size"], stripe_a["slice_rank"]) == (2, 0)
        assert [m["id"] for m in stripe_a["mates"]] == ["peer-b"]
        for piece in range(50):
            assert sum(ns.stripe.in_stripe(piece, 2, p["slice_rank"])
                       for p in (stripe_a, stripe_b)) == 1
        await b.to_sched.put(None)
        await asyncio.wait_for(serve_b, 10)
        push_a2 = await asyncio.wait_for(a.to_peer.get(), 10)
        assert push_a2["type"] == "normal_task"
        assert "stripe" not in push_a2
        await a.to_sched.put(None)
        await asyncio.wait_for(serve_a, 10)

    run_async(body(), timeout=30)


def test_stripe_plain_peers_never_striped(ns, run_async):
    async def body():
        svc = _stripe_svc(ns)
        await _finish_source_peer(svc)
        streams = []
        for i in range(3):
            s = FakeStream(_body(f"peer-{i}", f"host-{i}",
                                 slice_name="slice-0", worker=i,
                                 port=8100 + i, upload_port=9100 + i))
            streams.append(s)
            asyncio.ensure_future(_serve(svc, s))
            await s.to_sched.put({"type": "register"})
            msg = await asyncio.wait_for(s.to_peer.get(), 10)
            assert msg["type"] == "normal_task"
            assert "stripe" not in msg
        for s in streams:
            await s.to_sched.put(None)

    run_async(body(), timeout=30)


def test_stripe_auto_stripe_threshold(ns, run_async):
    async def body():
        svc = _stripe_svc(ns)
        svc.config.scheduling.stripe_min_slice_peers = 2
        await _finish_source_peer(svc)
        s1 = FakeStream(_body("peer-1", "host-1", slice_name="slice-0",
                              worker=0, port=8201, upload_port=9201))
        asyncio.ensure_future(_serve(svc, s1))
        await s1.to_sched.put({"type": "register"})
        m1 = await asyncio.wait_for(s1.to_peer.get(), 10)
        assert "stripe" not in m1
        s2 = FakeStream(_body("peer-2", "host-2", slice_name="slice-0",
                              worker=1, port=8202, upload_port=9202))
        asyncio.ensure_future(_serve(svc, s2))
        await s2.to_sched.put({"type": "register"})
        m2 = await asyncio.wait_for(s2.to_peer.get(), 10)
        assert m2["stripe"]["slice_size"] == 2
        await s1.to_sched.put(None)
        await s2.to_sched.put(None)

    run_async(body(), timeout=30)
