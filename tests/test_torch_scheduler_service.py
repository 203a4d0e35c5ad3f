"""The port's ``SchedulerService`` against the JAX one, session by session.

Both services (the JAX one with ``fleet.enabled=False`` and
``podlens.enabled=False``, as the port's is) are driven through the same
scripted sessions, each on an event loop of its own, and every answer is
compared, ``sched_wall`` masked (the only field that is a clock reading):

- ``AnnounceHost``; ``AnnouncePeer`` registers with no parent (the
  first peer), with a seed host (the trigger's request body, recorded by
  a stand-in seed client pool, then the seed's own register), on a done
  parent and on a running one; the empty, tiny and small scopes (the
  tiny task's content fetched from the finisher's upload server, a local
  HTTP server here, with the same request from both);
- ``piece_finished``, ``pieces_finished`` as dicts and packed,
  ``piece_failed`` (a corrupt parent quarantined pod-wide),
  ``reschedule`` with a blocklist, ``download_finished`` with a flight
  digest (the tenant burn book), ``download_failed``, a stream cut;
- ``LeavePeer`` and ``LeaveHost``; ``StatTask``, ``StatPeer``,
  ``ListHosts``; the persistent-cache family with its replica triggers
  and delete fan-out; ``Scheduler.PodTimeline``;
- then the state itself: hosts, tasks (with the tiny content), peers,
  the persistent rows, the pod aggregator's report and the burn book.

HA: each package's snapshot flush is restored by both packages to the
same state, and the two snapshot files hold the same rows.
"""

from __future__ import annotations

import asyncio
import hashlib
import sqlite3
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.proto import reportcodec as jcodec
from dragonfly2_tpu.scheduler.config import SchedulerConfig as JConfig
from dragonfly2_tpu.scheduler.service import SchedulerService as JService
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.proto import reportcodec as pcodec
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.service import SchedulerService

PIECE = 1 << 20
TINY = b"tiny content, inlined by the scheduler"


class FakeSeedClients:
    """The scheduler's calls to daemons, recorded; every call succeeds."""

    def __init__(self):
        self.calls: list = []

    async def trigger_download_task(self, host, spec):
        self.calls.append(("trigger", host.id, dict(spec)))
        return True

    async def delete_task(self, host, task_id):
        self.calls.append(("delete", host.id, task_id))
        return True

    async def stat_task(self, host, task_id):
        return None

    async def flight_digest(self, host, task_id):
        return None

    async def close(self):
        pass


class FakeStream:
    def __init__(self, open_body):
        self.open_body = open_body
        self.to_sched: asyncio.Queue = asyncio.Queue()
        self.to_peer: asyncio.Queue = asyncio.Queue()

    async def send(self, body):
        await self.to_peer.put(body)

    async def recv(self, timeout=None):
        return await self.to_sched.get()


def _mask(v):
    """``sched_wall`` out of an answer, and the persistent rows' clock
    stamps; bytes and nested values kept."""
    if isinstance(v, dict):
        return {k: _mask(x) for k, x in v.items()
                if k not in ("sched_wall", "created_at", "updated_at")}
    if isinstance(v, (list, tuple)):
        return [_mask(x) for x in v]
    return v


def _host(name: str, port: int, upload_port: int = 0, **kw) -> dict:
    return {"id": name, "hostname": name, "ip": "127.0.0.1", "port": port,
            "upload_port": upload_port, "type": kw.pop("type", 0), **kw}


class Session:
    """One package's run: a service, its streams, and everything it
    answered, in order."""

    def __init__(self, svc, codec, errors):
        self.svc = svc
        self.codec = codec
        self.errors = errors
        self.log: list = []
        self.serving: list = []

    async def open(self, peer_id, task_id, host, **open_kw):
        s = FakeStream({"host": host, "peer_id": peer_id,
                        "task_id": task_id, "url": f"http://o/{task_id}",
                        **open_kw})

        async def serve():
            try:
                await self.svc.announce_peer(s, None)
            except Exception as e:
                self.log.append(("stream error", peer_id, type(e).__name__,
                                 str(e)))

        self.serving.append(asyncio.ensure_future(serve()))
        return s

    async def send(self, s, *msgs):
        for m in msgs:
            await s.to_sched.put(m)
        while not s.to_sched.empty():
            await asyncio.sleep(0.002)
        await asyncio.sleep(0.02)

    async def answer(self, s, what: str):
        msg = await asyncio.wait_for(s.to_peer.get(), 10)
        self.log.append((what, _mask(msg)))
        return msg

    async def call(self, what: str, fn, body):
        try:
            out = await fn(body, None)
        except self.errors as e:
            out = {"error": [int(e.code), e.message]}
        self.log.append((what, _mask(out)))
        return out


def _reports(nums, parent="", cost=5):
    return [{"piece_num": n, "range_start": n * PIECE, "range_size": PIECE,
             "digest": f"crc32c:{n:08x}", "download_cost_ms": cost + n,
             "dst_peer_id": parent,
             "timings": {"dcn_ms": 1, "stall_ms": 0, "store_ms": 2}}
            for n in nums]


def _flight(task_id: str) -> dict:
    return {"v": 1, "task_id": task_id, "state": "done", "start_wall": 1.0,
            "wall_s": 2.5, "phases": {"stall": 0.25, "dcn": 2.0},
            "pieces": [[0, 0, 0, 0.5, 0.6], [1, 0, 0, -1, 0.3]]}


class _TinyHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        self.server.seen.append(self.path)
        self.send_response(200)
        self.send_header("Content-Length", str(len(TINY)))
        self.end_headers()
        self.wfile.write(TINY)


@pytest.fixture(scope="module")
def upload_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _TinyHandler)
    srv.seen = []
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="df-test-upload")
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


async def _scripted(sess: Session, up_port: int) -> None:
    svc = sess.svc
    H = {n: _host(n, 7000 + i, 9000 + i) for i, n in enumerate(
        ("hA", "hB", "hC", "hD", "hE", "hF", "hG", "hH"))}
    H["hT"] = _host("hT", 7100, up_port)
    seed_host = _host("hS", 7200, 9200, type=1)
    for h in H.values():
        await sess.call("announce_host", svc.announce_host, dict(h))
    # A clock sample and telemetry ride an announce; neither answers.
    await sess.call("announce_host clock", svc.announce_host, {
        **H["hA"], "clock": {"t0": 1.0, "t1": 1.5, "echo": 1.2},
        "telemetry": {"cpu_percent": 3.5}})

    # 1. The first peer of a task goes to the origin; its reports in
    #    every form; it finishes with a flight digest (tenant burn book).
    a = await sess.open("pA", "t1", H["hA"], tenant="teamx",
                        digest="sha256:" + "0" * 64)
    await sess.send(a, {"type": "register"})
    await sess.answer(a, "t1 pA register")
    await sess.send(a, {"type": "download_started",
                        "content_length": 8 * PIECE, "piece_size": PIECE,
                        "total_piece_count": 8},
                    {"type": "piece_finished", "piece": _reports([0])[0]},
                    {"type": "pieces_finished", "pieces": _reports([1, 2])},
                    {"type": "pieces_finished", "pieces": _reports([2])},
                    {"type": "pieces_finished",
                     "packed": sess.codec.encode_reports(
                         _reports([3, 4, 5, 6, 7]))},
                    {"type": "pieces_finished",
                     "packed": {"v": 9, "n": 1, "peers": [], "nums": b"",
                                "cols": b""}},
                    {"type": "download_finished",
                     "content_length": 8 * PIECE, "piece_size": PIECE,
                     "total_piece_count": 8, "flight": _flight("t1")})
    await sess.call("stat_peer pA", svc.stat_peer, {"peer_id": "pA"})

    # 2. A child on the done parent; a corrupt piece from it quarantines
    #    the parent's host; a reschedule with it blocklisted demotes the
    #    child to the origin.
    b = await sess.open("pB", "t1", H["hB"])
    await sess.send(b, {"type": "register"})
    await sess.answer(b, "t1 pB register")
    await sess.send(b, {"type": "pieces_finished",
                        "pieces": _reports([0, 1], parent="pA")},
                    {"type": "piece_failed", "piece_num": 2,
                     "parent_id": "pA", "temporary": False,
                     "reason": "corrupt"})
    await sess.send(b, {"type": "reschedule", "blocklist": ["pA"],
                        "description": "starved"})
    await sess.answer(b, "t1 pB reschedule")
    await sess.send(b, {"type": "download_failed", "reason": "gone",
                        "flight": {**_flight("t1"), "state": "failed"}})

    # 3. A running parent: P1 back-sources, has pieces, P2 is handed it;
    #    P3 registers too; P2's stream is cut mid-download.
    p1 = await sess.open("p1", "t2", H["hC"])
    await sess.send(p1, {"type": "register"})
    await sess.answer(p1, "t2 p1 register")
    await sess.send(p1, {"type": "download_started",
                         "content_length": 6 * PIECE, "piece_size": PIECE,
                         "total_piece_count": 6},
                    {"type": "pieces_finished", "pieces": _reports([0, 1])})
    p2 = await sess.open("p2", "t2", H["hD"])
    await sess.send(p2, {"type": "register"})
    await sess.answer(p2, "t2 p2 register")
    p3 = await sess.open("p3", "t2", H["hE"])
    await sess.send(p3, {"type": "register"})
    await sess.answer(p3, "t2 p3 register")
    await sess.send(p2, None)
    await sess.call("stat_peer p2", svc.stat_peer, {"peer_id": "p2"})
    await sess.call("stat_task t2", svc.stat_task, {"task_id": "t2"})

    # 4. Tiny: the finisher's content cached from its upload server, then
    #    inlined for the next registrant. Small: one piece, one parent.
    #    Empty: a zero-length task.
    tid = "t4" + "a" * 62
    t1 = await sess.open("r1", tid, H["hT"])
    await sess.send(t1, {"type": "register"})
    await sess.answer(t1, "tiny r1 register")
    md5 = "md5:" + hashlib.md5(TINY).hexdigest()
    await sess.send(t1, {"type": "download_started",
                         "content_length": len(TINY), "piece_size": PIECE,
                         "total_piece_count": 1},
                    {"type": "piece_finished", "piece": {
                        "piece_num": 0, "range_start": 0,
                        "range_size": len(TINY), "digest": md5}},
                    {"type": "download_finished",
                     "content_length": len(TINY), "piece_size": PIECE,
                     "total_piece_count": 1})
    for _ in range(500):
        if svc.tasks.load(tid).direct_piece:
            break
        await asyncio.sleep(0.01)
    t2 = await sess.open("r2", tid, H["hG"])
    await sess.send(t2, {"type": "register"})
    await sess.answer(t2, "tiny r2 register")

    s1 = await sess.open("m1", "t5", H["hC"])
    await sess.send(s1, {"type": "register"})
    await sess.answer(s1, "small m1 register")
    await sess.send(s1, {"type": "download_started", "content_length": 5000,
                         "piece_size": PIECE, "total_piece_count": 1},
                    {"type": "piece_finished", "piece": {
                        "piece_num": 0, "range_start": 0,
                        "range_size": 5000, "digest": "crc32c:00000001"}},
                    {"type": "download_finished", "content_length": 5000,
                     "piece_size": PIECE, "total_piece_count": 1})
    s2 = await sess.open("m2", "t5", H["hH"])
    await sess.send(s2, {"type": "register"})
    await sess.answer(s2, "small m2 register")

    e1 = await sess.open("e1", "t6", H["hB"])
    await sess.send(e1, {"type": "register"})
    await sess.answer(e1, "empty e1 register")
    await sess.send(e1, {"type": "download_finished", "content_length": 0,
                         "piece_size": 0, "total_piece_count": 0})
    e2 = await sess.open("e2", "t6", H["hC"])
    await sess.send(e2, {"type": "register"})
    await sess.answer(e2, "empty e2 register")

    # 5. A seed trigger (after the scopes: from here on, the first peer
    #    of every task triggers the seed): a seed host announced, the first peer of t3
    #    triggers it and waits; the seed registers and goes to the origin;
    #    the peer is handed the seed.
    await sess.call("announce_host seed", svc.announce_host, seed_host)
    q = await sess.open("q1", "t3", H["hF"], tenant="teamy", priority=5)
    await sess.send(q, {"type": "register"})
    seed = await sess.open("q-seed", "t3", seed_host, is_seed=True)
    await sess.send(seed, {"type": "register"})
    await sess.answer(seed, "t3 seed register")
    await sess.answer(q, "t3 q1 register")
    sess.log.append(("seed calls", _mask(svc.seed_clients.calls)))

    # 6. AnnounceTask, the stats, the leaves, PodTimeline.
    await sess.call("announce_task", svc.announce_task, {
        "task_id": "t7", "peer_id": "k1", "url": "http://o/t7",
        "host": H["hD"], "content_length": 3 * PIECE, "piece_size": PIECE,
        "total_piece_count": 3, "piece_nums": [0, 1, 2]})
    await sess.call("stat_task t1", svc.stat_task, {"task_id": "t1"})
    await sess.call("stat_task t7", svc.stat_task, {"task_id": "t7"})
    await sess.call("stat_task none", svc.stat_task, {"task_id": "zz"})
    await sess.call("stat_peer none", svc.stat_peer, {"peer_id": "zz"})
    await sess.call("list_hosts", svc.list_hosts, {})
    await sess.call("pod_timeline", svc.pod_timeline, {"task_id": "t1"})
    await sess.call("leave_peer p3", svc.leave_peer, {"id": "p3"})
    await sess.call("leave_peer none", svc.leave_peer, {"id": "zz"})
    await sess.call("leave_host hE", svc.leave_host, {"id": "hE"})
    await sess.call("leave_host none", svc.leave_host, {"id": "zz"})

    # 7. The persistent-cache family.
    pc = {"task_id": "pc1", "peer_id": "pc-up", "host": H["hA"],
          "url": "dfcache://pc1", "tag": "t", "application": "a",
          "piece_size": PIECE, "content_length": 2 * PIECE,
          "total_piece_count": 2, "replica_count": 3, "ttl": 0.0,
          "digest": "sha256:" + "1" * 64}
    await sess.call("pc started", svc.upload_persistent_cache_task_started,
                    dict(pc))
    await sess.call("pc finished",
                    svc.upload_persistent_cache_task_finished,
                    {"task_id": "pc1", "peer_id": "pc-up", "host": H["hA"]})
    await asyncio.sleep(0.05)
    await sess.call("pc stat", svc.stat_persistent_cache_task,
                    {"task_id": "pc1"})
    await sess.call("pc started 2", svc.upload_persistent_cache_task_started,
                    {**pc, "task_id": "pc2", "peer_id": "pc-up2"})
    await sess.call("pc failed 2", svc.upload_persistent_cache_task_failed,
                    {"task_id": "pc2", "peer_id": "pc-up2"})
    await sess.call("pc list", svc.list_persistent_cache_tasks, {})
    await sess.call("pc finished none",
                    svc.upload_persistent_cache_task_finished,
                    {"task_id": "zz"})
    await sess.call("pc delete", svc.delete_persistent_cache_task,
                    {"task_id": "pc1"})
    await sess.call("pc stat gone", svc.stat_persistent_cache_task,
                    {"task_id": "pc1"})
    sess.log.append(("daemon calls", _mask(svc.seed_clients.calls)))

    for s in (a, b, p1, p3, q, seed, t1, t2, s1, s2, e1, e2):
        await s.to_sched.put(None)
    await asyncio.wait_for(asyncio.gather(*sess.serving), 10)
    await asyncio.sleep(0.05)


def state_of(svc) -> dict:
    """Everything the scheduler holds, as comparable values."""
    return {
        "hosts": sorted((h.id, h.to_wire(), sorted(h.peer_ids),
                         h.upload_count, h.upload_failed_count,
                         h.concurrent_upload_count, h.quarantined())
                        for h in svc.hosts.all()),
        "tasks": sorted((t.id, t.to_wire(), t.direct_piece,
                         sorted(t.back_to_source_peers),
                         {n: p.to_wire() for n, p in t.pieces.items()},
                         sorted(t.dag.vertex_ids()))
                        for t in svc.tasks.all()),
        "peers": sorted((p.id, p.to_wire(), sorted(p.block_parents),
                         list(p.piece_costs), p.pod_broadcast,
                         p.reschedule_count) for p in svc.peers.all()),
    }


def _persistent(svc) -> dict:
    return _mask({"tasks": svc.persistent.list_tasks(),
                  "peers": sorted(svc.persistent.peers_of("pc2"),
                                  key=str),
                  "hosts": svc.persistent.list_hosts()})


def _config(pkg: str, **ha):
    cfg = JConfig() if pkg == "jax" else SchedulerConfig()
    cfg.fleet.enabled = False
    cfg.podlens.enabled = False
    cfg.scheduling.retry_interval = 0.02
    cfg.scheduling.retry_back_to_source_limit = 1
    cfg.scheduling.retry_limit = 2
    for k, v in ha.items():
        setattr(cfg.ha, k, v)
    return cfg


def _run(pkg: str, up_port: int, **ha):
    async def go():
        cfg = _config(pkg, **ha)
        svc = JService(cfg) if pkg == "jax" else SchedulerService(cfg)
        svc.seed_clients = FakeSeedClients()
        sess = Session(svc, jcodec if pkg == "jax" else pcodec,
                       JDfError if pkg == "jax" else DfError)
        await _scripted(sess, up_port)
        return svc, sess

    return asyncio.run(asyncio.wait_for(go(), 60))


@pytest.fixture(scope="module")
def runs(upload_server, tmp_path_factory):
    d = tmp_path_factory.mktemp("ha")
    out = {}
    for pkg in ("jax", "port"):
        seen0 = len(upload_server.seen)
        svc, sess = _run(pkg, upload_server.server_address[1],
                         snapshot_db=str(d / f"{pkg}.db"))
        out[pkg] = {"svc": svc, "log": sess.log,
                    "fetches": upload_server.seen[seen0:],
                    "db": str(d / f"{pkg}.db")}
    return out


def test_every_answer_matches(runs):
    j, p = runs["jax"]["log"], runs["port"]["log"]
    assert [w for w, *_ in j] == [w for w, *_ in p]
    for a, b in zip(j, p):
        assert a == b, a[0]
    kinds = {w: m for w, m in p if isinstance(m, dict)}
    # The script reached every answer kind it means to.
    assert kinds["t1 pA register"]["type"] == "need_back_source"
    assert kinds["t1 pB register"]["type"] == "normal_task"
    assert kinds["t1 pB reschedule"]["type"] == "need_back_source"
    assert [x["id"] for x in kinds["t2 p2 register"]["parents"]] == ["p1"]
    assert kinds["t3 seed register"]["type"] == "need_back_source"
    assert [x["id"] for x in kinds["t3 q1 register"]["parents"]] == [
        "q-seed"]
    assert kinds["tiny r2 register"]["type"] == "tiny_task"
    assert kinds["tiny r2 register"]["content"] == TINY
    assert kinds["small m2 register"]["type"] == "small_task"
    assert kinds["empty e2 register"]["type"] == "empty_task"
    assert kinds["pod_timeline"]["error"][1] == (
        "no shipped flight digests for task t1")


def test_the_seed_trigger_and_daemon_calls_match(runs):
    jc = dict(runs["jax"]["log"])["daemon calls"]
    pc = dict(runs["port"]["log"])["daemon calls"]
    assert jc == pc
    triggers = [c for c in pc if c[0] == "trigger"]
    assert triggers[0][1:] == ["hS", {
        "task_id": "t3", "url": "http://o/t3", "tag": "", "application": "",
        "digest": "", "filters": [], "header": {}, "range": "",
        "tenant": "teamy", "priority": 5}]
    # Two replica triggers for pc1 (3 wanted, 1 held), then the delete.
    assert len(triggers) == 3
    assert [c[0] for c in pc].count("delete") == 1


def test_the_tiny_fetch_asks_the_same(runs):
    assert runs["jax"]["fetches"] == runs["port"]["fetches"]
    assert len(runs["port"]["fetches"]) == 1
    assert runs["port"]["fetches"][0].startswith("/download/t4a/t4a")


def test_the_state_matches(runs):
    j, p = runs["jax"]["svc"], runs["port"]["svc"]
    assert state_of(j) == state_of(p)
    assert _persistent(j) == _persistent(p)
    assert j.pod_flight.report("t1") == p.pod_flight.report("t1")
    assert j.tenant_burn.snapshot() == p.tenant_burn.snapshot()
    assert p.tenant_burn.snapshot()["teamx"]["completions"] == 1


def _db_rows(path: str) -> dict:
    conn = sqlite3.connect(path)
    try:
        out = {}
        for table in ("snap_hosts", "snap_tasks", "snap_peers"):
            rows = conn.execute(f"SELECT * FROM {table}").fetchall()
            cols = [c[1] for c in conn.execute(
                f"PRAGMA table_info({table})").fetchall()]
            out[table] = sorted(
                tuple(v for c, v in zip(cols, r) if c != "updated_at")
                for r in rows)
        return out
    finally:
        conn.close()


def test_each_package_restores_the_others_snapshot(runs):
    for pkg in ("jax", "port"):
        runs[pkg]["svc"].snapshot_flush()
    assert _db_rows(runs["jax"]["db"]) == _db_rows(runs["port"]["db"])
    rows = _db_rows(runs["port"]["db"])
    assert rows["snap_peers"] and rows["snap_tasks"] and rows["snap_hosts"]
    for db in (runs["jax"]["db"], runs["port"]["db"]):
        states = []
        for pkg in ("jax", "port"):
            cfg = _config(pkg, snapshot_db=db)
            svc = JService(cfg) if pkg == "jax" else SchedulerService(cfg)
            states.append(state_of(svc))
            svc.snapshot.close()
        assert states[0] == states[1]
        assert states[1]["peers"]
