"""The port's manager modules against the JAX package's, one by one.

The same inputs through both packages: ``Database`` rows after one
scripted sequence; ``auth`` (each package verifies the other's password
hashes; with one secret and one clock ``TokenSigner`` signs the same
tokens); ``rbac.Enforcer``; ``Searcher`` over a seeded table of clusters
and requests; ``JobQueue`` fan-out, poll, complete and recover;
``ManagerService`` through one scripted session; ``TTLCache``,
``AdmissionController`` and ``Dynconfig``; the ``Manager.*`` wire
schemas. Values that differ from run to run by design (row timestamps,
job uuids, salts) are masked by name and nothing else is. Tolerance 0:
everything compared here is exact.
"""

from __future__ import annotations

import asyncio
import json
import random

import pytest

from dragonfly2_tpu.manager import auth as jauth
from dragonfly2_tpu.manager import jobqueue as jjobqueue
from dragonfly2_tpu.manager import rbac as jrbac
from dragonfly2_tpu.manager import searcher as jsearcher
from dragonfly2_tpu.manager import service as jservice
from dragonfly2_tpu.manager.config import ManagerConfig as JManagerConfig
from dragonfly2_tpu.manager.database import Database as JDatabase
from dragonfly2_tpu.pkg import cache as jcache
from dragonfly2_tpu.pkg import dynconfig as jdynconfig
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.proto import wire as jwire
from dragonfly2_tpu.qos import admission as jadmission
from dragonfly2_tpu.scheduler import dynconfig as jsdynconfig
from dragonfly2_tpu_torch.manager import auth as pauth
from dragonfly2_tpu_torch.manager import jobqueue as pjobqueue
from dragonfly2_tpu_torch.manager import rbac as prbac
from dragonfly2_tpu_torch.manager import searcher as psearcher
from dragonfly2_tpu_torch.manager import service as pservice
from dragonfly2_tpu_torch.manager.config import ManagerConfig as PManagerConfig
from dragonfly2_tpu_torch.manager.database import Database as PDatabase
from dragonfly2_tpu_torch.pkg import cache as pcache
from dragonfly2_tpu_torch.pkg import dynconfig as pdynconfig
from dragonfly2_tpu_torch.pkg.errors import DfError as PDfError
from dragonfly2_tpu_torch.proto import wire as pwire
from dragonfly2_tpu_torch.qos import admission as padmission
from dragonfly2_tpu_torch.scheduler import dynconfig as psdynconfig

# Fields that differ from run to run by design: row times, job and group
# uuids, keepalive times, password hashes (random salts), tokens and
# their expiry (the signer's clock).
MASKED = frozenset({"created_at", "updated_at", "last_keepalive_at",
                    "task_id", "group_id", "task_uuid", "encrypted_password",
                    "token", "exp", "ts", "enqueued_at"})


def mask(v):
    if isinstance(v, dict):
        return {k: ("<masked>" if k in MASKED else mask(x))
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [mask(x) for x in v]
    return v


# -- Database ---------------------------------------------------------------

def _db_script(db) -> list:
    """One scripted sequence over every Database call; what each gives."""
    out = []
    sc = db.insert("scheduler_clusters", {
        "name": "c1", "config": {"a": [1, 2]}, "scopes": {"idc": "x"}})
    out.append(sc)
    spc = db.insert("seed_peer_clusters", {"name": "s1", "config": {"b": 2}})
    db.link_seed_peer_cluster(sc["id"], spc["id"])
    db.link_seed_peer_cluster(sc["id"], spc["id"])   # idempotent
    out.append(db.seed_peer_clusters_of(sc["id"]))
    for i in range(5):
        out.append(db.insert("schedulers", {
            "hostname": f"h{i}", "ip": f"10.0.0.{i}", "port": 8000 + i,
            "features": ["f", i], "scheduler_cluster_id": sc["id"],
            "state": "active" if i % 2 else "inactive"}))
    out.append(db.list("schedulers", state="active"))
    out.append(db.list("schedulers", limit=2, offset=1))
    out.append(db.list("schedulers", order_by="port DESC"))
    out.append(db.find("schedulers", hostname="h3"))
    out.append(db.find("schedulers", hostname="nope"))
    out.append(db.count("schedulers"))
    out.append(db.count("schedulers", state="inactive"))
    out.append(db.update("schedulers", 2, {"state": "inactive",
                                           "features": {"x": 1}}))
    out.append(db.update("schedulers", 2, {}))
    out.append(db.update("schedulers", 99, {"state": "x"}))
    out.append(db.delete("schedulers", 3))
    out.append(db.delete("schedulers", 3))
    out.append(db.get("schedulers", 3))
    out.append(db.insert("user_roles", {"user_id": 7, "role": "guest"}))
    out.append([dict(r) for r in db.execute(
        "SELECT user_id, role FROM user_roles")])
    out.append(db.insert("jobs", {"type": "preheat", "args": {"url": "u"},
                                  "scheduler_cluster_ids": [1, 2]}))
    out.append(db.list("jobs"))
    with pytest.raises(Exception) as e:
        db.insert("scheduler_clusters", {"name": "c1"})
    out.append(type(e.value).__name__)
    return out


def test_database_rows_after_one_scripted_sequence(tmp_path):
    got = [_db_script(JDatabase()), _db_script(PDatabase())]
    assert mask(got[0]) == mask(got[1])
    # A file database written by either package reads back in the other.
    for w, r in ((JDatabase, PDatabase), (PDatabase, JDatabase)):
        path = str(tmp_path / f"{w.__module__.split('.')[0]}.db")
        db = w(path)
        _db_script(db)
        rows = db.list("schedulers")
        db.close()
        other = r(path)
        assert other.list("schedulers") == rows
        other.close()


# -- auth ---------------------------------------------------------------------

def test_each_package_verifies_the_others_password_hashes():
    for pw in ("dragonfly", "", "pässwörd", "x" * 200):
        for a, b in ((jauth, pauth), (pauth, jauth)):
            enc = a.hash_password(pw)
            assert b.verify_password(pw, enc)
            assert not b.verify_password(pw + "!", enc)
        salt = bytes(range(16))
        assert jauth.hash_password(pw, salt) == pauth.hash_password(pw, salt)
    for bad in ("", "nodollar", "00$zz", "zz$00"):
        got = []
        for mod in (jauth, pauth):
            try:
                got.append(mod.verify_password("p", bad))
            except ValueError as e:     # a salt that is not hex
                got.append(str(e))
        assert got[0] == got[1]


def test_one_secret_signs_the_same_tokens(monkeypatch):
    secret = b"k" * 32
    for mod in (jauth, pauth):
        monkeypatch.setattr(mod.time, "time", lambda: 1_800_000_000.0)
    js, ps = jauth.TokenSigner(secret), pauth.TokenSigner(secret)
    for uid, name, roles in ((1, "root", ["root"]), (2, "ü", []),
                             (3, "op", ["guest", "job-operator"])):
        tj, tp = js.sign(uid, name, roles), ps.sign(uid, name, roles)
        assert tj == tp
        assert js.verify(tp) == ps.verify(tj) == {
            "uid": uid, "name": name, "roles": roles,
            "exp": 1_800_000_000.0 + js.ttl}
    for bad in ("", "a.b", tj + "0", tj.replace(".", "x")):
        assert js.verify(bad) is None and ps.verify(bad) is None
    assert pauth.TokenSigner(b"other").verify(tj) is None
    monkeypatch.setattr(pauth.time, "time", lambda: 1_900_000_000.0)
    assert ps.verify(tj) is None       # expired
    tok = pauth.new_personal_access_token()
    assert tok.startswith("dfp_") and len(tok) == len(
        jauth.new_personal_access_token())
    for roles in ([], ["root"], ["guest"], ["other"]):
        for method in ("GET", "head", "POST", "DELETE", "OPTIONS"):
            assert jauth.can(roles, method) == pauth.can(roles, method)


# -- rbac -----------------------------------------------------------------------

def test_the_enforcer_decides_as_the_jax_one():
    rng = random.Random(16)
    es = [jrbac.Enforcer(JDatabase()), prbac.Enforcer(PDatabase())]
    objects = ["jobs", "schedulers", "users", "*", "peers"]
    for _ in range(20):
        role = rng.choice(["op", "viewer", "admin"])
        obj, action = rng.choice(objects), rng.choice(["read", "*"])
        for e in es:
            e.add_policy(role, obj, action)
    for e in es:
        e.remove_policy("op", "jobs", "*")
        with pytest.raises(ValueError):
            e.add_policy("op", "jobs", "write")
    assert es[0].policies() == es[1].policies()
    assert es[0].policies("op") == es[1].policies("op")
    assert es[0].roles() == es[1].roles()
    for _ in range(300):
        roles = rng.sample(["root", "guest", "op", "viewer", "admin", "x"],
                           rng.randrange(0, 3))
        method = rng.choice(["GET", "POST", "PATCH", "DELETE", "HEAD"])
        path = rng.choice(["/api/v1/jobs", "/api/v1/jobs/3", "/healthy",
                           "/api/v1/schedulers/1", "/api/v1/users/2/roles",
                           "/api"])
        assert es[0].enforce_request(roles, method, path) == \
            es[1].enforce_request(roles, method, path)
    for path in ("/api/v1/jobs/3", "/x", "", "/api/v2/seed-peers"):
        assert jrbac.path_object(path) == prbac.path_object(path)


# -- searcher -------------------------------------------------------------------

def _clusters(rng: random.Random) -> list[dict]:
    out = []
    for i in range(12):
        scopes = {}
        if rng.random() < 0.5:
            scopes["cidrs"] = [rng.choice(["10.0.0.0/8", "192.168.1.0/24",
                                           "bad-cidr", "10.1.2.3/32"])]
        if rng.random() < 0.5:
            scopes["hostnames"] = [rng.choice(["^tpu-.*", "node[0-9]+",
                                               "(", "gpu"])]
        if rng.random() < 0.5:
            scopes["idc"] = rng.choice(["idc1", "idc2", ""])
        if rng.random() < 0.3:
            scopes["pod"] = rng.choice(["pod-a", "pod-b"])
        if rng.random() < 0.5:
            scopes["location"] = rng.choice(
                ["us|east|a", "us|east|b", "eu|west", "US|EAST"])
        out.append({"id": i + 1, "name": f"c{i}", "scopes": scopes,
                    "is_default": int(rng.random() < 0.2)})
    return out


def test_the_searcher_ranks_as_the_jax_one():
    rng = random.Random(1616)
    js, ps = jsearcher.Searcher(), psearcher.Searcher()
    for _ in range(40):
        clusters = _clusters(rng)
        for _ in range(10):
            kw = {"hostname": rng.choice(["tpu-3", "node7", "gpu1", ""]),
                  "ip": rng.choice(["10.1.2.3", "192.168.1.9", "x", ""]),
                  "idc": rng.choice(["idc1", "idc2", ""]),
                  "location": rng.choice(["us|east|a|r1", "eu", ""]),
                  "pod": rng.choice(["pod-a", ""])}
            jreq, preq = jsearcher.SearchRequest(**kw), psearcher.SearchRequest(
                **kw)
            assert [js.evaluate(jreq, c) for c in clusters] == [
                ps.evaluate(preq, c) for c in clusters]
            assert js.find_scheduler_clusters(clusters, jreq) == \
                ps.find_scheduler_clusters(clusters, preq)
    assert ps.find_scheduler_clusters([], psearcher.SearchRequest()) == []


# -- job queue --------------------------------------------------------------------

async def _queue_script(mod, db) -> list:
    out = []
    q = mod.JobQueue(db)
    a = q.enqueue_job(mod.PREHEAT_JOB, {"url": "u"}, [1, 2], user_id=3,
                      bio="b")
    b = q.enqueue_job(mod.SYNC_PEERS_JOB, {}, [2])
    out += [a, b, q.enqueue_job(mod.GET_TASK_JOB, {}, [])]
    items = []
    for queue in ("scheduler_1", "scheduler_2", "scheduler_2"):
        item = await q.poll(queue, timeout=1.0)
        items.append(item)
        out.append(item.to_wire())
    out.append(await q.poll("scheduler_1", timeout=0.01))     # timed out
    out.append(db.get("jobs", a["id"]))                      # STARTED
    q.complete(items[0].group_id, items[0].task_uuid, mod.SUCCESS,
               {"n": 1})
    q.complete(items[0].group_id, "nope", mod.SUCCESS, {})   # unknown
    out.append(db.get("jobs", a["id"]))                      # still open
    q.complete(items[1].group_id, items[1].task_uuid, mod.FAILURE,
               {"error": "x"})
    out.append(db.get("jobs", a["id"]))                      # FAILURE
    # A long poll woken by an enqueue from the same loop.
    waiter = asyncio.ensure_future(q.poll("scheduler_9", timeout=5.0))
    await asyncio.sleep(0.01)
    q.enqueue_job(mod.DELETE_TASK_JOB, {"task_id": "t"}, [9])
    out.append((await waiter).to_wire())
    # A restart over the same rows re-enqueues the unfinished jobs.
    q2 = mod.JobQueue(db)
    for queue in ("scheduler_2", "scheduler_9"):
        got = await q2.poll(queue, timeout=1.0)
        out.append(got.to_wire())
        q2.complete(got.group_id, got.task_uuid, mod.SUCCESS, {})
    out.append(db.list("jobs"))
    out.append(mod.queue_name(4))
    return out


def test_the_job_queue_fans_out_polls_completes_and_recovers(run_async):
    j = run_async(_queue_script(jjobqueue, JDatabase()))
    p = run_async(_queue_script(pjobqueue, PDatabase()))
    assert mask(j) == mask(p)
    for name in ("PENDING", "STARTED", "SUCCESS", "FAILURE", "PREHEAT_JOB",
                 "SYNC_PEERS_JOB", "GET_TASK_JOB", "DELETE_TASK_JOB"):
        assert getattr(jjobqueue, name) == getattr(pjobqueue, name)


# -- the service ------------------------------------------------------------------

def _service_script(svc, err) -> list:
    out = []
    out.append(svc.db.list("scheduler_clusters"))
    out.append(svc.db.list("users"))
    out.append(svc.signup("alice", "pw", "a@x"))
    with pytest.raises(err) as e:
        svc.signup("alice", "pw")
    out.append((int(e.value.code), e.value.message))
    tok = svc.signin("alice", "pw")
    out.append(svc.verify_token(tok))
    with pytest.raises(err) as e:
        svc.signin("alice", "bad")
    out.append((int(e.value.code), e.value.message))
    out.append(svc.roles_of(2))
    svc.grant_role(2, "op")
    svc.grant_role(2, "op")
    out.append(svc.roles_of(2))
    svc.revoke_role(2, "op")
    out.append(svc.roles_of(2))
    svc.reset_password(2, "new")
    out.append(svc.verify_token(svc.signin("alice", "new"))["name"])
    svc.db.insert("personal_access_tokens", {
        "name": "pat", "token": "dfp_x", "user_id": 2})
    out.append(svc.verify_token("dfp_x"))
    out.append(svc.verify_token("dfp_unknown"))
    s1 = svc.update_scheduler({"hostname": "s", "ip": "1.1.1.1", "port": 9})
    out.append(s1)
    out.append(svc.update_scheduler({"hostname": "s", "ip": "1.1.1.1",
                                     "idc": "x", "scheduler_cluster_id": 1}))
    out.append(svc.update_seed_peer({"hostname": "sp", "ip": "2.2.2.2",
                                     "download_port": 5, "type": "strong"}))
    gen = svc.keepalive_open("scheduler", "s", "1.1.1.1", 1)
    newer = svc.keepalive_open("scheduler", "s", "1.1.1.1", 1)
    svc.mark_inactive("scheduler", "s", "1.1.1.1", 1, gen=gen)  # stale
    out.append(svc.db.get("schedulers", s1["id"])["state"])
    svc.mark_inactive("scheduler", "s", "1.1.1.1", 1, gen=newer)
    out.append(svc.db.get("schedulers", s1["id"])["state"])
    svc.keepalive("scheduler", "s", "1.1.1.1", 1)
    out.append(svc.db.get("schedulers", s1["id"])["state"])
    out.append(svc.list_schedulers({"hostname": "h", "ip": "1.2.3.4"}))
    out.append(svc.list_schedulers({"hostname": "h", "ip": "1.2.3.4"}))
    out.append(svc.list_seed_peers_for_cluster(1))
    out.append(svc.get_scheduler_cluster_config(1))
    with pytest.raises(err) as e:
        svc.get_scheduler_cluster_config(42)
    out.append((int(e.value.code), e.value.message))
    out.append(svc.upsert_peer({"hostname": "p", "ip": "3.3.3.3",
                                "scheduler_cluster_id": 1, "port": 7}))
    out.append(svc.upsert_peer({"hostname": "p", "ip": "3.3.3.3",
                                "scheduler_cluster_id": 1, "os": "linux"}))
    out.append(svc.list_applications())
    # Job tokens: the default 10/s bucket, a retune, unknown clusters.
    out.append([svc.take_job_tokens([1]) for _ in range(12)])
    out.append(svc.take_job_tokens([1, 1, 99], tokens=0)[0])
    svc.db.update("scheduler_clusters", 1, {"config": {"job_rate_limit": 2}})
    out.append(svc.take_job_tokens(["1"], tokens=3))
    with pytest.raises(err) as e:
        svc.take_job_tokens([98, 99])
    out.append((int(e.value.code), e.value.message))
    with pytest.raises(err) as e:
        svc.take_job_tokens(["x"])
    out.append((int(e.value.code), e.value.message))
    # Admission from keepalive burn snapshots.
    out.append(svc.ingest_tenant_burn({"t1": {"burn": 3.5,
                                              "state": "breach"},
                                       "t2": {"burn": 0.5, "state": "ok"},
                                       "bad": 1}))
    out.append(svc.ingest_tenant_burn("junk"))
    out.append([svc.check_admission(t) for t in ("t1", "t2", "t3", "")])
    svc.keepalive_timeout = -1.0
    out.append(svc.expire_stale())
    out.append(svc.db.list("schedulers"))
    out.append(svc.db.list("seed_peers"))
    return out


def test_the_service_through_one_scripted_session():
    secret = b"s" * 32
    js = jservice.ManagerService()
    js.signer = jauth.TokenSigner(secret)
    ps = pservice.ManagerService()
    ps.signer = pauth.TokenSigner(secret)
    j, p = _service_script(js, JDfError), _service_script(ps, PDfError)
    assert mask(j) == mask(p)
    assert js.signer.secret == ps.signer.secret


# -- TTLCache, AdmissionController, Dynconfig -------------------------------------

def test_ttl_cache_as_the_jax_one(monkeypatch):
    now = [100.0]
    for mod in (jcache, pcache):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    caches = [jcache.TTLCache(default_ttl=10.0), pcache.TTLCache(10.0)]
    assert jcache.NO_EXPIRATION == pcache.NO_EXPIRATION
    got = []
    for c in caches:
        now[0] = 100.0
        c.set("a", 1)
        c.set("b", [2], ttl=1.0)
        c.set("c", 3, ttl=pcache.NO_EXPIRATION)
        seq = [c.get("a"), c.get("b"), sorted(c.keys()), len(c)]
        now[0] = 105.0
        seq += [c.get("b"), sorted(c.keys()), c.purge_expired()]
        now[0] = 111.0
        seq += [c.get("a"), c.get("c"), c.purge_expired(), len(c)]
        c.delete("c")
        c.delete("nope")
        seq += [c.get("c"), len(c)]
        got.append(seq)
    assert got[0] == got[1]


def test_admission_controller_as_the_jax_one():
    rng = random.Random(77)
    now = [0.0]
    ctrls = [m.AdmissionController(clock=lambda: now[0], max_tenants=6,
                                   stale_after_s=30.0)
             for m in (jadmission, padmission)]
    trace = [[], []]
    for step in range(200):
        now[0] += rng.choice([0.0, 1.0, 7.0])
        if rng.random() < 0.5:
            snap = {}
            for _ in range(rng.randrange(0, 4)):
                t = rng.choice(["a", "b", "c", "d", "e", "f", "g", "h",
                                "bad tenant!", ""])
                snap[t] = rng.choice([
                    {"burn": rng.random() * 20, "state": rng.choice(
                        ["ok", "warn", "breach", "no_data", "weird"])},
                    {"burn": "x"}, 3])
            for i, c in enumerate(ctrls):
                trace[i].append(c.ingest(snap))
        else:
            t = rng.choice(["a", "b", "c", "zz", ""])
            for i, c in enumerate(ctrls):
                trace[i].append(c.check(t))
    for i, c in enumerate(ctrls):
        trace[i].append(c.report())
        trace[i].append(c.ingest("junk"))
    assert trace[0] == trace[1]


async def _dynconfig_script(mod, tmp) -> list:
    out, calls, fail = [], {"n": 0}, {"on": False}

    async def fetch():
        if fail["on"]:
            raise RuntimeError("manager down")
        calls["n"] += 1
        return {"v": calls["n"] // 2}

    seen = []
    dc = mod.Dynconfig("t", fetch, cache_dir=tmp, refresh_interval=0.01)
    out.append(dc.cached())
    dc.register(seen.append)
    dc.register(lambda d: 1 / 0)          # a failing observer is logged
    out.append(await dc.get())
    for _ in range(3):
        out.append(await dc.refresh())
    out.append(list(seen))
    fail["on"] = True
    out.append(await dc.refresh())
    out.append(await dc.get())
    dc2 = mod.Dynconfig("t", fetch, cache_dir=tmp)
    out.append(dc2.cached())
    dc3 = mod.Dynconfig("t", fetch, cache_dir=tmp)
    out.append(await dc3.refresh())
    out.append(await dc3.get())
    out.append(await mod.Dynconfig("none", fetch).refresh())
    fail["on"] = False
    dc.serve()
    await asyncio.sleep(0.1)
    dc.stop()
    out.append(calls["n"] > 4)
    with open(f"{tmp}/dynconfig-t.json") as f:
        out.append(json.load(f))
    return out


def test_dynconfig_as_the_jax_one(run_async, tmp_path):
    j = run_async(_dynconfig_script(jdynconfig, str(tmp_path / "j")))
    p = run_async(_dynconfig_script(pdynconfig, str(tmp_path / "p")))
    assert j[:-2] == p[:-2] and j[-2] and p[-2]
    assert j[-1]["v"] >= 2 and p[-1]["v"] >= 2
    assert jdynconfig.DEFAULT_REFRESH_INTERVAL == \
        pdynconfig.DEFAULT_REFRESH_INTERVAL


def test_seed_peer_host_wire_as_the_jax_one():
    for row in ({"hostname": "h", "ip": "1.2.3.4", "port": 65000},
                {"hostname": "h", "ip": "::1", "port": 1, "type": "weak",
                 "download_port": 9, "idc": "i", "location": "l"},
                {"hostname": "h", "ip": "x", "port": 2, "type": "strong"},
                {"hostname": "h", "ip": "x", "port": 2, "type": "other"}):
        assert jsdynconfig.seed_peer_host_wire(row) == \
            psdynconfig.seed_peer_host_wire(row)


# -- config and the wire ------------------------------------------------------------

def test_manager_config_as_the_jax_one():
    d = {"server": {"host": "0.0.0.0", "port": 8080},
         "grpc": {"port": 65003}, "database": {"path": "/x.db"},
         "cluster": {"event_cap": 8}, "prof": {"enabled": False, "hz": 5.0},
         "keepalive_timeout": 5.0, "metrics_port": -1, "unknown": 1}
    for src in ({}, d):
        j, p = JManagerConfig.from_dict(src), PManagerConfig.from_dict(src)
        assert vars(j.server) == vars(p.server)
        assert vars(j.grpc) == vars(p.grpc)
        assert vars(j.database) == vars(p.database)
        assert vars(j.cluster) == vars(p.cluster)
        assert vars(j.prof) == vars(p.prof)
        for k in ("keepalive_gc_interval", "keepalive_timeout",
                  "metrics_port"):
            assert getattr(j, k) == getattr(p, k)
    for cls in (JManagerConfig, PManagerConfig):
        with pytest.raises(TypeError):
            cls.from_dict({"server": {"nope": 1}})


MANAGER_METHODS = sorted(m for m in jwire.UNARY if m.startswith("Manager."))


@pytest.mark.parametrize("method", MANAGER_METHODS + ["Manager.KeepAlive"])
def test_the_manager_schemas_are_the_jax_ones(method):
    table = "STREAM_OPEN" if method == "Manager.KeepAlive" else "UNARY"
    j, p = getattr(jwire, table)[method], getattr(pwire, table)[method]
    assert j.name == p.name
    assert {f: (v.type, v.required) for f, v in j.fields.items()} == {
        f: (v.type, v.required) for f, v in p.fields.items()}
    validate = ("validate_stream_open" if table == "STREAM_OPEN"
                else "validate_unary")
    rng = random.Random(method)
    values = [None, 1, 1.5, "s", True, [], {}, ["x"], {"k": 1}]
    for _ in range(60):
        body = {f: rng.choice(values) for f in j.fields
                if rng.random() < 0.7}
        if rng.random() < 0.2:
            body["extra"] = 1
        got = []
        for mod in (jwire, pwire):
            try:
                getattr(mod, validate)(method, body)
                got.append("ok")
            except mod.SchemaError as e:
                got.append(str(e))
        assert got[0] == got[1], body
