"""The port's manager over loopback: drpc both ways, a preheat job onto a
seed's device sink, and mixed pairs with the JAX package.

- drpc: one scripted sequence over every ``Manager.*`` method the port
  serves (the registry, dynconfig's reads, ``PollJob`` with a job and
  with none, ``CompleteJob``, ``TakeJobTokens``, errors, and the
  ``KeepAlive`` stream with a tenant burn payload) through each
  package's ``ManagerClient`` against each package's ``ManagerServer``;
  the four answers and the servers' rows are equal with row times, uuids
  and keepalive times masked. Frames are byte-identical by construction
  (the port's codec, ``tests/test_torch_rpc.py``); this is their use.
- A preheat end to end on the CPU: the port's ``ManagerServer``, its
  ``SchedulerServer`` with ``manager_addr`` and its seed ``Daemon`` with
  a ``device="cpu"`` sink, the job posted over REST; once with scope
  ``all_seed_peers`` and ``device: "tpu"`` (the landed buffer equal to
  the content), once with two byte ranges (each ranged store equal to
  its slice). Each job's row equals the JAX trio's (``tests/
  test_scheduler_jobs.py``'s manager, scheduler and seed daemon) on the
  same origin, with ids and times masked.
- Mixed pairs: the port's scheduler registers with the JAX manager, and
  the JAX scheduler with the port's: each row active, each keepalive
  held, each dynconfig sees a seed peer added at the manager, and a
  ``sync_peers`` job round-trips.

Every wait has its timeout; each test has a time limit of its own.
"""

from __future__ import annotations

import asyncio
import http.client
import json

import torch

import chip_smoke
from dragonfly2_tpu.manager.client import ManagerClient as JClient
from dragonfly2_tpu.manager.config import ManagerConfig as JManagerConfig
from dragonfly2_tpu.manager.server import ManagerServer as JManagerServer
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.scheduler.config import SchedulerConfig as JSchedConfig
from dragonfly2_tpu.scheduler.server import SchedulerServer as JSchedServer
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.manager import ManagerConfig, ManagerServer
from dragonfly2_tpu_torch.manager.client import ManagerClient as PClient
from dragonfly2_tpu_torch.pkg import idgen
from dragonfly2_tpu_torch.pkg.errors import DfError as PDfError
from dragonfly2_tpu_torch.pkg.types import NetAddr as PNetAddr
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

from tests.test_p2p_e2e import CONTENT, start_origin
from tests.test_scheduler_jobs import _cluster as jax_cluster
from tests.test_torch_manager import mask

CPU = torch.device("cpu")


async def _until(pred, timeout: float, what: str) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def _managers():
    return {"jax": lambda: JManagerServer(JManagerConfig()),
            "port": lambda: ManagerServer(ManagerConfig.from_dict(
                {"metrics_port": -1}))}


CLIENTS = {"jax": (JClient, JNetAddr, JDfError),
           "port": (PClient, PNetAddr, PDfError)}


# -- drpc both ways -----------------------------------------------------------

async def _drpc_script(client_kind: str, server) -> list:
    cls, netaddr, err = CLIENTS[client_kind]
    c = cls(netaddr.tcp("127.0.0.1", server.grpc_port()))
    out = []

    async def expect_error(coro):
        try:
            await coro
        except err as e:
            return (int(e.code), e.message)
        raise AssertionError("no error")

    try:
        out.append(await c.update_scheduler(hostname="s1", ip="10.0.0.1",
                                            port=8002, idc="i",
                                            features=["f"]))
        out.append(await c.update_seed_peer(
            hostname="sp", ip="10.0.0.2", port=65000, download_port=65002,
            object_storage_port=65004, type="strong", location="a|b"))
        out.append(await c.get_scheduler_cluster_config(1))
        out.append(await c.list_schedulers(hostname="x", ip="10.0.0.9"))
        out.append(await c.list_seed_peers(1))
        out.append(await c.list_applications())
        out.append(await c.upsert_peer(hostname="p", ip="10.0.0.3", port=1,
                                       scheduler_cluster_id=1, os="linux"))
        call = c._client.call
        out.append(await call("Manager.GetScheduler", {
            "hostname": "s1", "ip": "10.0.0.1", "scheduler_cluster_id": 1}))
        out.append(await call("Manager.ListBuckets", {}))
        out.append(await call("Manager.DeleteSeedPeer", {
            "hostname": "sp", "ip": "10.0.0.2", "seed_peer_cluster_id": 1}))
        out.append(await c.list_seed_peers(1))
        out.append(await expect_error(call("Manager.GetScheduler", {
            "hostname": "no", "ip": "x", "scheduler_cluster_id": 1})))
        out.append(await expect_error(c.get_scheduler_cluster_config(42)))
        out.append(await expect_error(call("Manager.UpdateScheduler",
                                           {"hostname": "h"})))
        out.append(await expect_error(call("Manager.PollJob",
                                           {"queue": 3})))
        # The job queue: a poll with nothing queued, then one woken by an
        # enqueue on the manager's loop, completed.
        out.append(await c.poll_job("scheduler_1", timeout=0.05))
        poll = asyncio.ensure_future(c.poll_job("scheduler_1", timeout=5.0))
        await asyncio.sleep(0.05)
        job = server.service.jobs.enqueue_job(
            "preheat", {"urls": ["http://o/x"], "scope": "all_peers"}, [1])
        item = await poll
        out.append(item)
        await c.complete_job(item["group_id"], item["task_uuid"], "SUCCESS",
                             {"preheat": [], "n": 1})
        out.append(server.db.get("jobs", job["id"]))
        out.append(await c.take_job_tokens([1]))
        out.append(await c.take_job_tokens([1, "1"], tokens=0))
        out.append(await expect_error(c.take_job_tokens([98])))
        # The keepalive stream, its payload feeding admission; its end
        # turns the scheduler inactive.
        c.start_keepalive(source_type="scheduler", hostname="s1",
                          ip="10.0.0.1", cluster_id=1, interval=0.02,
                          payload=lambda: {"tenant_burn": {
                              "hot": {"burn": 3.0, "state": "breach"}}})
        await _until(lambda: not server.service.check_admission("hot")[0],
                     10, "the burn payload")
        out.append(server.service.check_admission("hot"))
        out.append(server.db.find("schedulers", hostname="s1")["state"])
    finally:
        await c.close()
    await _until(lambda: server.db.find("schedulers", hostname="s1")[
        "state"] == "inactive", 10, "the keepalive's end")
    out.append(server.db.list("schedulers"))
    out.append(server.db.list("peers"))
    return out


def test_drpc_in_both_directions_over_every_manager_method(run_async):
    async def body():
        got = {}
        for sk, make in _managers().items():
            for ck in CLIENTS:
                server = make()
                await server.start()
                try:
                    got[(ck, sk)] = await _drpc_script(ck, server)
                finally:
                    await server.stop()
        return got

    got = run_async(body(), timeout=90)
    ref = mask(got[("jax", "jax")])
    for key, answers in got.items():
        assert mask(answers) == ref, key


def test_a_cancelled_poll_drops_no_job(run_async):
    """A scheduler whose connection goes while its ``PollJob`` waits
    leaves the queue as it was: the job enqueued after goes to the next
    poll (the queue is at least once), on either package's manager."""
    async def body():
        got = {}
        for sk, make in _managers().items():
            server = make()
            await server.start()
            try:
                c = PClient(PNetAddr.tcp("127.0.0.1", server.grpc_port()))
                poll = asyncio.ensure_future(c.poll_job("scheduler_1",
                                                        timeout=5.0))
                await asyncio.sleep(0.1)
                await c.close()           # the connection goes mid-poll
                poll.cancel()
                await asyncio.gather(poll, return_exceptions=True)
                await asyncio.sleep(0.1)  # the server sees it go
                job = server.service.jobs.enqueue_job("sync_peers", {}, [1])
                c = PClient(PNetAddr.tcp("127.0.0.1", server.grpc_port()))
                try:
                    item = await c.poll_job("scheduler_1", timeout=2.0)
                finally:
                    await c.close()
                got[sk] = (item is not None and item["job_id"] == job["id"],
                           server.db.get("jobs", job["id"])["state"])
            finally:
                await server.stop()
        return got

    assert run_async(body(), timeout=30) == {"jax": (True, "STARTED"),
                                             "port": (True, "STARTED")}


# -- a preheat job end to end ---------------------------------------------------

def _rest(port: int, method: str, path: str, body=None, token=""):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    try:
        c.request(method, path, headers=headers,
                  body=None if body is None else json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


async def _run_job(rest_port: int, body: dict) -> dict:
    _, signin = await asyncio.to_thread(
        _rest, rest_port, "POST", "/api/v1/users/signin",
        {"name": "root", "password": "dragonfly"})
    token = signin["token"]
    status, job = await asyncio.to_thread(_rest, rest_port, "POST",
                                          "/api/v1/jobs", body, token)
    assert status == 200, job
    deadline = asyncio.get_running_loop().time() + 60
    while True:
        _, row = await asyncio.to_thread(_rest, rest_port, "GET",
                                         f"/api/v1/jobs/{job['id']}", None,
                                         token)
        if row["state"] in ("SUCCESS", "FAILURE"):
            return row
        assert asyncio.get_running_loop().time() < deadline, row
        await asyncio.sleep(0.05)


PREHEATS = (
    {"type": "preheat", "args": {"type": "file", "scope": "all_seed_peers",
                                 "device": "tpu", "timeout": 30.0}},
    {"type": "preheat", "args": {"type": "file", "scope": "all_seed_peers",
                                 "ranges": ["0-65535", "1048576-2097151"],
                                 "timeout": 30.0}},
)


def _with_url(job: dict, url: str) -> dict:
    return {**job, "args": {**job["args"], "url": url}}


async def _port_trio(tmp_path):
    manager = ManagerServer(ManagerConfig.from_dict({"metrics_port": -1}))
    await manager.start()
    d = chip_smoke.swarm_scheduler_config()
    d.update(scheduling={"retry_interval": 0.05},
             manager_addr=f"127.0.0.1:{manager.grpc_port()}")
    sched = SchedulerServer(SchedulerConfig.from_dict(d))
    await sched.start()
    assert sched.job_worker is not None
    seed = Daemon(DaemonConfig.from_dict(chip_smoke.swarm_daemon_config(
        str(tmp_path), "seed", f"127.0.0.1:{sched.port()}", seed=True,
        sink=True)), device=CPU)
    await seed.start()
    await _until(lambda: any(h.is_seed() for h in sched.service.hosts.all()),
                 15, "the seed's announce")
    return manager, sched, seed


def _store_bytes(tm, task_id: str) -> bytes:
    store = tm.storage.try_get(task_id)
    assert store is not None and store.metadata.done, task_id
    with open(store._data_path, "rb") as f:
        return f.read()


def test_a_preheat_job_lands_on_the_seeds_sink_as_the_jax_trio(
        run_async, tmp_path):
    async def body():
        runner, port, stats = await start_origin()
        url = f"http://127.0.0.1:{port}/blob"
        rows = {"jax": [], "port": []}
        try:
            manager, sched, seed = await jax_cluster(tmp_path / "jax")
            try:
                for job in PREHEATS:
                    rows["jax"].append(await _run_job(
                        manager.rest_port, _with_url(job, url)))
            finally:
                await seed.stop()
                await sched.stop()
                await manager.stop()
            manager, sched, seed = await _port_trio(tmp_path / "port")
            tm = seed.task_manager
            try:
                before = stats["blob_bytes"]
                rows["port"].append(await _run_job(
                    manager.rest_port, _with_url(PREHEATS[0], url)))
                task_id = idgen.task_id_v1(url)
                await _until(lambda: not tm.is_task_running(task_id)
                             and tm.device_sinks.get(task_id) is not None,
                             15, "the seed's sink")
                sink = tm.device_sinks.take(task_id)
                landed = bytes(sink.as_bytes_array().numpy())
                sink = None
                whole = _store_bytes(tm, task_id)
                origin_bytes = stats["blob_bytes"] - before
                rows["port"].append(await _run_job(
                    manager.rest_port, _with_url(PREHEATS[1], url)))
                spans = {}
                for span in PREHEATS[1]["args"]["ranges"]:
                    tid = idgen.task_id_v1(url, range_header=f"bytes={span}")
                    spans[span] = _store_bytes(tm, tid)
            finally:
                await seed.stop()
                await sched.stop()
                await manager.stop()
        finally:
            await runner.cleanup()
        return rows, landed, whole, origin_bytes, spans

    rows, landed, whole, origin_bytes, spans = run_async(body(), timeout=150)
    for j, p in zip(rows["jax"], rows["port"]):
        assert p["state"] == "SUCCESS", p
        assert mask(j) == mask(p)
    res = rows["port"][0]["result"]["group_results"][0]["preheat"]
    assert [(r["targets"], r["triggered"], r["succeeded"]) for r in res] \
        == [(1, 1, True)]
    assert landed == whole == CONTENT
    assert origin_bytes == len(CONTENT) + 1     # the probe byte and one copy
    for span, data in spans.items():
        a, b = (int(x) for x in span.split("-"))
        assert data == CONTENT[a:b + 1]


# -- mixed pairs ------------------------------------------------------------------

def test_the_ports_scheduler_registers_with_the_jax_manager(
        run_async, tmp_path):
    async def body():
        manager = JManagerServer(JManagerConfig())
        await manager.start()
        d = chip_smoke.swarm_scheduler_config()
        d.update(manager_addr=f"127.0.0.1:{manager.grpc_port()}",
                 manager_keepalive_interval=0.05, hostname="port-sched")
        sched = SchedulerServer(SchedulerConfig.from_dict(d))
        await sched.start()
        try:
            return await _mixed_pair(manager, sched)
        finally:
            await sched.stop()
            await manager.stop()

    out = run_async(body(), timeout=60)
    assert out["registered"]["hostname"] == "port-sched"


def test_the_jax_scheduler_registers_with_the_ports_manager(
        run_async, tmp_path):
    async def body():
        manager = ManagerServer(ManagerConfig.from_dict({"metrics_port": -1}))
        await manager.start()
        cfg = JSchedConfig()
        cfg.server.port = 0
        cfg.metrics_port = -1
        cfg.hostname = "jax-sched"
        cfg.manager_addr = f"127.0.0.1:{manager.grpc_port()}"
        cfg.manager_keepalive_interval = 0.05
        sched = JSchedServer(cfg)
        await sched.start()
        try:
            return await _mixed_pair(manager, sched)
        finally:
            await sched.stop()
            await manager.stop()

    out = run_async(body(), timeout=60)
    assert out["registered"]["hostname"] == "jax-sched"


async def _mixed_pair(manager, sched) -> dict:
    """The scheduler's row active at the manager, its keepalive holding
    it so, a seed peer added at the manager reaching its dynconfig and
    its resource layer, and a sync_peers job round-tripped."""
    reg = sched.announcer.registered
    row = manager.db.get("schedulers", reg["id"])
    assert row["state"] == "active" and row["port"] == sched.port()
    ka0 = row["last_keepalive_at"]
    await _until(lambda: manager.db.get("schedulers", reg["id"])[
        "last_keepalive_at"] > ka0, 10, "a keepalive")
    manager.service.update_seed_peer({
        "hostname": "sp1", "ip": "10.9.9.9", "port": 65000,
        "download_port": 65002})
    await sched.dynconfig.dc.refresh()
    assert [sp["hostname"] for sp in await sched.dynconfig.seed_peers()] \
        == ["sp1"]
    host = sched.service.hosts.load("sp1-10.9.9.9-seed")
    assert host is not None and host.is_seed() and host.port == 65000
    job = manager.service.jobs.enqueue_job("sync_peers", {},
                                           [reg["scheduler_cluster_id"]])
    await _until(lambda: manager.db.get("jobs", job["id"])["state"]
                 == "SUCCESS", 15, "the sync_peers job")
    result = manager.db.get("jobs", job["id"])["result"]
    assert result["group_results"][0]["synced"] >= 1
    assert manager.db.find("peers", hostname="sp1") is not None
    return {"registered": reg, "result": result}
