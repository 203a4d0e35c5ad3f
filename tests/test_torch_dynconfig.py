"""The daemon's manager-fed dynconfig (``dragonfly2_tpu_torch/daemon/
dynconfig.py``) and its wiring in the port's ``Daemon``, against the JAX
daemon's, on the port's manager and scheduler.

Twins of ``tests/test_dynconfig.py`` (a daemon with only a manager
resolves the active scheduler and announces to it) and of
``tests/test_scheduler_ha.py``'s manager-liveness case (a scheduler
whose keepalive lapses leaves the daemon's list on the next refresh, and
the scheduler client's ring is rebuilt), plus: a scheduler that
registers after the daemon started is picked up on the next refresh and
the announcer starts late; ``cached_seed_peers()`` gives the seed peers
the manager lists; the object gateway replicates a PUT to them. Each
case runs the JAX daemon (or ``DaemonDynconfig``) and the port's on the
same manager, and compares what they did.
"""

from __future__ import annotations

import asyncio
import os
import time

from dragonfly2_tpu.client.dfstore import Dfstore as JDfstore
from dragonfly2_tpu.daemon.config import DaemonConfig as JConfig
from dragonfly2_tpu.daemon.daemon import Daemon as JDaemon
from dragonfly2_tpu.daemon.dynconfig import DaemonDynconfig as JDynconfig
from dragonfly2_tpu.daemon.schedulerclient import (
    SchedulerClient as JSchedulerClient,
)
from dragonfly2_tpu_torch.client.dfstore import Dfstore
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.dynconfig import DaemonDynconfig
from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
from dragonfly2_tpu_torch.manager import ManagerConfig, ManagerServer
from dragonfly2_tpu_torch.manager import service as msvc_mod
from dragonfly2_tpu_torch.pkg import idgen
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Server
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import SchedulerServer


def _config(tmp_path, pkg: str, name: str, manager: str, **over):
    d = {"work_home": str(tmp_path / f"{pkg}-{name}"),
         "host": {"hostname": f"{pkg}-{name}", "ip": "127.0.0.1"},
         "manager_addr": manager, "metrics_port": -1, "gc_interval": 3600,
         "download": {"piece_concurrency": 1,
                      "concurrent_min_length": 1 << 40}}
    d.update(over)
    return d


def _daemon(pkg: str, d: dict):
    if pkg == "jax":
        return JDaemon(JConfig.from_dict(d))
    return Daemon(DaemonConfig.from_dict(d), device="cpu")


async def _manager() -> ManagerServer:
    m = ManagerServer(ManagerConfig.from_dict({"metrics_port": -1}))
    await m.start()
    return m


async def _scheduler(manager: ManagerServer) -> SchedulerServer:
    s = SchedulerServer(SchedulerConfig.from_dict({
        "server": {"port": 0}, "metrics_port": -1,
        "manager_addr": f"127.0.0.1:{manager.grpc_port()}"}))
    await s.start()
    return s


async def _announced(sched: SchedulerServer, hostname: str,
                     timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(h.hostname == hostname for h in sched.service.hosts.all()):
            return True
        await asyncio.sleep(0.05)
    return False


def test_a_daemon_with_only_a_manager_resolves_and_announces(
        tmp_path, run_async):
    async def run():
        manager = await _manager()
        sched = await _scheduler(manager)
        addr = f"127.0.0.1:{manager.grpc_port()}"
        out = {}
        try:
            for pkg in ("jax", "port"):
                d = _daemon(pkg, _config(tmp_path, pkg, "d", addr))
                try:
                    await d.start()
                    out[pkg] = (sorted(d.scheduler_client._ring.members()),
                                d.dynconfig.source,
                                await _announced(sched, f"{pkg}-d"))
                finally:
                    await d.stop()
            return out, sched.port()
        finally:
            await sched.stop()
            await manager.stop()

    out, port = run_async(run(), timeout=90)
    assert out["port"] == out["jax"] == (
        [f"127.0.0.1:{port}"], "manager", True)


def test_a_scheduler_registered_later_is_picked_up_on_refresh(
        tmp_path, run_async):
    async def run():
        manager = await _manager()
        addr = f"127.0.0.1:{manager.grpc_port()}"
        daemons = {pkg: _daemon(pkg, _config(tmp_path, pkg, "late", addr))
                   for pkg in ("jax", "port")}
        sched = None
        out = {}
        try:
            for d in daemons.values():
                await d.start()
            before = {pkg: (d.scheduler_client, d.announcer)
                      for pkg, d in daemons.items()}
            sched = await _scheduler(manager)
            for pkg, d in daemons.items():
                # One step of the refresh loop.
                assert await d.dynconfig.dc.refresh()
                out[pkg] = (before[pkg],
                            sorted(d.scheduler_client._ring.members()),
                            d.task_manager.scheduler_client
                            is d.scheduler_client,
                            d.announcer is not None,
                            await _announced(sched, f"{pkg}-late"))
            return out, sched.port()
        finally:
            for d in daemons.values():
                await d.stop()
            if sched is not None:
                await sched.stop()
            await manager.stop()

    out, port = run_async(run(), timeout=90)
    assert out["port"] == out["jax"] == (
        (None, None), [f"127.0.0.1:{port}"], True, True, True)


def test_cached_seed_peers_are_the_managers(run_async):
    async def run():
        manager = await _manager()
        addr = f"127.0.0.1:{manager.grpc_port()}"
        svc = manager.service
        svc.update_scheduler({"hostname": "s1", "ip": "10.0.0.1",
                              "port": 8002})
        for i in range(2):
            svc.update_seed_peer({"hostname": f"seed-{i}", "ip": "10.0.1.1",
                                  "port": 65100 + i,
                                  "download_port": 65200 + i})
        out = {}
        try:
            for pkg, cls in (("jax", JDynconfig), ("port", DaemonDynconfig)):
                dc = cls(manager_addr=addr,
                         host_info={"hostname": "w", "ip": "127.0.0.1"})
                try:
                    empty = dc.cached_seed_peers()
                    addrs = await dc.scheduler_addrs()
                    out[pkg] = (empty, addrs, dc.cached_seed_peers(),
                                dc.source)
                finally:
                    await dc.stop()
            local = DaemonDynconfig(local_addrs=["1.2.3.4:8002"])
            out["local"] = (local.source, await local.scheduler_addrs(),
                            local.cached_seed_peers())
            return out, svc.list_seed_peers_for_cluster(1)
        finally:
            await manager.stop()

    out, listed = run_async(run(), timeout=60)
    assert out["port"] == out["jax"]
    empty, addrs, seeds, source = out["port"]
    assert empty == [] and addrs == ["10.0.0.1:8002"] and source == "manager"
    assert seeds == listed and len(seeds) == 2
    assert out["local"] == ("local", ["1.2.3.4:8002"], [])


def test_a_lapsed_scheduler_leaves_the_ring_on_the_next_refresh(run_async):
    """Two schedulers register with the manager; one's keepalive lapses,
    the manager's sweep turns it inactive, the next dynconfig pull lists
    only the survivor and the scheduler client's ring is rebuilt to it."""
    async def run():
        msvc = msvc_mod.ManagerService()
        from dragonfly2_tpu_torch.manager.rpcserver import ManagerRpcServer

        server = Server("manager")
        ManagerRpcServer(msvc).register(server)
        await server.serve(NetAddr.tcp("127.0.0.1", 0))
        addr_a, addr_b = "10.0.0.1:8002", "10.0.0.2:8002"
        out = {}
        try:
            for host, ip in (("sched-a", "10.0.0.1"), ("sched-b", "10.0.0.2")):
                msvc.update_scheduler({"hostname": host, "ip": ip,
                                       "port": 8002})
            dcs = {"jax": (JDynconfig, JSchedulerClient),
                   "port": (DaemonDynconfig, SchedulerClient)}
            clients = {}
            for pkg, (dcls, ccls) in dcs.items():
                dc = dcls(local_addrs=[],
                          manager_addr=f"127.0.0.1:{server.port()}",
                          host_info={"hostname": "d1", "ip": "127.0.0.1"},
                          refresh_interval=0.05)
                addrs = sorted(await dc.scheduler_addrs())
                clients[pkg] = (dc, ccls(addrs), addrs)
            row = msvc.db.find("schedulers", hostname="sched-a",
                               ip="10.0.0.1")
            msvc.db.update("schedulers", row["id"], {
                "last_keepalive_at":
                    time.time() - msvc_mod.KEEPALIVE_TIMEOUT - 1})
            expired = msvc.expire_stale()
            msvc._cache = type(msvc._cache)(default_ttl=0.0)
            for pkg, (dc, cli, addrs) in clients.items():
                fired = []
                dc.register(fired.append)
                assert await dc.dc.refresh()
                live = await dc.scheduler_addrs()
                cli.update_addrs(live)
                out[pkg] = (addrs, expired, live,
                            sorted(cli._ring.members()), len(fired))
                await cli.close()
                await dc.stop()
            return out
        finally:
            await server.close()

    out = run_async(run(), timeout=60)
    assert out["port"] == out["jax"] == (
        ["10.0.0.1:8002", "10.0.0.2:8002"], 1, ["10.0.0.2:8002"],
        ["10.0.0.2:8002"], 1)


class _SeedRecorder:
    """A seed peer's drpc ``Peer.TriggerDownloadTask``, recorded."""

    def __init__(self):
        self.specs: list = []
        self.server = Server("seed")
        self.server.register_unary("Peer.TriggerDownloadTask", self._trigger)

    async def _trigger(self, body, ctx):
        self.specs.append(dict(body))
        return {"ok": True}


def test_a_gateway_put_is_replicated_to_the_managers_seed_peers(
        tmp_path, run_async):
    payload = os.urandom(300_000)

    async def run():
        manager = await _manager()
        sched = await _scheduler(manager)
        seed = _SeedRecorder()
        await seed.server.serve(NetAddr.tcp("127.0.0.1", 0))
        manager.service.update_seed_peer({
            "hostname": "seed-r", "ip": "127.0.0.1",
            "port": seed.server.port(), "download_port": 1})
        addr = f"127.0.0.1:{manager.grpc_port()}"
        out = {}
        try:
            for pkg, store_cls in (("jax", JDfstore), ("port", Dfstore)):
                root = str(tmp_path / f"{pkg}-buckets")
                d = _daemon(pkg, _config(
                    tmp_path, pkg, "gw", addr,
                    object_storage={"enabled": True, "port": 0,
                                    "backend_options": {"root": root}}))
                try:
                    await d.start()
                    known = d._known_seed_peers()
                    store = store_cls(
                        f"http://127.0.0.1:{d.object_storage.port}")
                    try:
                        await store.create_bucket("b")
                        digest = await store.put_object(
                            "b", "k/model.bin", payload, mode="write_back")
                    finally:
                        await store.close()
                    # The task id is the gateway GET's, over each twin's
                    # own root: checked, then masked with the root.
                    assert all(s["task_id"] == idgen.task_id_v1(
                        s["url"], tag=s["tag"]) for s in seed.specs)
                    specs = [{k: (v.replace(root, "<root>")
                                  if isinstance(v, str) else v)
                              for k, v in s.items() if k != "task_id"}
                             for s in seed.specs]
                    seed.specs.clear()
                    out[pkg] = ([(s["hostname"], s["port"]) for s in known],
                                digest, specs)
                finally:
                    await d.stop()
            return out, seed.server.port()
        finally:
            await seed.server.close()
            await sched.stop()
            await manager.stop()

    out, seed_port = run_async(run(), timeout=90)
    assert out["port"][0] == out["jax"][0] == [("seed-r", seed_port)]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    (spec,) = out["port"][2]
    assert spec["tag"] == "b" and spec["digest"] == out["port"][1]
    assert spec["url"].startswith("file://") and "<root>" in spec["url"]
