"""The port's scheduler end to end over loopback drpc.

The port's ``SchedulerServer`` with the port's daemons (``device="cpu"``,
each with its own work home and ports), an origin that counts its reads
(``chip_smoke.StandInGateway``) and the children of ``chip_smoke``'s
swarm path (``SwarmChild``: ``Daemon.Download`` onto the device sink, the
scheduler's answers recorded):

- a seed trigger: the first child's register triggers the seed daemon,
  which is handed out; the origin serves the content once;
- two children, the second registering while the first still downloads
  and handed it as a running parent;
- the striped broadcast: two same-slice ``pod_broadcast`` children each
  get a plan of two, and the seed serves one copy of the content;
- a parent that dies mid-transfer: the child reschedules with it
  blocklisted, is sent to the origin and completes;
- interop: a JAX daemon's pull after a JAX parent's through the port's
  scheduler ends with the same bytes, answers and states as through the
  JAX scheduler (both with ``fleet`` and ``podlens`` off).

Every byte landed is held to the content; every wait has its timeout.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import random

import torch

import chip_smoke
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.pkg import flight
from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

CPU = torch.device("cpu")
MiB = 1 << 20


def _scheduler(**scheduling) -> SchedulerServer:
    d = chip_smoke.swarm_scheduler_config()
    d["scheduling"] = {"retry_interval": 0.05, **scheduling}
    return SchedulerServer(SchedulerConfig.from_dict(d))


def _daemon(root, name, addr, *, seed=False, upload_rate=0, **kw) -> Daemon:
    d = chip_smoke.swarm_daemon_config(str(root), name, addr, seed=seed, **kw)
    d["upload"] = {"rate_limit": upload_rate}
    d["download"]["piece_concurrency"] = 1
    return Daemon(DaemonConfig.from_dict(d), device=CPU)


class Origin:
    """One object (or a few) behind ``StandInGateway``, read counts and
    all."""

    def __init__(self, objects: dict):
        self.gw = chip_smoke.StandInGateway()
        for key, data in objects.items():
            self.gw.put("origin", key, data)
        self.endpoint = self.gw.start()

    def url(self, key: str) -> str:
        return f"{self.endpoint}/buckets/origin/objects/{key}"

    def close(self) -> None:
        self.gw.close()


def _content(n: int, seed: int) -> bytes:
    return random.Random(seed).randbytes(n)


async def _until(pred, timeout: float, what: str) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


def test_seed_trigger_fanout_and_a_running_parent(run_async, tmp_path):
    content = _content(24 * MiB, 15)
    host = torch.frombuffer(bytearray(content), dtype=torch.uint8)
    sha = "sha256:" + hashlib.sha256(content).hexdigest()

    async def body():
        origin = Origin({"blob": content})
        sched = _scheduler()
        await sched.start()
        addr = f"127.0.0.1:{sched.port()}"
        handouts = []
        reattach = sched.service.scheduling.reattach_peer

        def recorded(peer, parents):
            handouts.append((peer.id, [(p.id, p.state) for p in parents]))
            return reattach(peer, parents)

        sched.service.scheduling.reattach_peer = recorded
        # The seed serves at 16 MiB/s: child 1 still downloads when
        # child 2 registers.
        seed = _daemon(tmp_path, "seed", addr, seed=True,
                       upload_rate=16 * MiB)
        await seed.start()
        kids = [chip_smoke.SwarmChild(str(tmp_path), n, addr, CPU)
                for n in ("c1", "c2")]
        for c in kids:
            await c.start()
        c1, c2 = kids
        url = origin.url("blob")
        task_id = FileTaskRequest(url=url, output="", meta=chip_smoke.UrlMeta(
            digest=sha)).task_id()
        body = {"url": url, "device": "tpu", "meta": {"digest": sha}}
        try:
            first = asyncio.ensure_future(c1.download(dict(body)))

            def c1_serves():
                task = sched.service.tasks.load(task_id)
                peer = task and next((p for p in task.peers()
                                      if p.host.id == c1.host_id), None)
                return peer is not None and len(peer.finished_pieces) >= 1
            await _until(c1_serves, 20, "child 1's first reported piece")
            last1, last2 = await asyncio.gather(
                first, c2.download(dict(body)))
            for last in (last1, last2):
                assert (last["state"], last["from_p2p"],
                        last["device_verified"]) == ("done", True, True)
            for c in kids:
                assert c.take_and_gate(task_id, host)["equal"]
            # The seed triggered and handed to child 1; child 2 handed the
            # running child 1 beside it.
            assert c1.answers[0]["type"] == "normal_task"
            assert [p.endswith("_Seed") for p in c1.answers[0]["parents"]] \
                == [True]
            c1_peer = c1.conductors[0].peer_id
            c2_peer = c2.conductors[0].peer_id
            c2_first = next(h for pid, h in handouts if pid == c2_peer)
            assert (c1_peer, "running") in c2_first
            # The origin served the content once (the seed's probe + GET).
            assert origin.gw.requests() == {"get_range": (1, 1),
                                            "get": (1, len(content))}
            task = sched.service.tasks.load(task_id)
            assert task.to_wire()["state"] == "succeeded"
            assert task.peer_count() == 3
            types = sorted(h.to_wire()["type"]
                           for h in sched.service.hosts.all())
            assert types == [0, 0, 1]
        finally:
            for c in kids:
                await c.stop()
            await seed.stop()
            await sched.stop()
            origin.close()

    run_async(body(), timeout=90)


def test_the_striped_broadcast_of_two_slice_mates(run_async, tmp_path):
    content = _content(16 * MiB, 16)
    host = torch.frombuffer(bytearray(content), dtype=torch.uint8)

    async def body():
        origin = Origin({"q": content})
        sched = _scheduler()
        await sched.start()
        addr = f"127.0.0.1:{sched.port()}"
        seed = _daemon(tmp_path, "seed", addr, seed=True, upload_rate=32 * MiB)
        await seed.start()
        kids = [chip_smoke.SwarmChild(str(tmp_path), f"s{i}", addr, CPU,
                                      tpu_slice="slice-x", worker=i)
                for i in range(2)]
        for c in kids:
            await c.start()
        url = origin.url("q")
        task_id = FileTaskRequest(url=url, output="").task_id()
        try:
            lasts = await asyncio.gather(*[c.download(
                {"url": url, "device": "tpu", "pod_broadcast": True})
                for c in kids])
            for c, last in zip(kids, lasts):
                assert last["state"] == "done" and last["from_p2p"]
                assert c.take_and_gate(task_id, host)["equal"]
            plans = [c.stripes[-1] for c in kids]
            assert sorted((p["slice_size"], p["slice_rank"])
                          for p in plans) == [(2, 0), (2, 1)]
            members = [c.conductors[0].peer_id for c in kids]
            assert plans[0]["members"] == plans[1]["members"] == members
            served = {h.id: h.upload_count
                      for h in sched.service.hosts.all()}
            n = len(sched.service.tasks.load(task_id).pieces)
            # The seed served each piece once; the mates the rest.
            assert served[seed.announcer.host_id] == n
            assert sum(served.values()) == 2 * n
        finally:
            for c in kids:
                await c.stop()
            await seed.stop()
            await sched.stop()
            origin.close()

    run_async(body(), timeout=90)


def test_a_parent_that_dies_mid_transfer(run_async, tmp_path):
    content = _content(24 * MiB, 17)
    host = torch.frombuffer(bytearray(content), dtype=torch.uint8)

    async def body():
        origin = Origin({"blob": content})
        sched = _scheduler(retry_back_to_source_limit=2, retry_limit=3)
        sched.config.seed_peer_enabled = False
        await sched.start()
        addr = f"127.0.0.1:{sched.port()}"
        # The parent fetches from the origin (the first peer, no seed),
        # then serves at 8 MiB/s.
        parent = _daemon(tmp_path, "p", addr, upload_rate=8 * MiB)
        await parent.start()
        pcli = chip_smoke.Client(chip_smoke.NetAddr.unix(
            parent.config.unix_sock))
        url = origin.url("blob")
        task_id = FileTaskRequest(url=url, output="").task_id()
        child = chip_smoke.SwarmChild(str(tmp_path), "c", addr, CPU)
        await child.start()
        # The child's landings wait at the sink until the parent is gone.
        sinks = child.daemon.task_manager.device_sinks
        landing, arrived, gate = sinks.on_piece, [], asyncio.Event()

        async def held(*args):
            arrived.append(args)
            await gate.wait()
            return await landing(*args)

        sinks.on_piece = held
        stopped = False
        try:
            stream = await pcli.open_stream("Daemon.Download", {
                "url": url, "output": str(tmp_path / "p.bin")})
            while (await stream.recv(timeout=30)) is not None:
                pass
            await pcli.close()
            origin_reads = origin.gw.requests()
            pull = asyncio.ensure_future(child.download(
                {"url": url, "device": "tpu"}))
            await _until(lambda: arrived, 20, "the child's first piece")
            await parent.stop()
            stopped = True
            gate.set()
            last = await asyncio.wait_for(pull, 60)
            assert (last["state"], last["from_p2p"]) == ("done", True)
            assert child.take_and_gate(task_id, host)["equal"]
            peer_id = child.conductors[0].peer_id
            events = [(code, note) for _t, code, _p, _a, note in
                      child.daemon.task_manager.flight.get(task_id).events()]
            assert (flight.EV_RESCHEDULE, "starvation") in events
            assert (flight.EV_SCHED_PUSH, "need_back_source") in events
            task = sched.service.tasks.load(task_id)
            peer = task.load_peer(peer_id)
            assert peer.reschedule_count >= 1 and len(peer.block_parents) == 1
            assert peer.id in task.back_to_source_peers
            # The remainder came from the origin.
            after = origin.gw.requests()
            assert sum(n for n, _ in after.values()) > sum(
                n for n, _ in origin_reads.values())
        finally:
            gate.set()
            await child.stop()
            if not stopped:
                await parent.stop()
            await sched.stop()
            origin.close()

    run_async(body(), timeout=120)


def _jax_pull_twice(tmp_path, which: str) -> dict:
    """A JAX parent, then a JAX child, each pulling the JAX harness's
    content through ``which`` scheduler; what the child got and what the
    scheduler holds."""
    from dragonfly2_tpu.client import dfget as dfget_lib
    from dragonfly2_tpu.proto.common import UrlMeta
    from dragonfly2_tpu.scheduler.config import SchedulerConfig as JConfig
    from dragonfly2_tpu.scheduler.server import SchedulerServer as JServer
    from tests.test_p2p_e2e import CONTENT, SHA, start_daemon, start_origin

    async def go():
        runner, oport, stats = await start_origin()
        cfg = JConfig() if which == "jax" else SchedulerConfig()
        cfg.server.port = 0
        cfg.metrics_port = -1
        cfg.fleet.enabled = False
        cfg.podlens.enabled = False
        cfg.scheduling.retry_interval = 0.05
        sched = JServer(cfg) if which == "jax" else SchedulerServer(cfg)
        await sched.start()
        root = tmp_path / which
        daemons = []
        try:
            out = {"results": []}
            for name in ("parent", "child"):
                d = await start_daemon(root, name, sched.port())
                daemons.append(d)
                r = await dfget_lib.download(dfget_lib.DfgetConfig(
                    url=f"http://127.0.0.1:{oport}/blob",
                    output=str(root / f"{name}.bin"),
                    daemon_sock=d.config.unix_sock, meta=UrlMeta(digest=SHA),
                    allow_source_fallback=False, timeout=60.0))
                out["results"].append({k: r.get(k) for k in (
                    "state", "content_length", "piece_count", "from_p2p")})
                assert (root / f"{name}.bin").read_bytes() == CONTENT
            task = sched.service.tasks.load(r["task_id"])
            # The task id hashes the URL, whose origin port differs.
            out["task"] = {k: v for k, v in task.to_wire().items()
                           if k not in ("id", "url")}
            out["peers"] = sorted((p.host.hostname, p.state,
                                   sorted(p.finished_pieces))
                                  for p in task.peers())
            out["origin"] = dict(stats)
            return out
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await runner.cleanup()

    return asyncio.run(asyncio.wait_for(go(), 90))


def test_a_jax_daemon_through_the_port_scheduler(tmp_path):
    jax = _jax_pull_twice(tmp_path, "jax")
    port = _jax_pull_twice(tmp_path, "port")
    assert port == jax
    assert port["results"][1]["from_p2p"]
    assert port["task"]["state"] == "succeeded"
    assert os.path.getsize(tmp_path / "port" / "child.bin") == \
        port["task"]["content_length"]
