"""The port's ``Daemon`` against the JAX one.

On the CPU (``device="cpu"``), with the JAX ``SchedulerServer`` of
``tests/test_p2p_e2e.py`` over drpc and its aiohttp origin:

- the port daemon registers with the JAX scheduler under the announcer's
  ``host_wire`` (the scheduler's host record is it less the telemetry,
  whose three keys it fills), its start's double announce leaves a clock
  sample, a pull through the conductor makes the scheduler's scorecard of
  the host, which the next announce snapshots into the flight recorder,
  and ``stop()`` leaves the scheduler's host registry;
- ``Daemon.Download`` with ``device: "tpu"`` over each daemon's
  ``unix_sock`` gives the same frames (task id, lengths, reuse) and the
  same bytes in each daemon's device sink, cold and warm;
- the conductor takes its piece workers, report batch and ``is_seed``
  from the config, as the JAX daemon's ``_make_conductor`` does, with the
  same host record;
- ``download.prefetch``, ``download.rate_limit`` and the sampling traffic
  shaper's loop act as in the JAX daemon;
- the GC loop reclaims an expired task and sweeps the device sinks;
- a config that enables a service the port lacks raises ``ValueError``
  naming it, and ``Daemon(config)`` with no CUDA refuses to run unasked;
- ``serve()`` honours ``alive_time``; ``/metrics`` serves the registry;
  no ``df-`` thread outlives ``stop()``.

Content comes from the JAX harness's seeded origin; tolerance 0.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import http.client
import os
import threading
import time

import numpy as np
import pytest

from dragonfly2_tpu.daemon.config import DaemonConfig as JConfig
from dragonfly2_tpu.daemon.daemon import Daemon as JDaemon
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.rpc import Client
from tests.test_p2p_e2e import CONTENT, start_origin, start_scheduler

TELEMETRY = {"cpu_percent", "mem_percent", "disk_free"}


def _config(tmp_path, name: str, *, scheduler: int = 0, **over) -> dict:
    """A daemon's config dict: loopback, its own work home and socket,
    an ephemeral peer port, no /metrics unless asked."""
    home = tmp_path / name
    d = {"work_home": str(home),
         "host": {"hostname": name, "ip": "127.0.0.1"},
         "download": {"unix_sock": str(home / "d.sock"),
                      "piece_concurrency": 1,
                      "concurrent_min_length": 1 << 40},
         "metrics_port": -1, "gc_interval": 3600}
    if scheduler:
        d["scheduler"] = {"addrs": [f"127.0.0.1:{scheduler}"]}
    for k, v in over.items():
        if isinstance(v, dict):
            d[k] = {**d.get(k, {}), **v}
        else:
            d[k] = v
    return d


def _jax_daemon(d: dict) -> JDaemon:
    return JDaemon(JConfig.from_dict(d))


def _port_daemon(d: dict) -> Daemon:
    return Daemon(DaemonConfig.from_dict(d), device="cpu")


def _df_threads(but=frozenset()) -> list[str]:
    """The ``df-`` threads alive, less those in ``but``."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("df-") and t not in but)


async def _no_df_threads(but, timeout: float = 10.0) -> list[str]:
    deadline = time.monotonic() + timeout
    while _df_threads(but) and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
    return _df_threads(but)


async def _download(client, body: dict) -> list[dict]:
    stream = await client.open_stream("Daemon.Download", body)
    frames = []
    while (msg := await stream.recv(timeout=30)) is not None:
        frames.append({k: v for k, v in msg.items() if k != "peer_id"})
    return frames


def test_the_port_daemon_registers_with_and_leaves_a_jax_scheduler(
        run_async, tmp_path):
    async def run():
        sched = await start_scheduler()
        runner, port, _ = await start_origin()
        d = _port_daemon(_config(tmp_path, "port-d", scheduler=sched.port(),
                                 tpu_sink={"enabled": True}))
        try:
            await d.start()
            wire = d.announcer.host_wire()
            host = sched.service.hosts.load(wire["id"])
            assert host is not None and wire["id"] == f"port-d-{d.peer_port()}"
            assert host.to_wire() == {k: v for k, v in wire.items()
                                      if k != "telemetry"}
            assert set(wire["telemetry"]) == TELEMETRY
            assert host.telemetry.disk_free > 0
            assert 0 < host.telemetry.mem_percent <= 100
            # The double announce at start shipped one clock sample.
            assert sched.service.pod_lens.clock.estimate(wire["id"])[2] >= 1
            # A pull through the conductor (no parent: back-to-source)
            # gives the scheduler a scorecard row for this host.
            cli = Client(NetAddr.unix(d.config.unix_sock))
            try:
                frames = await _download(cli, {
                    "url": f"http://127.0.0.1:{port}/blob", "device": "tpu"})
            finally:
                await cli.close()
            assert frames[-1]["state"] == "done"
            sink = d.task_manager.device_sinks.take(frames[-1]["task_id"])
            assert bytes(sink.as_bytes_array().numpy()) == CONTENT
            await d.announcer.announce_once()
            snap = d.task_manager.flight.scorecard_snapshot
            assert snap["at_wall"] > 0 and snap["down_samples"] >= 1
        finally:
            await d.stop()
            await runner.cleanup()
        assert sched.service.hosts.load(wire["id"]) is None
        await sched.stop()

    run_async(run(), timeout=120)


def test_download_over_the_unix_sock_matches_the_jax_daemon(
        run_async, tmp_path):
    async def run():
        runner, port, stats = await start_origin()
        url = f"http://127.0.0.1:{port}/blob"
        out = {}
        try:
            for name, make, client in (("jax", _jax_daemon, JClient),
                                       ("port", _port_daemon, Client)):
                d = make(_config(tmp_path, name, tpu_sink={"enabled": True}))
                await d.start()
                cli = client((JNetAddr if name == "jax" else NetAddr).unix(
                    d.config.unix_sock))
                try:
                    frames = []
                    for meta in ({"tag": "t"}, {"tag": "t"},
                                 {"range": "bytes=100-1048675"}):
                        s0 = dict(stats)
                        fr = await _download(cli, {"url": url,
                                                   "device": "tpu",
                                                   "meta": meta})
                        tid = fr[-1]["task_id"]
                        sink = d.task_manager.device_sinks.take(tid)
                        u8 = np.asarray(sink.as_bytes_array()) \
                            if name == "jax" else \
                            sink.as_bytes_array().numpy()
                        frames.append((fr[-1], {k: stats[k] - s0[k]
                                                for k in stats},
                                       hashlib.sha256(u8.tobytes()).digest()))
                    out[name] = frames
                finally:
                    await cli.close()
                    await d.stop()
        finally:
            await runner.cleanup()
        assert out["port"] == out["jax"]
        (cold, _, h1), (warm, reqs, h2), (ranged, _, h3) = out["port"]
        assert (cold["from_reuse"], warm["from_reuse"]) == (False, True)
        assert reqs == {"blob_streams": 0, "blob_bytes": 0} and h1 == h2 == hashlib.sha256(CONTENT).digest()
        assert h3 == hashlib.sha256(CONTENT[100:1048676]).digest()

    run_async(run(), timeout=120)


def test_the_conductor_takes_its_settings_from_the_config(
        run_async, tmp_path):
    async def run():
        sched = await start_scheduler()
        try:
            for seed in (False, True):
                over = {"download": {"parent_concurrency": 7,
                                     "report_batch": 5},
                        "seed_peer": seed}
                got = []
                for name, make in (("jax", _jax_daemon),
                                   ("port", _port_daemon)):
                    d = make(_config(tmp_path, f"{name}-{seed}",
                                     scheduler=sched.port(), **over))
                    await d.start()
                    try:
                        req = FileTaskRequest(url="http://x/y", output="",
                                              meta=UrlMeta(tag="g"))
                        if name == "jax":
                            make_c = d._make_conductor
                        else:
                            make_c = d.task_manager.conductor_factory
                        row = []
                        for is_seed in (False, True):
                            c = make_c(task_id="t" * 64, peer_id="p",
                                       request=req, store=None,
                                       on_piece=None, is_seed=is_seed)
                            info = dict(c.host_info)
                            assert info == {
                                k: v for k, v in d.announcer.host_wire().items()
                                if k != "telemetry"}
                            for k in ("id", "port", "upload_port", "hostname"):
                                info.pop(k)
                            row.append((c.piece_parallelism, c.report_batch,
                                        c.is_seed, info, c.meta))
                        got.append(row)
                    finally:
                        await d.stop()
                assert got[0] == got[1]
                assert [r[:3] for r in got[1]] == [(7, 5, seed), (7, 5, True)]
        finally:
            await sched.stop()

    run_async(run(), timeout=120)


def test_prefetch_rate_limit_and_the_shaper_loop(run_async, tmp_path):
    """A ranged miss with ``prefetch`` starts the whole task; a 4 MiB/s
    daemon takes at least (10 MiB - the 4 MiB burst) / 4 MiB/s for the
    content; the sampling shaper's loop runs from start to stop. The JAX
    daemon, same config, does the same."""
    async def run():
        runner, port, stats = await start_origin()
        url = f"http://127.0.0.1:{port}/blob"
        floor = (len(CONTENT) - (4 << 20)) / (4 << 20)
        try:
            for name, make, client in (("jax", _jax_daemon, JClient),
                                       ("port", _port_daemon, Client)):
                d = make(_config(tmp_path, name, download={
                    "prefetch": True, "rate_limit": "4MiB",
                    "traffic_shaper": "sampling"}))
                await d.start()
                cli = client((JNetAddr if name == "jax" else NetAddr).unix(
                    d.config.unix_sock))
                try:
                    assert d.task_manager.shaper.algorithm == "sampling"
                    loop_task = d.task_manager.shaper._loop_task
                    assert loop_task is not None and not loop_task.done()
                    t0 = time.monotonic()
                    fr = await _download(cli, {
                        "url": url, "output": str(tmp_path / f"{name}.part"),
                        "meta": {"range": "bytes=0-99"}})
                    assert fr[-1]["state"] == "done"
                    whole = FileTaskRequest(url=url, output="").task_id()
                    while d.storage.find_completed_task(whole) is None:
                        await asyncio.sleep(0.02)
                    assert time.monotonic() - t0 >= floor * 0.9
                    with open(d.storage.find_completed_task(whole).data_path,
                              "rb") as f:
                        assert f.read() == CONTENT
                finally:
                    await cli.close()
                    await d.stop()
                assert loop_task.done()
        finally:
            await runner.cleanup()

    run_async(run(), timeout=120)


def test_the_gc_loop_reclaims_an_expired_task_and_sweeps_the_sinks(
        run_async, tmp_path):
    async def run():
        runner, port, _ = await start_origin()
        d = _port_daemon(_config(tmp_path, "gc", gc_interval=0.1,
                                 storage={"task_ttl": 0.3},
                                 tpu_sink={"enabled": True}))
        sweeps = []
        real_gc = d.task_manager.device_sinks.gc
        d.task_manager.device_sinks.gc = lambda: sweeps.append(1) or real_gc()
        try:
            await d.start()
            cli = Client(NetAddr.unix(d.config.unix_sock))
            try:
                fr = await _download(cli, {
                    "url": f"http://127.0.0.1:{port}/blob",
                    "output": str(tmp_path / "out")})
            finally:
                await cli.close()
            tid = fr[-1]["task_id"]
            assert d.storage.find_completed_task(tid) is not None
            deadline = time.monotonic() + 10
            while d.storage.try_get(tid) is not None:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            assert sweeps
        finally:
            await d.stop()
            await runner.cleanup()

    run_async(run(), timeout=60)


@pytest.mark.parametrize("over,names", [
    ({"proxy": {"enabled": True}}, "proxy.enabled"),
    ({"qos": {"enabled": True}}, "qos.enabled"),
    ({"manager_addr": "127.0.0.1:65003"}, "manager_addr"),
    ({"object_storage": {"enabled": True, "backend": "s3"}},
     "backend 's3' is not ported yet"),
    ({"object_storage": {"enabled": True, "backend": "gcs"}},
     "backend 'gcs' is not ported yet"),
    ({"object_storage": {"enabled": True, "backend": "oss"}},
     "backend 'oss' is not ported yet"),
    ({"object_storage": {"enabled": True, "backend": "obs"}},
     "backend 'obs' is not ported yet"),
    ({"object_storage": {"enabled": True, "backend": "ftp"}},
     "backend 'ftp' is unknown"),
])
def test_a_config_that_needs_an_unported_service_is_refused(
        tmp_path, over, names):
    with pytest.raises(ValueError, match=names) as e:
        _port_daemon(_config(tmp_path, "r", **over))
    assert "ROADMAP" in str(e.value)
    # Off, or a backend the gateway has: accepted.
    _port_daemon(_config(tmp_path, "ok", object_storage={
        "backend": over.get("object_storage", {}).get("backend", "fs")}))


def test_without_cuda_the_daemon_runs_only_when_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Daemon(DaemonConfig.from_dict(_config(tmp_path, "n")))
    assert _port_daemon(_config(tmp_path, "c")).device.type == "cpu"


def test_serve_honours_alive_time_and_no_df_thread_outlives_stop(
        run_async, tmp_path):
    """A daemon with every service the port has (peer service, upload,
    gateway, /metrics, PEX, the device sink, the GC loop) serves until
    its ``alive_time``; requests reach the gateway and /metrics; after
    ``stop()`` no ``df-`` thread is left."""

    def get(port: int, path: str) -> tuple[int, bytes]:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request("GET", path)
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    async def run():
        # Threads of other daemons of this process (the JAX package's
        # native I/O pool lives as long as the process).
        before = frozenset(threading.enumerate())
        d = _port_daemon(_config(
            tmp_path, "all", metrics_port=0, alive_time=1.0, gc_interval=0.1,
            tpu_sink={"enabled": True}, pex={"enabled": True},
            object_storage={"enabled": True, "backend_options": {
                "root": str(tmp_path / "buckets")}}))
        t0 = time.monotonic()
        serving = asyncio.ensure_future(d.serve())
        while d.object_storage.port == 0 or d.metrics is None \
                or d.metrics.port == 0:
            await asyncio.sleep(0.01)
        loop = asyncio.get_running_loop()
        status, body = await loop.run_in_executor(
            None, get, d.object_storage.port, "/healthy")
        assert (status, body) == (200, b'{"ok": true, "backend": "fs"}')
        status, body = await loop.run_in_executor(
            None, get, d.metrics.port, "/metrics")
        assert status == 200
        assert b"objectstorage_requests_total" in body
        assert {"df-gateway-accept", "df-metrics-accept",
                "df-upload-accept"} <= set(_df_threads())
        await serving
        assert time.monotonic() - t0 >= 1.0
        await d.stop()
        assert await _no_df_threads(before) == []

    run_async(run(), timeout=60)


def test_the_config_sizes_reach_the_daemon(tmp_path):
    d = _port_daemon(_config(tmp_path, "s", download={"rate_limit": "2MiB"},
                             storage={"fd_idle_close": 7.0},
                             tpu_sink={"enabled": True, "batch_pieces": 3,
                                       "max_tasks": 2}))
    assert d.task_manager.shaper.total_rate == 2 << 20
    assert d.piece_manager.limiter.limit == 2 << 20
    assert dataclasses.asdict(d.storage.opt)["fd_idle_close"] == 7.0
    assert d.storage.opt.gc_interval == 3600
    sinks = d.task_manager.device_sinks
    assert (sinks.batch_pieces, sinks.max_tasks) == (3, 2)
    assert d.rpc.device == d.device and d.device.type == "cpu"
    assert os.path.isdir(os.path.join(d.config.work_home, "logs"))


def test_the_stand_in_scheduler_answers_host_announcements_as_jax(
        run_async, tmp_path):
    """``chip_smoke.StandInScheduler``'s AnnounceHost and LeaveHost hold
    to the JAX scheduler's answers (the same keys, ``ok`` alike, a
    positive ``sched_wall``), and a port daemon registers with it and
    leaves it as it does with the JAX scheduler."""
    import chip_smoke
    from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
    from dragonfly2_tpu_torch.rpc import Client as PClient

    async def answers(port: int) -> list:
        cli = PClient(NetAddr.tcp("127.0.0.1", port))
        body = {"id": "h-1", "hostname": "h", "ip": "127.0.0.1", "port": 1,
                "upload_port": 2, "type": 0, "idc": "", "location": "",
                "tpu_slice": "", "tpu_worker_index": -1,
                "telemetry": {"cpu_percent": 1.0}}
        out = []
        try:
            for method, b in (("Scheduler.AnnounceHost", body),
                              ("Scheduler.AnnounceHost",
                               {**body, "clock": {"t0": 1.0, "t1": 2.0,
                                                  "echo": 1.5}}),
                              ("Scheduler.LeaveHost", {"id": "h-1"}),
                              ("Scheduler.LeaveHost", {"id": "h-1"})):
                resp = await cli.call(method, b, timeout=10)
                out.append({k: (v > 0 if k == "sched_wall" else v)
                            for k, v in resp.items()})
            try:
                await cli.call("Scheduler.AnnounceHost", {"hostname": "x"},
                               timeout=10)
            except Exception as e:
                out.append(int(e.code))
        finally:
            await cli.close()
        return out

    async def run():
        sched = await start_scheduler()
        stand = chip_smoke.StandInScheduler(chip_smoke._NoParent(),
                                            chip_smoke.host_record("s"))
        addr = await stand.serve()
        try:
            assert await answers(int(addr.rsplit(":", 1)[1])) == \
                await answers(sched.port())
            sc = SchedulerClient([addr])
            resp = await sc.announce_host({"id": "x"})
            assert set(resp) == {"ok", "sched_wall"}
            await sc.close()
            d = _port_daemon(_config(tmp_path, "s", scheduler=int(
                addr.rsplit(":", 1)[1])))
            await d.start()
            wire = d.announcer.host_wire()
            await d.stop()
            assert stand.hosts == {"x": {"id": "x"}}
            assert [a["id"] for a in stand.announces[-2:]] == [wire["id"]] * 2
            assert stand.announces[-2].keys() == wire.keys()
            assert set(stand.announces[-1]) == set(wire) | {"clock"}
            assert stand.left[-1] == wire["id"]
        finally:
            await stand.server.close()
            await sched.stop()

    run_async(run(), timeout=60)
