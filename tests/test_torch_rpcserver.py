"""The port's daemon drpc servers against the JAX package's, and the
persistent import against the JAX scheduler.

The JAX drpc ``Client`` calls the port's ``DaemonRpcServer`` and the JAX
one with the same bodies, each server over its own task manager (no
scheduler) and one aiohttp origin, and gets the same frames (all but the
random peer ids) and the same error codes:

- the download service: ``Daemon.Download`` (a file, a device request
  without ``output``, a bad range, a missing output, a body of the wrong
  shape), ``Daemon.StatTask``, ``Daemon.ImportTask``,
  ``Daemon.ExportTask`` (a local cache task, and a missing one that is
  never fetched from an origin), ``Daemon.DeleteTask`` (running, pinned,
  done) and ``Daemon.Health``;
- the peer service: ``Peer.TriggerDownloadTask`` (the ACK, the
  seeded store; a completed task's ``already_complete``; a bad range and
  a missing url refused before the ACK), ``Peer.StatTask``,
  ``Peer.DeleteTask`` and ``Daemon.Health``; and the trigger as the JAX
  scheduler's seed client sends it.

The persistent import runs the port's task manager with the port's
``SchedulerClient`` against the JAX ``SchedulerServer`` over drpc: the
scheduler records the persistent cache task with its ``replica_count``,
as for the JAX task manager's import; a failed import sends ``...Failed``
and the scheduler drops the task.

Content is made with numpy from a seed; tolerance 0.
"""

from __future__ import annotations

import asyncio
import hashlib
import types

import numpy as np
import pytest

from dragonfly2_tpu.daemon.peer.device_sink import (
    DeviceSinkManager as JSinks,
)
from dragonfly2_tpu.daemon.peer.piece_manager import PieceManager as JPM
from dragonfly2_tpu.daemon.peer.piece_manager import (
    PieceManagerOption as JPMOption,
)
from dragonfly2_tpu.daemon.peer.task_manager import (
    FileTaskRequest as JRequest,
)
from dragonfly2_tpu.daemon.peer.task_manager import TaskManager as JTM
from dragonfly2_tpu.daemon.rpcserver import DaemonRpcServer as JServer
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu_torch.daemon.peer.device_sink import (
    DeviceSinkManager as PSinks,
)
from dragonfly2_tpu_torch.daemon.peer.piece_manager import PieceManager as PPM
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManagerOption as PPMOption,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    FileTaskRequest as PRequest,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager as PTM
from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer
from dragonfly2_tpu_torch.proto.common import UrlMeta as PMeta
from dragonfly2_tpu_torch.storage import StorageManager as PSM
from dragonfly2_tpu_torch.storage import StorageOption as PSMOption
from tests.test_torch_task_manager import start_origin

MB = 1 << 20
CONTENT = np.random.default_rng(43).integers(
    0, 256, 5 * MB + 77, np.uint8).tobytes()
SHA = "sha256:" + hashlib.sha256(CONTENT).hexdigest()


class _Side:
    """One package's task manager and server, served on TCP, and a JAX
    drpc client to each service."""

    def __init__(self, tmp_path, jax: bool):
        self.jax = jax
        root = str(tmp_path / ("jax" if jax else "port"))
        if jax:
            self.tm = JTM(JSM(JSMOption(data_dir=root)),
                          JPM(JPMOption(concurrency=1)),
                          device_sinks=JSinks())
            self.server = JServer(self.tm)
        else:
            self.tm = PTM(PSM(PSMOption(data_dir=root)),
                          PPM(PPMOption(concurrency=1)),
                          device_sinks=PSinks(device="cpu"))
            self.server = DaemonRpcServer(self.tm, device="cpu")
        self.out = tmp_path / ("out-jax" if jax else "out-port")

    async def start(self) -> "_Side":
        await self.server.serve_download(JNetAddr.tcp("127.0.0.1", 0))
        await self.server.serve_peer(JNetAddr.tcp("127.0.0.1", 0))
        self.download = JClient(JNetAddr.tcp(
            "127.0.0.1", self.server.download_server.port()))
        self.peer = JClient(JNetAddr.tcp(
            "127.0.0.1", self.server.peer_server.port()))
        return self

    async def close(self) -> None:
        await self.download.close()
        await self.peer.close()
        await self.server.close()

    def request(self, url: str, **meta):
        cls, m = (JRequest, JMeta) if self.jax else (PRequest, PMeta)
        return cls(url=url, output="", meta=m(**meta))

    async def fetch(self, url: str, **meta) -> str:
        req = self.request(url, **meta)
        last = [p async for p in self.tm.start_file_task(req)][-1]
        assert last.state == "done"
        return last.task_id


def _scrub(value):
    """A frame without its random peer id."""
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k != "peer_id"}
    return value


async def _unary(cli, method: str, body) -> tuple:
    try:
        return ("ok", _scrub(await cli.call(method, body, timeout=30)))
    except JDfError as e:
        return ("error", int(e.code))


async def _stream(cli, method: str, body) -> tuple:
    frames = []
    try:
        stream = await cli.open_stream(method, body)
        while (msg := await stream.recv(timeout=30)) is not None:
            frames.append(_scrub(msg))
    except JDfError as e:
        return ("error", int(e.code), frames[-1:] if frames else [])
    return ("ok", frames[-1] if frames else None, len(frames) > 0)


async def _on_both(tmp_path, script):
    """``script(side, url)`` on the JAX side, then on the port's, against
    one origin; returns (jax_result, port_result, requests by side)."""
    runner, base, stats = await start_origin(CONTENT)
    out, reqs = [], []
    try:
        for jax in (True, False):
            side = await _Side(tmp_path, jax).start()
            stats.clear()
            try:
                out.append(await script(side, base + "/blob"))
            finally:
                await side.close()
            reqs.append(dict(stats))
    finally:
        await runner.cleanup()
    return out[0], out[1], reqs


# --------------------------------------------------------------------- #
# The download service
# --------------------------------------------------------------------- #

def _download_cases(side, url) -> dict:
    out = str(side.out)
    return {
        "file": {"url": url, "output": out + ".file"},
        "file-digest": {"url": url, "output": out + ".digest",
                        "meta": {"digest": SHA}},
        "device-no-output": {"url": url, "device": "tpu"},
        "ranged": {"url": url, "output": out + ".ranged",
                   "meta": {"range": "100-199"}},
        "bad-range": {"url": url, "output": out + ".bad",
                      "meta": {"range": "bytes=9-3"}},
        "no-output": {"url": url},
        "wrong-shape": {"url": url, "output": 7},
        "delta-base-not-landed": {"url": url, "output": out + ".delta",
                                  "delta_base": "0" * 64},
    }


@pytest.mark.parametrize("case", ["file", "file-digest", "device-no-output",
                                  "ranged", "bad-range", "no-output",
                                  "wrong-shape", "delta-base-not-landed"])
def test_download_answers_as_the_jax_server(run_async, tmp_path, case):
    async def script(side, url):
        body = _download_cases(side, url)[case]
        res = await _stream(side.download, "Daemon.Download", body)
        written = None
        if isinstance(body.get("output"), str):
            try:
                with open(body["output"], "rb") as f:
                    written = hashlib.sha256(f.read()).hexdigest()
            except FileNotFoundError:
                pass
        return res, written

    (jres, jout), (pres, pout), (jreq, preq) = run_async(
        _on_both(tmp_path, script))
    assert pres == jres and pout == jout and preq == jreq
    if case in ("bad-range", "no-output", "wrong-shape"):
        assert pres[:2] == ("error", 400) and preq == {}
        return
    assert pres[0] == "ok" and pres[1]["state"] == "done"
    if case == "ranged":
        assert pout == hashlib.sha256(CONTENT[100:200]).hexdigest()
    elif case == "device-no-output":
        assert pres[1]["device_verified"]
    else:
        assert pout == SHA[7:]


def test_stat_import_export_delete_and_health(run_async, tmp_path):
    """Each unary method, and the export stream, with the same bodies on
    both servers: the same answers and error codes, step by step."""
    src = tmp_path / "cached.bin"
    src.write_bytes(CONTENT[:MB + 5])

    async def script(side, url):
        got = []
        dl = side.download
        tid = await side.fetch(url)
        for cli in (side.download, side.peer):
            got.append(await _unary(cli, "Daemon.Health", {}))
        for method in ("Daemon.StatTask", "Peer.StatTask"):
            cli = dl if method.startswith("Daemon") else side.peer
            got.append(await _unary(cli, method, {"task_id": tid}))
            got.append(await _unary(cli, method, {"task_id": "f" * 64}))
            got.append(await _unary(cli, method, {}))
        imp = {"path": str(src), "cache_id": "entry-1", "tag": "t"}
        got.append(await _unary(dl, "Daemon.ImportTask", imp))
        got.append(await _unary(dl, "Daemon.ImportTask", imp))
        got.append(await _unary(dl, "Daemon.ImportTask",
                                {"path": "", "cache_id": "x"}))
        got.append(await _unary(dl, "Daemon.ImportTask",
                                {"path": str(src)}))
        got.append(await _unary(dl, "Daemon.ImportTask",
                                {"path": str(tmp_path / "missing"),
                                 "cache_id": "entry-2"}))
        out = str(side.out) + ".export"
        got.append(await _stream(dl, "Daemon.ExportTask",
                                 {"cache_id": "entry-1", "tag": "t",
                                  "output": out}))
        with open(out, "rb") as f:
            got.append(f.read() == CONTENT[:MB + 5])
        # Not here and no scheduler: never the origin, a coded failure.
        got.append(await _stream(dl, "Daemon.ExportTask",
                                 {"cache_id": "absent", "output": out + "2"}))
        got.append(await _stream(dl, "Daemon.ExportTask", {"cache_id": "x"}))
        # DeleteTask: pinned, running, then done; on both services.
        store = side.tm.storage.try_get(tid)
        store.pin()
        got.append(await _unary(dl, "Daemon.DeleteTask", {"task_id": tid}))
        store.unpin()
        side.tm._running[tid] = object()
        got.append(await _unary(side.peer, "Peer.DeleteTask",
                                {"task_id": tid}))
        side.tm._running.pop(tid)
        got.append(await _unary(side.peer, "Peer.DeleteTask",
                                {"task_id": tid}))
        got.append(side.tm.storage.try_get(tid) is None)
        got.append(await _unary(dl, "Daemon.DeleteTask",
                                {"task_id": "f" * 64}))
        got.append(await _unary(dl, "Daemon.DeleteTask", {}))
        return got

    j, p, (jreq, preq) = run_async(_on_both(tmp_path, script))
    assert p == j and preq == jreq
    assert p[0] == p[1] == ("ok", {"ok": True, "version": "0.1.0"})
    assert p[2][0] == "ok" and p[2][1]["done"]
    assert p[3] == p[6] == ("error", 404) and p[4] == ("error", 400)
    assert p[8][0] == "ok" and p[9] == p[8]
    assert p[10] == p[11] == ("error", 400) and p[12][0] == "error"
    assert p[13][0] == "ok" and p[14] is True
    # The absent cache task: a failed frame, the origin never asked.
    assert p[15][1]["state"] == "failed" and p[15][1]["error"]["code"] == (
        4008) and p[16][:2] == ("error", 400)
    assert p[17] == ("ok", {"ok": False, "reason": "task store in use"})
    assert p[18] == ("ok", {"ok": False, "reason": "task running"})
    assert p[19] == ("ok", {"ok": True}) and p[20] is True
    assert p[21] == ("ok", {"ok": True}) and p[22] == ("error", 400)


# --------------------------------------------------------------------- #
# The peer service: a scheduler's seed trigger
# --------------------------------------------------------------------- #

async def _until_done(tm, task_id: str) -> None:
    for _ in range(2000):
        store = tm.storage.find_completed_task(task_id)
        if store is not None and not tm.is_task_running(task_id):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the seed task did not finish")


def test_trigger_download_task_answers_as_the_jax_server(run_async,
                                                         tmp_path):
    """The ACK, the seeded store (a device trigger lands the sink too), a
    second trigger's ``already_complete``, a ranged ``seed: False``
    trigger, and the refusals before the ACK are the JAX server's."""
    async def script(side, url):
        tid = side.request(url).task_id()
        got = []
        spec = {"url": url, "task_id": tid, "device": "tpu", "seed": True}
        got.append(await _unary(side.peer, "Peer.TriggerDownloadTask", spec))
        await _until_done(side.tm, tid)
        for _ in range(200):
            if side.tm.device_sinks.get(tid) is not None:
                break
            await asyncio.sleep(0.005)
        sink = side.tm.device_sinks.get(tid)
        got.append(np.asarray(sink.as_bytes_array()).tobytes() == CONTENT)
        store = side.tm.storage.try_get(tid)
        got.append((store.metadata.done, store.metadata.peer_id
                    .endswith("_Seed"), len(store.metadata.pieces)))
        got.append(await _unary(side.peer, "Peer.TriggerDownloadTask",
                                {"url": url, "task_id": tid}))
        await asyncio.sleep(0.05)
        await _until_done(side.tm, tid)
        got.append(await _unary(side.peer, "Peer.TriggerDownloadTask",
                                {"url": url, "range": "9-3"}))
        got.append(await _unary(side.peer, "Peer.TriggerDownloadTask",
                                {"task_id": tid}))
        got.append(await _unary(side.peer, "Peer.TriggerDownloadTask",
                                {"url": url, "range": "0-99",
                                 "seed": False}))
        ranged = side.request(url, range="bytes=0-99").task_id()
        await _until_done(side.tm, ranged)
        r = side.tm.storage.try_get(ranged).metadata
        got.append((r.content_length, r.peer_id.endswith("_Seed")))
        return got

    j, p, (jreq, preq) = run_async(_on_both(tmp_path, script))
    assert p == j and preq == jreq
    assert p[0] == ("ok", {"ok": True, "already_complete": False})
    assert p[1] and p[2][:2] == (True, True)
    assert p[3] == ("ok", {"ok": True, "already_complete": True})
    assert p[4] == ("error", 400) and p[5] == ("error", 400)
    assert p[7] == (100, False)


def test_the_jax_scheduler_seed_client_triggers_a_port_daemon(run_async,
                                                              tmp_path):
    """``SeedPeerClientPool.trigger_download_task``, the JAX scheduler's
    own caller, seeds the port's daemon; its stat and delete calls answer
    as they do against a JAX daemon."""
    from dragonfly2_tpu.scheduler.seed_client import SeedPeerClientPool

    async def script(side, url):
        pool = SeedPeerClientPool()
        host = types.SimpleNamespace(id="h", ip="127.0.0.1",
                                     port=side.server.peer_server.port())
        tid = side.request(url).task_id()
        try:
            ok = await pool.trigger_download_task(
                host, {"url": url, "task_id": tid})
            await _until_done(side.tm, tid)
            stat = _scrub(await pool.stat_task(host, tid))
            store = side.tm.storage.try_get(tid)
            with open(store.data_path, "rb") as f:
                data = hashlib.sha256(f.read()).hexdigest()
            deleted = await pool.delete_task(host, tid)
            return [ok, stat, data, deleted,
                    side.tm.storage.try_get(tid) is None]
        finally:
            await pool.close()

    j, p, (jreq, preq) = run_async(_on_both(tmp_path, script))
    assert p == j and preq == jreq
    assert p[0] is True and p[2] == SHA[7:] and p[3] is True and p[4]
    assert p[1]["done"] and p[1]["content_length"] == len(CONTENT)


# --------------------------------------------------------------------- #
# The persistent import against the JAX scheduler
# --------------------------------------------------------------------- #

def test_persistent_import_is_recorded_by_the_jax_scheduler(run_async,
                                                            tmp_path):
    """The port's task manager (with the port's ``SchedulerClient``) and
    the JAX one import the same file as a persistent cache task: the JAX
    scheduler records each with its replica count and the uploader's
    host, the same record; a failed import sends ``...Failed`` and the
    scheduler drops the task it had started."""
    from dragonfly2_tpu.daemon.schedulerclient import (
        SchedulerClient as JSchedulerClient,
    )
    from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
    from tests.test_persistent_cache import _sched_config
    from dragonfly2_tpu.scheduler.server import SchedulerServer

    src = tmp_path / "entry.bin"
    src.write_bytes(CONTENT[:2 * MB + 3])

    async def body():
        sched = SchedulerServer(_sched_config(tmp_path))
        await sched.start()
        addr = f"127.0.0.1:{sched.port()}"
        records = []
        try:
            for jax in (True, False):
                name = "jax" if jax else "port"
                host = {"id": f"{name}-host", "hostname": name,
                        "ip": "127.0.0.1", "port": 1, "upload_port": 2,
                        "telemetry": {"x": 1}}
                sc = JSchedulerClient([addr]) if jax else \
                    SchedulerClient([addr])
                root = str(tmp_path / name)
                tm = (JTM(JSM(JSMOption(data_dir=root)), JPM(JPMOption()),
                          scheduler_client=sc, host_wire=lambda: dict(host))
                      if jax else
                      PTM(PSM(PSMOption(data_dir=root)), PPM(PPMOption()),
                          scheduler_client=sc, host_wire=lambda: dict(host)))
                cls, meta = ((JRequest, JMeta) if jax else (PRequest, PMeta))
                req = cls(url=f"dfcache://{name}-entry", output="",
                          meta=meta(tag="pc"))
                try:
                    res = await tm.import_task(str(src), req, persistent=True,
                                               replica_count=3, ttl=60.0)
                    wire = dict(sched.service.persistent.task_wire(
                        res["task_id"]))
                    bad = cls(url=f"dfcache://{name}-bad", output="",
                              meta=meta(tag="pc"))
                    try:
                        await tm.import_task(str(tmp_path / "missing"), bad,
                                             persistent=True)
                    except Exception as e:      # noqa: BLE001 - compared
                        raised = type(e).__name__
                    else:
                        raised = None
                    failed = sched.service.persistent.get_task(bad.task_id())
                    started = sched.service.persistent.get_host(
                        f"{name}-host")
                finally:
                    await sc.close()
                for key in ("task_id", "url", "created_at", "updated_at"):
                    wire.pop(key, None)
                wire["peers"] = [(q["state"], q["persistent"])
                                 for q in wire["peers"]]
                res.pop("task_id")
                res.pop("peer_id")
                records.append((res, wire, failed, started is not None,
                                raised))
        finally:
            await sched.stop()
        return records

    j, p = run_async(body(), timeout=90)
    assert p == j
    res, wire, failed, started, raised = p
    assert wire["replica_count"] == 3 and wire["state"] == "succeeded"
    assert res["content_length"] == 2 * MB + 3
    assert failed is None and started and raised is not None


# --------------------------------------------------------------------- #
# The flight recorder's two methods, and DeleteTask's PEX removal
# --------------------------------------------------------------------- #

def test_flight_report_and_pod_timeline_answer_as_the_jax_server(
        run_async, tmp_path, monkeypatch):
    """``Daemon.FlightReport`` on both services returns the same report,
    text and digest for the same recorded events (each package's flight
    module on one injected clock, each server's task manager with a
    recorder of its own), and the same error codes for an unknown task and
    a body without ``task_id``; ``Daemon.PodTimeline`` with no scheduler
    fails with the same code; ``DeleteTask`` drops a deleted task from the
    daemon's PEX possession list."""
    from dragonfly2_tpu.pkg import flight as jflight
    from dragonfly2_tpu_torch.pkg import flight as pflight

    now = [500.0]
    for mod in (jflight, pflight):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: now[0], time=lambda: 1.7e9))
        monkeypatch.setattr(mod, "_WALL_ANCHOR", 1.7e9)
        monkeypatch.setattr(mod, "_PC_ANCHOR", 400.0)
    rng = np.random.RandomState(5)
    script_events = []
    for n in range(12):
        script_events += [(float(rng.uniform(0, 0.1)), "EV_REQUEST", n,
                           0.0, "10.0.0.1:65002"),
                          (float(rng.uniform(0, 0.3)), "EV_FIRST_BYTE", n,
                           0.0, ""),
                          (0.01, "EV_LANDED", n, float(rng.randint(90)),
                           "unlabeled"),
                          (0.002, "EV_HBM_START", n, 0.0, ""),
                          (0.003, "EV_HBM_LANDED", n, 0.0, "")]

    class Pex:
        def __init__(self):
            self.removed = []

        def find_holders(self, task_id):
            return []

        def add_task(self, task_id):
            pass

        def remove_task(self, task_id):
            self.removed.append(task_id)

    async def script(side, url):
        mod = jflight if side.jax else pflight
        side.tm.flight = mod.FlightRecorder()
        side.tm.pex = Pex()
        now[0] = 500.0
        tf = side.tm.flight.task("t-flight")
        tf.record(mod.EV_REGISTER)
        for step, name, piece, aux, note in script_events:
            now[0] += step
            tf.record(getattr(mod, name), piece, aux, note)
        side.tm.flight.finish_task("t-flight", "done")
        now[0] += 1.0
        got = []
        for cli in (side.download, side.peer):
            got.append(await _unary(cli, "Daemon.FlightReport",
                                    {"task_id": "t-flight"}))
            got.append(await _unary(cli, "Daemon.FlightReport",
                                    {"task_id": "absent"}))
            got.append(await _unary(cli, "Daemon.FlightReport", {}))
        got.append(await _unary(side.download, "Daemon.PodTimeline",
                                {"task_id": "t-flight"}))
        got.append(await _unary(side.download, "Daemon.PodTimeline", {}))
        tid = await side.fetch(url)
        got.append(await _unary(side.download, "Daemon.DeleteTask",
                                {"task_id": tid}))
        got.append(side.tm.pex.removed == [tid])
        return got

    j, p, _ = run_async(_on_both(tmp_path, script))
    assert p == j
    assert p[0][0] == "ok" and p[0] == p[3]
    assert set(p[0][1]) == {"report", "text", "digest"}
    assert p[0][1]["report"]["state"] == "done"
    assert len(p[0][1]["report"]["pieces"]) == 12
    assert p[1] == p[4] == ("error", 404)
    assert p[2] == p[5] == ("error", 400)
    assert p[6][0] == "error" and p[7] == ("error", 400)
    assert p[8] == ("ok", {"ok": True}) and p[9] is True
