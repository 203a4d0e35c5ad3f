"""Rules the PyTorch port keeps, and its small own copies.

- The port, its tools (``tools/``) and ``chip_smoke.py`` import neither
  JAX nor the JAX package
  (checked in a subprocess, since ``tests/conftest.py`` imports jax into
  every test process, and by an AST scan of the sources); nor does a
  rank process of ``dryrun_multichip``. The example twins import no JAX.
  The dataset plane and the object-gateway client import without
  ``aiohttp`` (the card machine has none).
- Every thread the port or ``chip_smoke.py`` starts carries a ``df-``
  name (the profiler attributes by thread name).
- Its entry points run on the card unless told ``device="cpu"``: without
  CUDA they raise instead of quietly using the CPU.
- The kernels build with nvcc or raise with nvcc's output; nothing falls
  back to the plain versions.
- Its copies of the piece math and the metric registry (counters and
  gauges) agree with the JAX package's. Tolerance 0: these are integers.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from dragonfly2_tpu.pkg import piece as jax_piece
from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.client.device import (
    local_base_manifest,
    swap_generation,
)
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager
from dragonfly2_tpu_torch.dataset.device_feed import DeviceFeed
from dragonfly2_tpu_torch.delta import (
    GearChunker,
    build_manifest,
    chunk_bytes,
    manifest_from_store,
)
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink, assemble_delta_u8
from dragonfly2_tpu_torch.parallel.ici import make_mesh
from dragonfly2_tpu_torch.parallel.multihost import global_mesh
from dragonfly2_tpu_torch.pkg import metrics, piece

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dragonfly2_tpu_torch")
TOOLS = os.path.join(REPO, "tools")     # the port's tools outside the package


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PKG, TOOLS):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "dragonfly2_tpu" or name.startswith("dragonfly2_tpu."))


def test_importing_the_port_loads_no_jax():
    modules = [_module_name(p) for p in _port_sources()]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "chip_smoke" in loaded and "dragonfly2_tpu_torch.ops.checksum" in loaded
    assert {"dragonfly2_tpu_torch.parallel",
            "dragonfly2_tpu_torch.parallel.ici",
            "dragonfly2_tpu_torch.parallel.multihost",
            "dragonfly2_tpu_torch.parallel.topology",
            "dragonfly2_tpu_torch.entry",
            "dragonfly2_tpu_torch.bench"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_dataset_plane_imports_without_aiohttp():
    code = ("import json, sys\n"
            "sys.modules['aiohttp'] = None\n"
            "import dragonfly2_tpu_torch.dataset\n"
            "import dragonfly2_tpu_torch.client.dfstore\n"
            "import dragonfly2_tpu_torch.delta.manifest\n"
            "from dragonfly2_tpu_torch.dataset import PodShardedLoader\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.dataset.loader",
            "dragonfly2_tpu_torch.dataset.shard_reader",
            "dragonfly2_tpu_torch.dataset.tar_index",
            "dragonfly2_tpu_torch.client.dfstore"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.startswith("aiohttp")] \
        == []


def test_the_daemon_piece_path_imports_without_aiohttp():
    code = ("import json, sys\n"
            "sys.modules['aiohttp'] = None\n"
            "import dragonfly2_tpu_torch.storage\n"
            "import dragonfly2_tpu_torch.source\n"
            "from dragonfly2_tpu_torch.source import get_client\n"
            "get_client('http://o/x'); get_client('file:///x')\n"
            "import dragonfly2_tpu_torch.daemon.peer.task_manager\n"
            "import dragonfly2_tpu_torch.daemon.peer.traffic_shaper\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.storage.local_store",
            "dragonfly2_tpu_torch.storage.io_ring",
            "dragonfly2_tpu_torch.source.clients.http",
            "dragonfly2_tpu_torch.source.clients.file",
            "dragonfly2_tpu_torch.daemon.peer.piece_manager",
            "dragonfly2_tpu_torch.daemon.peer.broker",
            "dragonfly2_tpu_torch.daemon.peer.traffic_shaper",
            "dragonfly2_tpu_torch.pkg.dfhost"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.startswith("aiohttp")] \
        == []


def test_the_task_kinds_import_without_msgpack_or_aiohttp():
    """The delta engine, the seed and stream tasks, the download service
    and what they import on first use (the range fetcher, the manifest
    builders) import with neither ``msgpack`` nor ``aiohttp`` importable,
    and none of JAX or the JAX package."""
    code = ("import json, sys\n"
            "sys.modules['aiohttp'] = None\n"
            "sys.modules['msgpack'] = None\n"
            "from dragonfly2_tpu_torch.daemon.peer.task_manager import (\n"
            "    StreamTaskRequest, TaskManager)\n"
            "from dragonfly2_tpu_torch.delta.resolver import run_delta_task\n"
            "from dragonfly2_tpu_torch.daemon.rpcserver import "
            "DaemonRpcServer\n"
            "import dragonfly2_tpu_torch.dataset.shard_reader\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.delta.resolver",
            "dragonfly2_tpu_torch.delta.manifest",
            "dragonfly2_tpu_torch.daemon.rpcserver",
            "dragonfly2_tpu_torch.proto.wire",
            "dragonfly2_tpu_torch.dataset.shard_reader"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.startswith(
        ("aiohttp", "msgpack"))] == []


def test_the_p2p_half_imports_without_msgpack_or_aiohttp():
    """The drpc layer, the scheduler client, the conductor and its parts,
    the upload server and the peer drpc server import, and a frame packs
    and unpacks, with neither ``msgpack`` nor ``aiohttp`` importable (the
    card machine has neither)."""
    code = ("import json, sys\n"
            "sys.modules['aiohttp'] = None\n"
            "sys.modules['msgpack'] = None\n"
            "import dragonfly2_tpu_torch.rpc\n"
            "import dragonfly2_tpu_torch.daemon.schedulerclient\n"
            "import dragonfly2_tpu_torch.daemon.peer.conductor\n"
            "import dragonfly2_tpu_torch.daemon.upload\n"
            "import dragonfly2_tpu_torch.daemon.rpcserver\n"
            "from dragonfly2_tpu_torch.rpc.framing import Frame\n"
            "f = Frame(4, 1, body={'pieces': [1, 2], 'digests': {1: 'x'}})\n"
            "assert Frame.unpack(f.pack()[4:]) == f\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.rpc.codec",
            "dragonfly2_tpu_torch.rpc.client",
            "dragonfly2_tpu_torch.rpc.server",
            "dragonfly2_tpu_torch.daemon.peer.piece_dispatcher",
            "dragonfly2_tpu_torch.daemon.peer.piece_downloader",
            "dragonfly2_tpu_torch.daemon.peer.synchronizer"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.startswith(
        ("aiohttp", "msgpack"))] == []


def test_the_daemon_imports_none_of_jax_aiohttp_msgpack_yaml_psutil():
    """The daemon and its new services (config, announcer, transport, the
    object gateway and its ``fs`` backend, ``/metrics``) import none of
    the JAX side, ``aiohttp`` or ``msgpack`` (the card machine has
    neither), nor ``yaml`` or ``psutil`` (not known to be there: the
    config reads YAML through a lazy import, the announcer's telemetry
    comes from the standard library); and with none of the last four
    importable a daemon still builds, starts with its gateway and stops."""
    code = ("import asyncio, json, sys, tempfile\n"
            "import dragonfly2_tpu_torch.daemon.daemon\n"
            "import dragonfly2_tpu_torch.daemon.objectstorage\n"
            "import dragonfly2_tpu_torch.pkg.metrics_server\n"
            "import dragonfly2_tpu_torch.pkg.objectstorage.fs\n"
            "loaded = sorted(sys.modules)\n"
            "for m in ('aiohttp', 'msgpack', 'yaml', 'psutil'):\n"
            "    sys.modules[m] = None\n"
            "from dragonfly2_tpu_torch.daemon.config import DaemonConfig\n"
            "from dragonfly2_tpu_torch.daemon.daemon import Daemon\n"
            "home = tempfile.mkdtemp()\n"
            "cfg = DaemonConfig.from_dict({'work_home': home, 'host': {\n"
            "    'hostname': 'h', 'ip': '127.0.0.1'}, 'metrics_port': 0,\n"
            "    'object_storage': {'enabled': True, 'backend_options': {\n"
            "        'root': home + '/b'}}, 'tpu_sink': {'enabled': True}})\n"
            "async def main():\n"
            "    d = Daemon(cfg, device='cpu')\n"
            "    await d.start()\n"
            "    await d.stop()\n"
            "asyncio.run(main())\n"
            "print(json.dumps(loaded))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.daemon.announcer",
            "dragonfly2_tpu_torch.daemon.config",
            "dragonfly2_tpu_torch.daemon.transport",
            "dragonfly2_tpu_torch.pkg.httpserver"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.split(".")[0] in (
        "aiohttp", "msgpack", "yaml", "psutil")] == []


def _top_level_imports(tree: ast.Module) -> list[str]:
    """Modules imported where a module's import runs them: its body and
    the ``if``/``try``/``with`` blocks in it, not functions or classes."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo += getattr(node, field, [])
        elif isinstance(node, ast.ExceptHandler):
            todo += node.body
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_yaml_or_psutil_at_module_level(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert [n for n in _top_level_imports(tree)
            if n.split(".")[0] in ("yaml", "psutil")] == []


def test_the_daemons_http_servers_name_their_threads(run_async, tmp_path):
    """The upload server's, the gateway's and ``/metrics``' accept and
    connection threads carry ``df-`` names, and none is left after their
    close."""
    import asyncio
    import http.client

    from dragonfly2_tpu_torch.daemon.objectstorage import ObjectStorageService
    from dragonfly2_tpu_torch.daemon.upload import UploadManager
    from dragonfly2_tpu_torch.pkg.metrics_server import MetricsServer
    from dragonfly2_tpu_torch.pkg.objectstorage.fs import FSObjectStorage

    def get(port: int, path: str) -> set:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", path)
        c.getresponse().read()
        names = {t.name for t in threading.enumerate()}
        c.close()
        return names

    async def run():
        gw = ObjectStorageService(FSObjectStorage(str(tmp_path)), None)
        ms = MetricsServer()
        up = UploadManager(None)
        gport = await gw.serve("127.0.0.1", 0)
        mport = await ms.serve("127.0.0.1", 0)
        uport = up.serve("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        try:
            names = await loop.run_in_executor(None, get, gport, "/healthy")
            names |= await loop.run_in_executor(None, get, mport, "/metrics")
            names |= await loop.run_in_executor(None, get, uport, "/healthy")
        finally:
            await gw.close()
            await ms.close()
            await loop.run_in_executor(None, up.close)
        servers = {f"df-{n}{s}" for n in ("gateway", "metrics", "upload")
                   for s in ("", "-accept")}
        assert servers <= names
        left = {t.name for t in threading.enumerate()}
        assert not left & servers

    run_async(run())


def test_the_intended_divergences_of_the_daemon(run_async, tmp_path):
    """What the daemon slice leaves out, pinned: the gateway adopts no
    ``traceparent`` (no tracing in the port); ``/metrics`` has no
    ``/debug`` routes; ``prof.enabled`` (the default) installs no runtime
    observatory; ``fs`` is the only object-storage backend; the
    announcer's telemetry is the JAX keys from the standard library; the
    transport has no proxy half (rules, default tag, ``should_use_p2p``)
    until the proxy is ported, and the GC runner no ``run`` that nothing
    calls."""
    import asyncio
    import http.client
    import inspect

    from dragonfly2_tpu.daemon import announcer as jannouncer
    from dragonfly2_tpu.daemon import objectstorage as jgateway
    from dragonfly2_tpu.daemon import transport as jtransport
    from dragonfly2_tpu.pkg import cache as jcache
    from dragonfly2_tpu.pkg import metrics_server as jms
    from dragonfly2_tpu_torch.daemon import announcer as pannouncer
    from dragonfly2_tpu_torch.daemon import objectstorage as pgateway
    from dragonfly2_tpu_torch.daemon import transport as ptransport
    from dragonfly2_tpu_torch.pkg import cache as pcache
    from dragonfly2_tpu_torch.daemon.config import DaemonConfig
    from dragonfly2_tpu_torch.daemon.daemon import Daemon
    from dragonfly2_tpu_torch.pkg import metrics_server as pms
    from dragonfly2_tpu_torch.pkg.objectstorage import NOT_PORTED

    assert hasattr(jgateway, "tracing") and not hasattr(pgateway, "tracing")
    with open(pgateway.__file__) as f:
        assert "tracing." not in f.read()
    assert jms.MetricsServer.debug_routes()
    assert pms.MetricsServer.ROUTES == ("/metrics", "/healthy")
    assert not hasattr(pms.MetricsServer, "debug_routes")
    assert NOT_PORTED == ("s3", "gcs", "oss", "obs")
    import importlib.util
    for name in NOT_PORTED:
        # The JAX package has each of these backends; the port none.
        assert importlib.util.find_spec(
            f"dragonfly2_tpu.pkg.objectstorage.{name}") is not None
        assert importlib.util.find_spec(
            f"dragonfly2_tpu_torch.pkg.objectstorage.{name}") is None
    assert hasattr(jannouncer, "psutil") and not hasattr(pannouncer,
                                                         "psutil")
    for name in ("ProxyRule", "rules_from_config", "HDR_NO_P2P"):
        assert hasattr(jtransport, name) and not hasattr(ptransport, name)
    assert hasattr(jtransport.P2PTransport, "should_use_p2p")
    assert not hasattr(ptransport.P2PTransport, "should_use_p2p")
    assert set(inspect.signature(jtransport.P2PTransport).parameters) - set(
        inspect.signature(ptransport.P2PTransport).parameters) == {
        "rules", "default_tag"}
    assert hasattr(jcache.GC, "run") and not hasattr(pcache.GC, "run")

    def get(port: int, path: str) -> int:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request("GET", path, headers={
                "traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"})
            r = c.getresponse()
            r.read()
            return r.status, r.getheader("traceparent")
        finally:
            c.close()

    async def run():
        cfg = DaemonConfig.from_dict({
            "work_home": str(tmp_path), "metrics_port": 0,
            "host": {"hostname": "h", "ip": "127.0.0.1"},
            "object_storage": {"enabled": True, "backend_options": {
                "root": str(tmp_path / "b")}}})
        assert cfg.prof.enabled
        d = Daemon(cfg, device="cpu")
        await d.start()
        loop = asyncio.get_running_loop()
        try:
            assert not hasattr(d, "prof_obs")
            assert d.task_manager.flight.runtime is None
            assert await loop.run_in_executor(
                None, get, d.metrics.port, "/debug/stacks") == (404, None)
            assert await loop.run_in_executor(
                None, get, d.object_storage.port, "/healthy") == (200, None)
        finally:
            await d.stop()
        jd = jannouncer.Announcer.host_wire.__code__.co_names
        assert "_telemetry" in jd
        keys = set(pannouncer.Announcer(cfg, None, peer_port=1,
                                        upload_port=2)._telemetry())
        assert keys == set(jannouncer.Announcer._telemetry()) == {
            "cpu_percent", "mem_percent", "disk_free"}

    run_async(run())


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_msgpack(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if n.split(".")[0] == "msgpack"] == []


def test_the_intended_divergences_of_the_p2p_half():
    """What the P2P half leaves out, pinned: no QoS gate in the conductor
    (its worker count and report batch come from the daemon's config, the
    old constants their defaults); no native piece fetch, no native upload server and no native
    report decoder (``report_backend()`` is ``"numpy"``); no TLS on the
    drpc client and server or the upload server; ``stamp_running`` kept
    with no caller. What it has as the JAX half does: the flight recorder
    and the parent quarantine in the conductor and the dispatcher, the
    packed report and bitmap forms once the scheduler negotiates them,
    and every method of the JAX daemon's two services. The seed flag
    reaches the conductor from the request, as in JAX."""
    import inspect

    from dragonfly2_tpu.daemon import upload as jupload
    from dragonfly2_tpu.daemon.peer import conductor as jcond
    from dragonfly2_tpu.daemon.peer import piece_dispatcher as jdisp
    from dragonfly2_tpu.daemon.peer import piece_downloader as jdl
    from dragonfly2_tpu.daemon.peer import synchronizer as jsync
    from dragonfly2_tpu.daemon.peer import task_manager as jtm
    from dragonfly2_tpu.proto import reportcodec as jcodec
    from dragonfly2_tpu.rpc import Client as JClient
    from dragonfly2_tpu.rpc import Server as JServer
    from dragonfly2_tpu_torch.daemon import upload as pupload
    from dragonfly2_tpu_torch.daemon.peer import conductor as pcond
    from dragonfly2_tpu_torch.daemon.peer import piece_dispatcher as pdisp
    from dragonfly2_tpu_torch.daemon.peer import piece_downloader as pdl
    from dragonfly2_tpu_torch.daemon.peer import synchronizer as psync
    from dragonfly2_tpu_torch.daemon.peer import task_manager as ptm
    from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer
    from dragonfly2_tpu_torch.pkg import flight as pflight
    from dragonfly2_tpu_torch.proto import reportcodec as pcodec
    from dragonfly2_tpu_torch.rpc import Client, Server

    def params(fn) -> set:
        return set(inspect.signature(fn).parameters)

    # The QoS gate comes from the daemon's config in JAX; the port has no
    # QoS plane, so there is no gate. The worker count and the report
    # batch come from the config in both, with the same defaults. The seed
    # flag comes from the request (a seed trigger) or the config in both,
    # and so do the flight and the quarantine (the task manager's).
    assert params(jcond.PeerTaskConductor) - params(pcond.PeerTaskConductor) \
        == {"wfq"}
    for name, default in (("piece_parallelism", 4), ("report_batch", 32)):
        assert inspect.signature(pcond.PeerTaskConductor).parameters[
            name].default == inspect.signature(
                jcond.PeerTaskConductor).parameters[name].default == default
    assert (pcond.PIECE_WORKERS, pcond.REPORT_BATCH) == (4, 32)
    assert {"is_seed", "quarantine", "flight"} <= params(
        pcond.PeerTaskConductor)
    # Nothing of the port sets a parent-death hook or reads the per-task
    # locality bytes (the daemon's stat surface).
    assert "on_parent_dead" in params(jsync.PieceTaskSynchronizer)
    assert "on_parent_dead" not in params(psync.PieceTaskSynchronizer)
    assert "is_seed" in params(jtm.TaskManager._run_download)
    assert "is_seed" in params(ptm.TaskManager._run_download)
    for module in (pcond, ptm):
        with open(module.__file__) as f:
            assert "locality_bytes" not in f.read()
    assert params(pcond.PeerTaskConductor) < params(jcond.PeerTaskConductor)
    assert params(jdisp.PieceDispatcher) - params(pdisp.PieceDispatcher) \
        == {"max_parent_failures"}
    assert params(pdisp.PieceDispatcher) == {"quarantine", "flight"}
    parent = pdisp.ParentInfo("p", "10.0.0.1", 65002)
    assert pdisp.parent_key(parent) == jdisp.parent_key(
        jdisp.ParentInfo("p", "10.0.0.1", 65002)) == "10.0.0.1:65002"
    for name in ("NativeConnPool", "run_native", "abandonable_native_call"):
        assert hasattr(jdl, name) and not hasattr(pdl, name)
    assert hasattr(jdl.PieceDownloader, "download_piece_to_store")
    assert not hasattr(pdl.PieceDownloader, "download_piece_to_store")
    for name in ("native_counters", "_native_eligible"):
        assert hasattr(jupload.UploadManager, name)
        assert not hasattr(pupload.UploadManager, name)
    # No native report decoder and no backend ladder: the port decodes
    # with the JAX module's numpy decoder, always.
    assert hasattr(jcodec, "_native_decoder")
    for name in ("_native_decoder", "_select_decoder",
                 "REPORT_BACKEND_ACTIVE"):
        assert not hasattr(pcodec, name)
    assert pcodec.report_backend() == "numpy"
    # stamp_running stays; its caller (the runtime profiler) is not ported.
    assert hasattr(pflight.FlightRecorder, "stamp_running")
    callers = []
    for path in _port_sources():
        if os.path.basename(path) != "flight.py":
            with open(path) as f:
                if "stamp_running(" in f.read():
                    callers.append(path)
    assert callers == []
    assert "ssl_context" in params(jupload.UploadManager)
    assert "ssl_context" not in params(pupload.UploadManager)
    assert "ssl_context" in params(JClient) and "ssl_context" in params(
        JServer.serve)
    assert "ssl_context" not in params(Client)
    assert "ssl_context" not in params(Server.serve)

    # The report forms follow the negotiation, as in JAX.
    c = pcond.PeerTaskConductor(
        task_id="t", peer_id="p", url="http://x/", store=None,
        scheduler_client=None, piece_manager=None, host_info={})
    reports = [{"piece_num": n, "range_start": 0, "range_size": 1,
                "digest": "", "download_cost_ms": 0, "dst_peer_id": ""}
               for n in range(40)]
    assert c._batch_msg(reports) == {"type": "pieces_finished",
                                     "pieces": reports}
    assert c._batch_msg(reports[:1]) == {"type": "piece_finished",
                                         "piece": reports[0]}
    c.store = type("S", (), {"metadata": type("M", (), {
        "pieces": dict.fromkeys(range(64)), "content_length": 64,
        "piece_size": 1, "total_piece_count": 64, "digest": ""})})
    resume = c._resume_state()
    assert resume["piece_nums"] == list(range(64))
    assert "piece_bitmap" not in resume
    c._packed_ok = True
    assert c._batch_msg(reports) == {
        "type": "pieces_finished", "packed": jcodec.encode_reports(reports)}
    resume = c._resume_state()
    assert resume["piece_nums"] == []
    assert resume["piece_bitmap"] == jcodec.nums_to_bitmap(range(64))

    from dragonfly2_tpu.daemon.rpcserver import DaemonRpcServer as JServer
    from dragonfly2_tpu.proto import wire as jwire
    from dragonfly2_tpu_torch.proto import wire as pwire

    served, jserved = DaemonRpcServer(None), JServer(None)
    for service in ("peer_server", "download_server"):
        port, jax = getattr(served, service), getattr(jserved, service)
        assert set(port._stream) == set(jax._stream)
        assert set(port._unary) == set(jax._unary)
    # The port's wire schemas are the JAX ones of the methods it serves,
    # of the scheduler method Daemon.PodTimeline proxies and of the host
    # announcements its announcer sends.
    methods = set(served.peer_server._unary) | set(
        served.download_server._unary)
    assert set(pwire.UNARY) == (methods & set(jwire.UNARY)) | {
        "Scheduler.PodTimeline", "Scheduler.AnnounceHost",
        "Scheduler.LeaveHost"}
    assert set(pwire.STREAM_OPEN) == (set(served.peer_server._stream) | set(
        served.download_server._stream)) & set(jwire.STREAM_OPEN)
    assert set(pwire.STREAM_MSGS) == {"Scheduler.AnnouncePeer"}
    assert set(pwire.STREAM_MSGS["Scheduler.AnnouncePeer"]) == set(
        jwire.STREAM_MSGS["Scheduler.AnnouncePeer"])


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_aiohttp(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if n.split(".")[0] == "aiohttp"] == []


# The JAX package's native library by any name a program could load it by:
# its built library, its package, its binding or its build directory. Its
# sources (``dragonfly2_tpu/native/src/...``) may be named as provenance.
_NATIVE_LIB = re.compile(
    r"libdfnative|dragonfly2_tpu\.native|dragonfly2_tpu/native(?!/src/)")


def _port_files() -> list[str]:
    out = list(_port_sources())
    for root, _, files in os.walk(os.path.join(PKG, "csrc")):
        out += [os.path.join(root, f) for f in files]
    return sorted(out)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_source_names_the_jax_native_library(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert _NATIVE_LIB.findall(text) == []
    if (path.startswith(PKG) and path.endswith(".py")
            and os.path.basename(path) != "_build.py"):
        assert "CDLL(" not in text     # the package loads in ops/_build


def test_the_store_path_maps_no_jax_native_library(tmp_path):
    """A process that hashes, writes and re-verifies pieces through the
    port maps the port's host library and nothing of the JAX package's."""
    code = ("import sys\n"
            "from dragonfly2_tpu_torch.pkg import digest\n"
            "from dragonfly2_tpu_torch.storage import LocalTaskStore, "
            "TaskStoreMetadata\n"
            "s = LocalTaskStore.create(sys.argv[1], TaskStoreMetadata(\n"
            "    task_id='t', piece_size=4096, content_length=8192))\n"
            "s.write_piece(0, b'a' * 4096); s.write_piece_chunks(1, "
            "[b'b' * 96, b'c' * 4000])\n"
            "assert s.reverify_pieces() == []\n"
            "assert digest.crc32c(b'123456789') == 0xe3069283\n"
            "print(open('/proc/self/maps').read())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "s")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    maps = proc.stdout
    assert os.path.basename(_build.library_path(_build.HOST_SOURCE)) in maps
    assert "dfnative" not in maps and "dragonfly2_tpu/native" not in maps


def _thread_names(path: str) -> list[tuple[int, str | None]]:
    """(line, leading literal of the name) of each Thread(...) and
    ThreadPoolExecutor(...) call in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        callee = func.attr if isinstance(func, ast.Attribute) \
            else getattr(func, "id", "")
        key = {"Thread": "name",
               "ThreadPoolExecutor": "thread_name_prefix"}.get(callee)
        if key is None:
            continue
        value = {k.arg: k.value for k in node.keywords}.get(key)
        if isinstance(value, ast.JoinedStr) and value.values:
            value = value.values[0]
        out.append((node.lineno, value.value if isinstance(
            value, ast.Constant) and isinstance(value.value, str) else None))
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_threads_carry_a_df_name(path):
    bad = [(line, name) for line, name in _thread_names(path)
           if name is None or not name.startswith("df-")]
    assert bad == []


def test_a_dryrun_rank_loads_no_jax(tmp_path):
    """One rank of ``dryrun_multichip`` (the module run with ``--rank``,
    as the parent starts it) in a world of one on the CPU: it runs the
    whole step and imports neither JAX nor the JAX package."""
    code = ("import json, socket, sys\n"
            "from dragonfly2_tpu_torch import entry\n"
            "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
            "port = s.getsockname()[1]; s.close()\n"
            "entry.main(['--rank', '0', '--world', '1', '--addr',\n"
            "            f'tcp://127.0.0.1:{port}', '--device', 'cpu',\n"
            f"            '--out', {str(tmp_path)!r}])\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "torch.distributed" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert (tmp_path / "rank0.npz").exists()


@pytest.mark.parametrize("name", ["torch_pod_checkpoint.py",
                                  "torch_checkpoint_hotswap.py",
                                  "torch_fabric.py"])
def test_example_twins_import_no_jax(name):
    """The GPU twins of the JAX examples may drive the reference daemon
    and scheduler (plain Python), never JAX."""
    path = os.path.join(REPO, "examples", name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if n == "jax" or n.startswith(
        ("jax.", "jaxlib"))] == []
    assert not any(n.startswith("dragonfly2_tpu.ops") for n in names)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        HBMSink(4096, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceSinkManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFeed("bin", 32768, 64)           # HBMSink-backed batches
    with pytest.raises(RuntimeError, match="CUDA"):
        assemble_delta_u8(None, [("f", b"1234")])

    class Store:
        metadata = type("M", (), {"content_length": 4, "piece_size": 4,
                                  "total_piece_count": 1})()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def read_into(self, offset, length, buf):
            buf[:length] = b"1234"

    with pytest.raises(RuntimeError, match="CUDA"):
        swap_generation(Store())               # client/device.py hot-swap
    with pytest.raises(RuntimeError, match="CUDA"):
        GearChunker()                          # delta/chunker.py
    with pytest.raises(RuntimeError, match="CUDA"):
        chunk_bytes(b"1234")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_manifest(b"1234")                # delta/manifest.py
    with pytest.raises(RuntimeError, match="CUDA"):
        manifest_from_store(Store())
    new_m = build_manifest(b"1234", device="cpu")
    Store.metadata.url, Store.metadata.task_id = "http://o/x", "t"
    with pytest.raises(RuntimeError, match="CUDA"):
        local_base_manifest(Store(), new_m)    # download_delta's fallback
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()                            # parallel/ici.py
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        global_mesh({"dp": 1, "tp": 1})        # parallel/multihost.py
    assert not dist.is_initialized()           # refused before any group
    assert default_device("cpu") == torch.device("cpu")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "library_path",
                        lambda source: str(tmp_path / "absent.so"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()


def test_failed_compile_raises_with_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'checksum.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "library_path",
                        lambda source: str(tmp_path / "build" / "k.so"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with pytest.raises(_build.KernelBuildError, match="boom") as e:
        _build.library()
    assert "exit 2" in str(e.value)
    assert os.listdir(tmp_path / "build") == []   # no half-built library


def test_launch_error_code_raises_kernel_launch_error():
    class Lib:
        @staticmethod
        def df_error_string(code):
            return b"an illegal memory access was encountered"

    _build.check(Lib, 0, "chunk_checksums")
    with pytest.raises(_build.KernelLaunchError,
                       match="chunk_checksums: CUDA error 700: an illegal"):
        _build.check(Lib, 700, "chunk_checksums")
    assert issubclass(_build.KernelLaunchError, _build.KernelError)
    assert issubclass(_build.KernelBuildError, _build.KernelError)


def test_library_name_follows_source_and_flags():
    path = _build.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build")
    assert path == _build.library_path()


@pytest.mark.parametrize("length", [0, 1, 128 << 20, (128 << 20) + 1,
                                    1 << 30, 4_976_698_640, 70 << 30])
def test_piece_math_matches_jax(length):
    size = piece.compute_piece_size(length)
    assert size == jax_piece.compute_piece_size(length)
    if length:
        assert (piece.compute_piece_count(length, size)
                == jax_piece.compute_piece_count(length, size))


def test_metrics_registry_get_or_create_and_labels():
    c = metrics.counter("port_test_events_total", "test", ("kind",))
    assert metrics.counter("port_test_events_total", "test", ("kind",)) is c
    with pytest.raises(ValueError):
        metrics.counter("port_test_events_total", "test", ())
    with pytest.raises(ValueError):
        c.inc()                       # labeled: needs labels()
    with pytest.raises(ValueError):
        c.labels("a", "b")
    c.labels("a").inc(2)
    assert c.value("a") == 2 and c.value("b") == 0


def test_gauges_set_inc_dec_and_labels():
    # Registered here too, so that the test stands alone.
    metrics.counter("port_test_events_total", "test", ("kind",))
    g = metrics.gauge("port_test_depth", "test")
    assert metrics.gauge("port_test_depth", "test") is g
    g.set(5)
    g.inc(2)
    g.dec()
    assert g.value() == 6
    lg = metrics.gauge("port_test_bytes", "test", ("pool",))
    lg.labels("a").set(10)
    lg.labels("a").dec(4)
    lg.labels("b").inc()
    assert (lg.value("a"), lg.value("b"), lg.value("c")) == (6, 1, 0)
    with pytest.raises(ValueError):
        lg.set(1)                     # labeled: needs labels()
    with pytest.raises(ValueError):
        metrics.counter("port_test_depth", "test")   # a gauge already
    with pytest.raises(ValueError):
        metrics.gauge("port_test_events_total", "test", ("kind",))
    c = metrics.counter("port_test_events_total", "test", ("kind",))
    with pytest.raises(ValueError):
        c.labels("a").set(3)          # counters are never set
    with pytest.raises(ValueError):
        c.labels("a").dec()
    with pytest.raises(ValueError):
        c.labels("a").inc(-1)


def test_device_sink_metric_families_keep_the_jax_names():
    from dragonfly2_tpu_torch.daemon.peer import device_sink as pds

    assert pds.SINK_LANDED_BYTES.name == "device_sink_landed_bytes_total"
    assert pds.SINK_VERIFY_COUNT.name == "device_sink_verify_total"
    assert pds.SINK_VERIFY_COUNT.labelnames == ("result",)


def test_metrics_counter_is_thread_safe():
    c = metrics.counter("port_test_stress_total", "test")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [c.inc() for _ in range(2000)],
            name=f"df-test-{i}") for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value() == 16 * 2000
