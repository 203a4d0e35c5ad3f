"""Rules the PyTorch port keeps, and its small own copies.

- The port, its tools (``tools/``) and ``chip_smoke.py`` import neither
  JAX nor the JAX package
  (checked in a subprocess, since ``tests/conftest.py`` imports jax into
  every test process, and by an AST scan of the sources); nor does a
  rank process of ``dryrun_multichip``. The example twins import no JAX.
  The dataset plane and the object-gateway client import without
  ``aiohttp`` (the card machine has none); no port source imports
  ``cryptography`` (nor has the card machine it), and the daemon with its
  proxy, CA and QoS plane runs with none of ``aiohttp``, ``msgpack`` or
  ``cryptography`` importable; the scheduler serves with none of
  ``aiohttp``, ``msgpack`` or ``yaml`` importable. What the daemon's
  and the scheduler's slices leave out, or refuse, is pinned.
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
    """The daemon and its services (config, announcer, transport, the
    object gateway and its ``fs`` backend, the metrics server, the proxy,
    the CA, TLS, the QoS plane, the plugin registry, the runtime
    observatory, the SLO engine and tracing) import none of the JAX side, ``aiohttp``,
    ``msgpack`` or ``cryptography`` (the card machine has none of them),
    nor ``yaml`` or ``psutil`` (not known to be there: the config reads
    YAML through a lazy import, the announcer's telemetry comes from the
    standard library); and with none of those five importable a daemon
    with the proxy (its HTTPS hijack and SNI listener) and the QoS plane
    on still builds, starts with its gateway and runtime observatory and
    stops."""
    code = ("import asyncio, json, sys, tempfile\n"
            "import dragonfly2_tpu_torch.daemon.daemon\n"
            "import dragonfly2_tpu_torch.daemon.objectstorage\n"
            "import dragonfly2_tpu_torch.daemon.proxy\n"
            "import dragonfly2_tpu_torch.pkg.certify\n"
            "import dragonfly2_tpu_torch.pkg.security\n"
            "import dragonfly2_tpu_torch.pkg.metrics_server\n"
            "import dragonfly2_tpu_torch.pkg.objectstorage.fs\n"
            "import dragonfly2_tpu_torch.pkg.dfplugin\n"
            "import dragonfly2_tpu_torch.pkg.prof\n"
            "import dragonfly2_tpu_torch.pkg.slo\n"
            "import dragonfly2_tpu_torch.pkg.tracing\n"
            "import dragonfly2_tpu_torch.qos\n"
            "loaded = sorted(sys.modules)\n"
            "for m in ('aiohttp', 'msgpack', 'cryptography', 'yaml',\n"
            "          'psutil'):\n"
            "    sys.modules[m] = None\n"
            "from dragonfly2_tpu_torch.daemon.config import DaemonConfig\n"
            "from dragonfly2_tpu_torch.daemon.daemon import Daemon\n"
            "home = tempfile.mkdtemp()\n"
            "cfg = DaemonConfig.from_dict({'work_home': home, 'host': {\n"
            "    'hostname': 'h', 'ip': '127.0.0.1'}, 'metrics_port': 0,\n"
            "    'object_storage': {'enabled': True, 'backend_options': {\n"
            "        'root': home + '/b'}}, 'tpu_sink': {'enabled': True},\n"
            "    'proxy': {'enabled': True, 'hijack_https': True,\n"
            "              'sni_enabled': True, 'sni_hijack': True},\n"
            "    'qos': {'enabled': True}})\n"
            "async def main():\n"
            "    d = Daemon(cfg, device='cpu')\n"
            "    await d.start()\n"
            "    assert d.proxy.port and d.proxy._sni_port and d.qos_gate\n"
            "    assert d.prof_obs is not None and d.metrics.port\n"
            "    d.proxy.ca.server_context('registry.local')\n"
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
            "dragonfly2_tpu_torch.qos.wfq",
            "dragonfly2_tpu_torch.pkg.httpserver",
            "dragonfly2_tpu_torch.pkg.dfplugin",
            "dragonfly2_tpu_torch.pkg.prof",
            "dragonfly2_tpu_torch.pkg.tracing"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.split(".")[0] in (
        "aiohttp", "msgpack", "cryptography", "yaml", "psutil")] == []


def test_the_scheduler_imports_none_of_jax_aiohttp_msgpack_yaml():
    """The scheduler and its support copies (``pkg/{fsm,dag,slo,podlens,
    prof,tracing,dfplugin}.py``, ``qos/admission.py``, the ``Scheduler.*``
    schemas) import none of the
    JAX side, ``aiohttp``, ``msgpack`` or ``yaml`` (the JAX scheduler's
    drpc needs ``msgpack``, its config imports ``yaml`` at module top and
    its tiny-task fetch uses ``aiohttp``, its pod lens ``msgpack``); with
    none of the three importable it loads a JSON config, serves with the
    pod lens, the SLO engine and the runtime observatory on, answers a
    unary call over drpc and stops."""
    code = ("import asyncio, json, os, sys, tempfile\n"
            "for m in ('aiohttp', 'msgpack', 'yaml'):\n"
            "    sys.modules[m] = None\n"
            "import dragonfly2_tpu_torch.scheduler.server\n"
            "import dragonfly2_tpu_torch.scheduler.service\n"
            "import dragonfly2_tpu_torch.scheduler.resource.snapshot\n"
            "import dragonfly2_tpu_torch.scheduler.resource.persistentcache\n"
            "import dragonfly2_tpu_torch.pkg.dag\n"
            "import dragonfly2_tpu_torch.pkg.dfplugin\n"
            "import dragonfly2_tpu_torch.pkg.podlens\n"
            "import dragonfly2_tpu_torch.pkg.prof\n"
            "import dragonfly2_tpu_torch.pkg.tracing\n"
            "import dragonfly2_tpu_torch.qos.admission\n"
            "from dragonfly2_tpu_torch.rpc import Client\n"
            "from dragonfly2_tpu_torch.pkg.types import NetAddr\n"
            "from dragonfly2_tpu_torch.scheduler.config import "
            "SchedulerConfig\n"
            "from dragonfly2_tpu_torch.scheduler.server import "
            "SchedulerServer\n"
            "path = os.path.join(tempfile.mkdtemp(), 'scheduler.json')\n"
            "with open(path, 'w') as f:\n"
            "    json.dump({'server': {'port': 0}, 'metrics_port': -1,\n"
            "               'fleet': {'enabled': False}}, f)\n"
            "async def main():\n"
            "    s = SchedulerServer(SchedulerConfig.load(path))\n"
            "    await s.start()\n"
            "    assert s.service.pod_lens and s.service.slo and s.prof_obs\n"
            "    cli = Client(NetAddr.tcp('127.0.0.1', s.port()))\n"
            "    assert (await cli.call('Scheduler.ListHosts', {})) == "
            "{'hosts': []}\n"
            "    await cli.close()\n"
            "    await s.stop()\n"
            "asyncio.run(main())\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.scheduler.config",
            "dragonfly2_tpu_torch.scheduler.scheduling.scheduling",
            "dragonfly2_tpu_torch.scheduler.scheduling.evaluator",
            "dragonfly2_tpu_torch.scheduler.scheduling.stripe",
            "dragonfly2_tpu_torch.scheduler.seed_client",
            "dragonfly2_tpu_torch.pkg.fsm",
            "dragonfly2_tpu_torch.pkg.slo",
            "dragonfly2_tpu_torch.pkg.podlens",
            "dragonfly2_tpu_torch.pkg.prof",
            "dragonfly2_tpu_torch.pkg.tracing",
            "dragonfly2_tpu_torch.pkg.dfplugin"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.split(".")[0] in (
        "aiohttp", "msgpack", "yaml")] == []


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


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_cryptography(path):
    """The CA, TLS and the proxy stand on ``ssl`` and the standard
    library: ``cryptography`` is not on the card machine."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if n.split(".")[0] == "cryptography"] == []


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
    """What the daemon slice has as JAX does, and leaves out, pinned: the
    gateway adopts a caller's ``traceparent`` (``gateway.get_object`` in
    its trace); the metrics server serves the JAX ``/debug/*`` routes
    (stacks, flights, the runtime-only ``/debug/slo``, ``/debug/prof*``)
    but the cluster family; ``prof.enabled`` (the default) installs the
    runtime observatory (a ``daemon`` loop probe, the recorder's
    ``runtime``) and ``prof.enabled=False`` installs none; ``fs`` is the
    only object-storage backend; the announcer's telemetry is the JAX
    keys from the standard library; the transport has the JAX proxy half
    (rules, default tag, ``should_use_p2p``), which the proxy calls; the
    GC runner has no ``run``, which nothing calls."""
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
    from dragonfly2_tpu_torch.pkg import prof as pprof
    from dragonfly2_tpu_torch.pkg import tracing as ptracing
    from dragonfly2_tpu_torch.pkg.objectstorage import NOT_PORTED

    assert hasattr(jgateway, "tracing") and hasattr(pgateway, "tracing")
    assert pms.MetricsServer.debug_routes() == [
        r for r in jms.MetricsServer.debug_routes()
        if not r.startswith("/debug/cluster")]
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
        assert hasattr(jtransport, name) and hasattr(ptransport, name)
    assert jtransport.HDR_NO_P2P == ptransport.HDR_NO_P2P
    assert jtransport._BLOB_RE.pattern == ptransport._BLOB_RE.pattern
    assert hasattr(ptransport.P2PTransport, "should_use_p2p")
    assert set(inspect.signature(jtransport.P2PTransport).parameters) == set(
        inspect.signature(ptransport.P2PTransport).parameters)
    assert hasattr(jcache.GC, "run") and not hasattr(pcache.GC, "run")

    def get(port: int, path: str):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request("GET", path, headers={
                "traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"})
            r = c.getresponse()
            r.read()
            return r.status, r.getheader("traceparent")
        finally:
            c.close()

    async def run(prof: bool):
        cfg = DaemonConfig.from_dict({
            "work_home": str(tmp_path / str(prof)), "metrics_port": 0,
            "host": {"hostname": "h", "ip": "127.0.0.1"},
            "prof": {"enabled": prof},
            "object_storage": {"enabled": True, "backend_options": {
                "root": str(tmp_path / "b")}}})
        d = Daemon(cfg, device="cpu")
        await d.start()
        loop = asyncio.get_running_loop()
        got = {}
        try:
            got["observatory"] = (d.prof_obs is not None,
                                  d.prof_obs is pprof.observatory(),
                                  d.task_manager.flight.runtime is not None)
            if prof:
                assert set(d.prof_obs.probes) >= {"daemon"}
            for path in ("/debug/stacks", "/debug/flight", "/debug/slo",
                         "/debug/prof", "/debug/prof/runtime",
                         "/debug/cluster", "/debug/fleet"):
                got[path] = (await loop.run_in_executor(
                    None, get, d.metrics.port, path))[0]
            ptracing.exporter().clear()
            got["gateway"] = await loop.run_in_executor(
                None, get, d.object_storage.port, "/healthy")
        finally:
            await d.stop()
        got["released"] = (d.prof_obs, pprof.observatory() is held)
        return got

    held = pprof.observatory()   # one another test left installed, if any
    on = run_async(run(True))
    assert on == {
        "observatory": (True, True, True), "/debug/stacks": 200,
        "/debug/flight": 200, "/debug/slo": 200, "/debug/prof": 200,
        "/debug/prof/runtime": 200, "/debug/cluster": 404,
        "/debug/fleet": 404, "gateway": (200, None),
        "released": (None, True)}
    off = run_async(run(False))
    assert off["observatory"] == (False, held is None, False)
    assert (off["/debug/slo"], off["/debug/prof"],
            off["/debug/stacks"]) == (404, 404, 200)
    jd = jannouncer.Announcer.host_wire.__code__.co_names
    assert "_telemetry" in jd
    cfg = DaemonConfig.from_dict({"work_home": str(tmp_path / "t")})
    keys = set(pannouncer.Announcer(cfg, None, peer_port=1,
                                    upload_port=2)._telemetry())
    assert keys == set(jannouncer.Announcer._telemetry()) == {
        "cpu_percent", "mem_percent", "disk_free"}


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
    """What the P2P half leaves out, pinned: no native piece fetch, no
    native upload server and no native report decoder
    (``report_backend()`` is ``"numpy"``). ``stamp_running``'s one caller
    is the runtime observatory (``pkg/prof``), as in JAX. What it has as
    the JAX half does: the conductor's parameters,
    its QoS gate among them (its worker count and report batch come from
    the daemon's config, the old constants their defaults); TLS on the
    drpc client and server and the upload server; the flight recorder
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

    # The QoS gate, the worker count and the report batch come from the
    # config in both, with the same defaults. The seed flag comes from the
    # request (a seed trigger) or the config in both, and so do the flight
    # and the quarantine (the task manager's).
    assert params(jcond.PeerTaskConductor) == params(pcond.PeerTaskConductor)
    assert inspect.signature(pcond.PeerTaskConductor).parameters[
        "wfq"].default is None
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
    # stamp_running's caller is the runtime observatory, as in JAX.
    assert hasattr(pflight.FlightRecorder, "stamp_running")
    callers = []
    for path in _port_sources():
        if os.path.basename(path) != "flight.py":
            with open(path) as f:
                if "stamp_running(" in f.read():
                    callers.append(os.path.relpath(path, REPO))
    assert callers == [os.path.join("dragonfly2_tpu_torch", "pkg",
                                    "prof.py")]
    for have in (params(jupload.UploadManager), params(pupload.UploadManager),
                 params(JClient), params(Client), params(JServer.serve),
                 params(Server.serve)):
        assert "ssl_context" in have
    assert params(jupload.UploadManager) == params(pupload.UploadManager)

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
    # The port's wire schemas are the JAX ones of the methods it serves:
    # the daemon's two services, every method of the scheduler (which
    # takes in the one Daemon.PodTimeline proxies and the host
    # announcements the daemon's announcer sends) and of the manager.
    from dragonfly2_tpu_torch.manager.rpcserver import ManagerRpcServer
    from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer.__new__(SchedulerServer)
    sched.service = type("S", (), {"__getattr__": lambda self, n: n})()
    sched.rpc = Server("scheduler")
    sched._register()
    mgr = Server("manager")
    ManagerRpcServer(None).register(mgr)
    methods = set(served.peer_server._unary) | set(
        served.download_server._unary) | set(sched.rpc._unary) | set(
        mgr._unary)
    assert set(pwire.UNARY) == methods & set(jwire.UNARY)
    assert set(pwire.STREAM_OPEN) == (set(served.peer_server._stream) | set(
        served.download_server._stream) | set(sched.rpc._stream) | set(
        mgr._stream)) & set(jwire.STREAM_OPEN)
    for table in ("UNARY", "STREAM_OPEN"):
        ported, jax = getattr(pwire, table), getattr(jwire, table)
        for method in ported:
            assert {f: (v.type, v.required) for f, v in
                    ported[method].fields.items()} == {
                f: (v.type, v.required)
                for f, v in jax[method].fields.items()}, method
    assert set(pwire.STREAM_MSGS) == {"Scheduler.AnnouncePeer"}
    assert set(pwire.STREAM_MSGS["Scheduler.AnnouncePeer"]) == set(
        jwire.STREAM_MSGS["Scheduler.AnnouncePeer"])


def test_the_intended_divergences_of_the_scheduler(run_async, tmp_path,
                                                   monkeypatch):
    """What the port's scheduler does as JAX does, and leaves out, pinned.
    A ``scheduling.algorithm`` other than ``"default"`` names an evaluator
    plugin (``pkg/dfplugin``): an unknown one raises the JAX
    ``LookupError``, one in ``DRAGONFLY_PLUGIN_DIR`` is built. A default
    ``SchedulerConfig()`` builds the fleet (``Scheduling.wire_fleet``
    wired), the pod lens and the SLO engine over the fleet's series, as
    the JAX service does; ``podlens.enabled=False`` builds neither and
    ``Scheduler.PodTimeline`` answers as the JAX scheduler's then. The
    server installs the runtime observatory (a ``scheduler`` loop probe
    whose ``loop_lag`` joins the SLO engine, released at stop) and serves
    ``/debug/pod/<task>/timeline``, ``/debug/slo`` and ``/debug/prof*``
    beside the fleet's routes. ``manager_addr`` is served: the scheduler
    registers with the port's manager and keeps alive there, its
    keepalive carrying the tenant burn snapshot and no fleet frame (no
    cluster tower: no ``frame_builder``). The tiny task's fetch is
    ``http.client``."""
    import asyncio
    import inspect
    import textwrap
    import urllib.error
    import urllib.request

    import dragonfly2_tpu.pkg.dfplugin as jplugin
    import dragonfly2_tpu_torch.pkg.dfplugin as pplugin
    from dragonfly2_tpu.pkg.errors import DfError as JDfError
    from dragonfly2_tpu.scheduler.config import SchedulerConfig as JConfig
    from dragonfly2_tpu.scheduler.scheduling import Scheduling as JScheduling
    from dragonfly2_tpu.scheduler.service import SchedulerService as JService
    from dragonfly2_tpu_torch.pkg import prof as pprof
    from dragonfly2_tpu_torch.pkg.errors import DfError
    from dragonfly2_tpu_torch.scheduler import service as psvc
    from dragonfly2_tpu_torch.scheduler.config import (
        SchedulerConfig,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
    from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

    (tmp_path / "df_plugin_ev.py").write_text(textwrap.dedent("""
        PLUGIN_TYPE = "evaluator"
        PLUGIN_NAME = "pinned"

        class Pinned:
            def __init__(self, config):
                self.config = config

        def create(config=None):
            return Pinned(config)
    """))
    monkeypatch.setenv("DRAGONFLY_PLUGIN_DIR", str(tmp_path))
    for mod in (jplugin, pplugin):
        monkeypatch.setattr(mod, "_default", mod.PluginRegistry())
    off = {"fleet": {"enabled": False}}
    jcfg = JConfig()
    jcfg.scheduling.algorithm = "absent"
    msgs = []
    for make in (lambda: JService(jcfg), lambda: psvc.SchedulerService(
            SchedulerConfig.from_dict({"scheduling": {
                "algorithm": "absent"}}))):
        with pytest.raises(LookupError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "no evaluator plugin named 'absent'"
    plugged = Scheduling(SchedulingConfig(algorithm="pinned"))
    assert type(plugged.evaluator).__name__ == "Pinned"
    assert plugged.evaluator.config.algorithm == "pinned"
    assert not hasattr(psvc, "refuse_unported")
    default = psvc.SchedulerService(SchedulerConfig())
    assert default.fleet is not None
    assert default.scheduling.fleet is default.fleet
    assert default.pod_lens is not None
    assert default.slo is not None and default.slo.series is \
        default.fleet.series
    assert not hasattr(default, "frame_builder")

    async def registers():
        from dragonfly2_tpu_torch.manager import ManagerConfig, ManagerServer

        manager = ManagerServer(ManagerConfig.from_dict({"metrics_port": -1}))
        await manager.start()
        server = SchedulerServer(SchedulerConfig.from_dict({
            "server": {"port": 0}, "metrics_port": -1,
            "manager_addr": f"127.0.0.1:{manager.grpc_port()}",
            "manager_keepalive_interval": 0.02}))
        seen = []
        keepalive = manager.service.keepalive
        manager.service.keepalive = lambda *a: (seen.append(a),
                                                keepalive(*a))
        try:
            await server.start()
            while len(seen) < 2:
                await asyncio.sleep(0.01)
            row = manager.db.get("schedulers",
                                 server.announcer.registered["id"])
            return (row["state"], row["port"] == server.port(),
                    server.service.manager_payload(),
                    server.job_worker is not None)
        finally:
            await server.stop()
            await manager.stop()

    assert run_async(registers(), timeout=30) == (
        "active", True, {"tenant_burn": {}}, True)
    assert hasattr(JScheduling, "wire_fleet")
    assert hasattr(Scheduling, "wire_fleet")

    lens_off = {**off, "podlens": {"enabled": False}}
    svc = psvc.SchedulerService(SchedulerConfig.from_dict(lens_off))
    assert (svc.pod_lens, svc.slo, svc.fleet) == (None, None, None)
    jcfg = JConfig()
    jcfg.fleet.enabled = False
    jcfg.podlens.enabled = False
    jsvc = JService(jcfg)

    async def timelines():
        out = []
        for s, err in ((jsvc, JDfError), (svc, DfError)):
            with pytest.raises(err) as e:
                await s.pod_timeline({"task_id": "t"}, None)
            out.append((int(e.value.code), e.value.message))
        return out

    j, p = run_async(timelines())
    assert j == p

    held = pprof.observatory()   # one another test left installed, if any

    async def metrics(over):
        server = SchedulerServer(SchedulerConfig.from_dict(
            {**over, "server": {"port": 0}, "metrics_port": 0}))
        await server.start()
        base = f"http://127.0.0.1:{server.metrics.port}"
        try:
            got = {"probe": (
                server.prof_obs is not None and "scheduler" in
                server.prof_obs.probes,
                server.service.slo is not None and
                "loop_lag" in server.service.slo.probes)}

            def status(path: str) -> int:
                try:
                    with urllib.request.urlopen(base + path,
                                                timeout=10) as r:
                        return r.status
                except urllib.error.HTTPError as e:
                    return e.code

            for path in ("/metrics", "/healthy", "/debug/fleet",
                         "/debug/pod/t/timeline", "/debug/slo",
                         "/debug/prof", "/debug/pod/t"):
                got[path] = await asyncio.to_thread(status, path)
            return got
        finally:
            await server.stop()
            assert server.prof_obs is None
            assert pprof.observatory() is held

    assert run_async(metrics({**lens_off, "prof": {"enabled": False}})) == {
        "probe": (False, False), "/metrics": 200, "/healthy": 200,
        "/debug/fleet": 404, "/debug/pod/t/timeline": 404,
        "/debug/slo": 404, "/debug/prof": 404, "/debug/pod/t": 404}
    assert run_async(metrics({})) == {
        "probe": (True, True), "/metrics": 200, "/healthy": 200,
        "/debug/fleet": 200, "/debug/pod/t/timeline": 404,
        "/debug/slo": 200, "/debug/prof": 200, "/debug/pod/t": 404}
    fetch = inspect.getsource(psvc.SchedulerService._fetch_direct_piece)
    assert "_http_get" in fetch and "aiohttp" not in fetch
    assert "http.client.HTTPConnection" in inspect.getsource(psvc._http_get)


def test_the_manager_imports_none_of_jax_aiohttp_msgpack_yaml():
    """The manager (``manager/``), ``pkg/dynconfig.py`` and the
    scheduler's manager-fed modules (``scheduler/{announcer,dynconfig,
    job}.py``) import none of the JAX side, ``aiohttp``, ``msgpack``,
    ``yaml`` or ``cryptography`` (the JAX manager's REST, preheat and
    oauth need ``aiohttp``, its drpc ``msgpack``); with none of them
    importable the manager serves REST and drpc, a scheduler registers
    with it and both stop."""
    code = ("import asyncio, http.client, json, sys\n"
            "for m in ('aiohttp', 'msgpack', 'yaml', 'cryptography'):\n"
            "    sys.modules[m] = None\n"
            "import dragonfly2_tpu_torch.manager.__main__\n"
            "import dragonfly2_tpu_torch.manager.console\n"
            "import dragonfly2_tpu_torch.pkg.dynconfig\n"
            "import dragonfly2_tpu_torch.pkg.prof\n"
            "import dragonfly2_tpu_torch.scheduler.job\n"
            "from dragonfly2_tpu_torch.manager import ManagerConfig, "
            "ManagerServer\n"
            "from dragonfly2_tpu_torch.manager.client import ManagerClient\n"
            "from dragonfly2_tpu_torch.pkg.types import NetAddr\n"
            "from dragonfly2_tpu_torch.scheduler.config import "
            "SchedulerConfig\n"
            "from dragonfly2_tpu_torch.scheduler.server import "
            "SchedulerServer\n"
            "def signin(port):\n"
            "    c = http.client.HTTPConnection('127.0.0.1', port)\n"
            "    c.request('POST', '/api/v1/users/signin', body=json.dumps("
            "{'name': 'root', 'password': 'dragonfly'}))\n"
            "    return c.getresponse().status\n"
            "async def main():\n"
            "    m = ManagerServer(ManagerConfig.from_dict("
            "{'metrics_port': -1}))\n"
            "    await m.start()\n"
            "    assert await asyncio.to_thread(signin, m.rest_port) == 200\n"
            "    s = SchedulerServer(SchedulerConfig.from_dict({\n"
            "        'server': {'port': 0}, 'metrics_port': -1,\n"
            "        'fleet': {'enabled': False},\n"
            "        'manager_addr': f'127.0.0.1:{m.grpc_port()}'}))\n"
            "    await s.start()\n"
            "    cli = ManagerClient(NetAddr.tcp('127.0.0.1', m.grpc_port()))\n"
            "    assert len(await cli.list_schedulers()) == 1\n"
            "    await cli.close()\n"
            "    await s.stop()\n"
            "    await m.stop()\n"
            "asyncio.run(main())\n"
            "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
            "                        if v is not None)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.manager.rest",
            "dragonfly2_tpu_torch.manager.rpcserver",
            "dragonfly2_tpu_torch.manager.oauth",
            "dragonfly2_tpu_torch.manager.preheat",
            "dragonfly2_tpu_torch.manager.database",
            "dragonfly2_tpu_torch.scheduler.announcer",
            "dragonfly2_tpu_torch.scheduler.dynconfig",
            "dragonfly2_tpu_torch.scheduler.job",
            "dragonfly2_tpu_torch.pkg.dynconfig",
            "dragonfly2_tpu_torch.pkg.prof"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.split(".")[0] in (
        "aiohttp", "msgpack", "yaml", "cryptography")] == []


def test_the_cli_imports_none_of_jax_aiohttp_msgpack_yaml_psutil():
    """The CLI (``cli/``), its client libraries (``client/dfget.py``,
    ``client/dfcache.py``), the daemon's dynconfig and the fleet
    observatory import none of the JAX side, ``aiohttp``, ``msgpack``,
    ``cryptography``, ``yaml`` or ``psutil``; with none of them importable
    every subcommand parses and ``dfget`` refuses a missing ``-O``."""
    code = ("import json, sys\n"
            "for m in ('aiohttp', 'msgpack', 'cryptography', 'yaml',\n"
            "          'psutil'):\n"
            "    sys.modules[m] = None\n"
            "import dragonfly2_tpu_torch.cli.main as cli\n"
            "import dragonfly2_tpu_torch.cli.extra\n"
            "import dragonfly2_tpu_torch.client.dfget\n"
            "import dragonfly2_tpu_torch.client.dfcache\n"
            "import dragonfly2_tpu_torch.daemon.dynconfig\n"
            "import dragonfly2_tpu_torch.pkg.fleet\n"
            "import dragonfly2_tpu_torch.pkg.tracing\n"
            "for argv in (['dfget', 'http://o/x', '-O', 'o'], ['daemon'],\n"
            "             ['scheduler'], ['manager'], ['dfcache', 'stat',\n"
            "             'c'], ['dfstore', 'ls']):\n"
            "    cli.build_parser().parse_args(argv)\n"
            "assert cli.main(['dfget', 'http://o/x']) == 2\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"dragonfly2_tpu_torch.cli.extra",
            "dragonfly2_tpu_torch.client.dfget",
            "dragonfly2_tpu_torch.daemon.dynconfig",
            "dragonfly2_tpu_torch.pkg.fleet",
            "dragonfly2_tpu_torch.pkg.tracing"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_intended_divergences_of_the_cli(capsys):
    """The port's CLI keeps every JAX flag, and differs where it must:

    - ``--torch-device {cuda,cpu}`` on ``daemon`` and ``dfget``, ``cuda``
      by default, handed by ``dfget`` to the daemon it spawns (the port's
      ``Daemon`` binds a device even without a sink; no environment
      variable, no fallback);
    - ``dfget --device cuda``, an alias sent on the wire as ``"tpu"``;
    - ``dfget --cluster`` refused with exit code 2 naming ROADMAP A7.4
      item 6 (no ``Manager.ClusterView``), before anything is fetched;
    - ``client/dfget.download`` opens the JAX ``dfget.download`` span,
      and ``dfget`` flushes the OTLP exporter before it exits (the JAX
      CLI does not: its span may die queued);
    - ``dfget`` waits 30 s for the daemon it spawns, not 15 s: the port's
      daemon imports torch and binds the card on its first start."""
    import argparse
    import inspect

    from dragonfly2_tpu.cli import extra as jextra
    from dragonfly2_tpu.cli import main as jmain
    from dragonfly2_tpu.client import dfget as jdfget
    from dragonfly2_tpu_torch.cli import extra as pextra
    from dragonfly2_tpu_torch.cli import main as pmain
    from dragonfly2_tpu_torch.client import dfget as pdfget

    def flags(main_mod, extra_mod):
        parser = argparse.ArgumentParser()
        sub = parser.add_subparsers(dest="command")
        main_mod._add_dfget(sub)
        main_mod._add_daemon(sub)
        extra_mod.register(sub)
        return {name: {a.dest: (a.default, a.choices)
                       for a in p._actions if a.dest != "help"}
                for name, p in sub.choices.items()}

    jflags, pflags = flags(jmain, jextra), flags(pmain, pextra)
    for cmd, opts in jflags.items():
        extra = set(pflags[cmd]) - set(opts)
        assert extra == ({"torch_device"} if cmd in ("dfget", "daemon")
                         else set()), cmd
        for dest, (default, choices) in opts.items():
            pdefault, pchoices = pflags[cmd][dest]
            assert pdefault == default, (cmd, dest)
            if (cmd, dest) != ("dfget", "device"):
                assert pchoices == choices, (cmd, dest)
    assert pflags["dfget"]["device"][1] == ["", "tpu", "cuda"]
    assert jflags["dfget"]["device"][1] == ["", "tpu"]
    for cmd in ("dfget", "daemon"):
        assert pflags[cmd]["torch_device"] == ("cuda", ("cuda", "cpu"))
    assert pmain.DEVICE_ALIASES["cuda"] == "tpu"

    called = []
    pdfget_download = pdfget.download
    try:
        pdfget.download = lambda *a, **k: called.append(a)
        assert pmain.main(["dfget", "http://o/x", "-O", "o",
                           "--cluster"]) == 2
    finally:
        pdfget.download = pdfget_download
    assert called == []
    err = capsys.readouterr().err
    assert "ROADMAP A7.4 item 6" in err and "--cluster" in err

    assert hasattr(jdfget, "tracing") and hasattr(pdfget, "tracing")
    for mod in (jdfget, pdfget):
        assert 'tracing.span("dfget.download", url=cfg.url)' in \
            inspect.getsource(mod.download)
    assert "otlp.flush" in inspect.getsource(pmain._run_dfget)
    assert "otlp" not in inspect.getsource(jmain._run_dfget)
    wait = inspect.signature(jmain._wait_daemon).parameters["timeout"]
    assert wait.default == 15.0
    assert inspect.signature(pmain._wait_daemon).parameters[
        "timeout"].default == pmain.SPAWN_WAIT_S == 30.0
    spawn = inspect.getsource(pmain._spawn_daemon)
    assert '"--torch-device", torch_device' in spawn
    assert "dragonfly2_tpu_torch.cli.main" in spawn


def test_the_intended_divergences_of_the_manager(run_async, tmp_path,
                                                 monkeypatch):
    """What the manager slice leaves out, pinned: no cluster control
    tower (no ``service.cluster``, no ``Manager.ClusterView``, a
    keepalive's fleet frame dropped, ``note_admission_429`` recording
    nothing, no ``/debug/cluster*`` route); no ``/debug/*`` route on the
    REST API. As in JAX: ``prof.enabled`` (the default) installs the
    runtime observatory (a ``manager`` loop probe, released at stop) and
    the metrics server serves ``/debug/prof*``; a ``searcher_plugin``
    names a searcher of the plugin registry (an unknown one raises the
    JAX ``LookupError``). The image preheat's manifest fetch and the
    OAuth exchange run on ``http.client`` off the loop."""
    import asyncio
    import http.client
    import inspect

    from dragonfly2_tpu.manager import rpcserver as jrpc
    from dragonfly2_tpu.manager.client import ManagerClient as JClient
    from dragonfly2_tpu.manager.server import ManagerServer as JServer
    from dragonfly2_tpu.manager.service import ManagerService as JService
    from dragonfly2_tpu_torch.manager import (
        ManagerConfig,
        ManagerServer,
        oauth,
        preheat,
    )
    from dragonfly2_tpu_torch.manager import rpcserver as prpc
    from dragonfly2_tpu_torch.manager.client import ManagerClient
    from dragonfly2_tpu_torch.manager.service import ManagerService
    from dragonfly2_tpu_torch.pkg.types import NetAddr
    from dragonfly2_tpu_torch.rpc import Server

    jsvc, psvc = JService(), ManagerService()
    assert hasattr(jsvc, "cluster") and not hasattr(psvc, "cluster")
    assert psvc.note_admission_429("t") is None
    for name in ("ingest_fleet_frame", "note_frameless_keepalive"):
        assert hasattr(jsvc, name) and not hasattr(psvc, name)
    assert hasattr(JClient, "cluster_view")
    assert not hasattr(ManagerClient, "cluster_view")
    jm, pm = Server("j"), Server("p")
    jrpc.ManagerRpcServer(jsvc).register(jm)
    prpc.ManagerRpcServer(psvc).register(pm)
    assert set(jm._unary) - set(pm._unary) == {"Manager.ClusterView"}
    assert set(jm._stream) == set(pm._stream) == {"Manager.KeepAlive"}
    import textwrap

    import dragonfly2_tpu.pkg.dfplugin as jplugin
    import dragonfly2_tpu_torch.pkg.dfplugin as pplugin
    from dragonfly2_tpu_torch.pkg import prof as pprof

    (tmp_path / "df_plugin_s.py").write_text(textwrap.dedent("""
        PLUGIN_TYPE = "searcher"
        PLUGIN_NAME = "mine"

        def create():
            return "searcher-instance"
    """))
    monkeypatch.setenv("DRAGONFLY_PLUGIN_DIR", str(tmp_path))
    for mod in (jplugin, pplugin):
        monkeypatch.setattr(mod, "_default", mod.PluginRegistry())
    msgs = []
    for cls in (JService, ManagerService):
        with pytest.raises(LookupError) as e:
            cls(searcher_plugin="my-searcher")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "no searcher plugin named 'my-searcher'"
    assert ManagerService(searcher_plugin="mine").searcher == \
        "searcher-instance"
    assert "aiohttp." not in inspect.getsource(preheat)
    assert "http.client.HTTPConnection" in inspect.getsource(
        preheat._http_get_json)
    assert "to_thread" in inspect.getsource(preheat.get_image_layers)
    assert "to_thread" in inspect.getsource(oauth.OAuthFlow.exchange)
    assert "aiohttp." not in inspect.getsource(oauth)

    def get(port: int, path: str, token: str = "") -> int:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request("GET", path, headers={
                "Authorization": f"Bearer {token}"} if token else {})
            r = c.getresponse()
            r.read()
            return r.status
        finally:
            c.close()

    held = pprof.observatory()   # one another test left installed, if any

    async def run():
        server = ManagerServer(ManagerConfig.from_dict(
            {"prof": {"enabled": True}, "metrics_port": 0}))
        await server.start()
        try:
            assert server.prof_obs is pprof.observatory() is not None
            assert "manager" in server.prof_obs.probes
            token = psvc.signer.sign(1, "root", ["root"])
            server.service.signer = psvc.signer
            got = {}
            for path in ("/debug/cluster", "/debug/prof", "/metrics"):
                got["rest " + path] = await asyncio.to_thread(
                    get, server.rest_port, path, token)
                got["metrics " + path] = await asyncio.to_thread(
                    get, server.metrics_port(), path)
            # A keepalive carrying a fleet frame keeps the row alive and
            # nothing else.
            cli = ManagerClient(NetAddr.tcp("127.0.0.1", server.grpc_port()))
            reg = await cli.update_scheduler(hostname="s", ip="1.1.1.1")
            cli.start_keepalive(source_type="scheduler", hostname="s",
                                ip="1.1.1.1", cluster_id=1, interval=0.02,
                                payload=lambda: {"fleet_frame": {"x": 1}})
            row0 = server.db.get("schedulers", reg["id"])
            while server.db.get("schedulers", reg["id"])[
                    "last_keepalive_at"] == row0["last_keepalive_at"]:
                await asyncio.sleep(0.01)
            got["state"] = server.db.get("schedulers", reg["id"])["state"]
            await cli.close()
            return got
        finally:
            await server.stop()
            assert server.prof_obs is None
            assert pprof.observatory() is held

    assert run_async(run(), timeout=30) == {
        "rest /debug/cluster": 404, "metrics /debug/cluster": 404,
        "rest /debug/prof": 404, "metrics /debug/prof": 200,
        "rest /metrics": 200, "metrics /metrics": 200, "state": "active"}
    jserver = JServer()
    assert hasattr(jserver, "prof_obs")
    jserver.db.close()


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
