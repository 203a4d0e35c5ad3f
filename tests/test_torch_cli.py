"""The port's ``df`` CLI (``dragonfly2_tpu_torch/cli/``) and its client
libraries (``client/dfget.py``, ``client/dfcache.py``) against the JAX
package's.

- Parsers: the same argv through both packages' ``main`` (each role's
  server or client call replaced by a recorder) gives equal
  ``DaemonConfig``, ``SchedulerConfig``, ``ManagerConfig``,
  ``DfgetConfig`` and ``DfcacheConfig`` values, field by field
  (``--torch-device`` is the port's own, and ``--device cuda`` is sent as
  ``tpu``); the port's mapping functions give what its ``main`` builds;
  ``python -m dragonfly2_tpu_torch.manager`` parses the same flags. The
  usage errors (no ``-O``, no URL, no ``--path``, too few ``dfstore``
  arguments) exit with the JAX code and text.
- dfget against a daemon: the port CLI in a subprocess, cold (it spawns
  the port's daemon with ``--torch-device cpu``, which a SIGTERM stops
  cleanly) and then with ``--no-daemon`` against that daemon, and the
  JAX CLI against a JAX daemon, fetch the same ``file://`` and
  ``http://`` origins: the same bytes. Through the libraries: the same
  final-frame keys, ``recursive`` over a directory, the daemon-less
  fallback and its digest mismatch, and the refusal of that fallback for
  a device request; ``--explain`` prints the same QoS line.
- dfcache import, stat, export (on a second daemon, over P2P), delete
  and the stat after it, on a port scheduler with two port daemons and
  on a JAX scheduler with two JAX daemons: the same JSON, and the port's
  ``dfcache`` subcommand prints what its library returns.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dragonfly2_tpu.cli import main as jmain
from dragonfly2_tpu.client import dfcache as jdfcache
from dragonfly2_tpu.client import dfget as jdfget
from dragonfly2_tpu.daemon.config import DaemonConfig as JDaemonConfig
from dragonfly2_tpu.daemon.daemon import Daemon as JDaemon
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.proto.common import UrlMeta as JUrlMeta
from dragonfly2_tpu.scheduler.config import SchedulerConfig as JSchedConfig
from dragonfly2_tpu.scheduler.server import SchedulerServer as JSchedServer
from dragonfly2_tpu_torch.cli import extra as pextra
from dragonfly2_tpu_torch.cli import main as pmain
from dragonfly2_tpu_torch.client import dfcache as pdfcache
from dragonfly2_tpu_torch.client import dfget as pdfget
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTENT = hashlib.sha256(b"cli").digest() * 40_000          # 1.28 MB


# -- parsers ---------------------------------------------------------------

class Recorder:
    """Stands in for a role's server: records its config, serves nothing."""

    seen: list = []

    def __init__(self, cfg, **kw):
        Recorder.seen.append((cfg, kw))

    async def serve(self):
        return None

    async def stop(self):
        return None


def _record(monkeypatch, targets) -> list:
    Recorder.seen = []
    for mod, name in targets:
        monkeypatch.setattr(mod, name, Recorder)
    return Recorder.seen


@pytest.fixture
def json_configs(tmp_path):
    daemon = tmp_path / "daemon.json"
    daemon.write_text(json.dumps({
        "host": {"idc": "idc-1", "location": "l"},
        "download": {"report_batch": 7}, "tpu_sink": {"batch_pieces": 4}}))
    sched = tmp_path / "scheduler.json"
    sched.write_text(json.dumps({
        "scheduling": {"candidate_parent_limit": 3},
        "fleet": {"bucket_s": 2.0, "straggler_z": 2.5},
        "gc": {"peer_ttl": 99.0}}))
    return {"daemon": str(daemon), "scheduler": str(sched)}


DAEMON_ARGVS = [
    [],
    ["--seed-peer", "--scheduler", "10.0.0.1:8002", "--scheduler",
     "10.0.0.2:8002", "--manager", "10.0.0.9:65003"],
    ["--proxy-port", "0", "--registry-mirror", "https://r.example",
     "--hijack-https"],
    ["--proxy-port", "7001", "--alive-time", "30"],
    ["--object-storage-port", "0", "--object-storage-option", "root=/x",
     "--object-storage-option", "noequals", "--object-storage-option",
     "a=b=c"],
    ["--object-storage-port", "65004"],
    ["--object-storage-port", "0", "--object-storage-backend", "s3",
     "--object-storage-option", "bucket=b"],
    ["--pex-port", "0", "--pex-seed", "127.0.0.1:7100", "--pex-secret", "s"],
    ["--pex-seed", "127.0.0.1:7101"],
    ["--prefetch", "--device-sink", "--metrics-port", "9001",
     "--piece-concurrency", "3"],
    ["--metrics-port", "-1", "--piece-concurrency", "0"],
    ["--tpu-slice", "slice-3", "--tpu-worker-index", "2", "--hostname",
     "hh", "--clock-offset", "1.5"],
    ["--config", "@daemon", "--seed-peer"],
]


@pytest.mark.parametrize("argv", DAEMON_ARGVS, ids=lambda a: " ".join(a)
                         or "defaults")
@pytest.mark.parametrize("home", [True, False], ids=["work-home", "DF_HOME"])
def test_daemon_flags_build_the_jax_config(monkeypatch, tmp_path, argv, home,
                                           json_configs):
    import dragonfly2_tpu.daemon.daemon as jdaemon_mod
    import dragonfly2_tpu_torch.daemon.daemon as pdaemon_mod

    monkeypatch.setenv("DF_HOME", str(tmp_path / "env-home"))
    argv = [json_configs["daemon"] if a == "@daemon" else a for a in argv]
    if home:
        argv = argv + ["--work-home", str(tmp_path / "home")]
    seen = _record(monkeypatch, [(jdaemon_mod, "Daemon"),
                                 (pdaemon_mod, "Daemon")])
    assert jmain.main(["daemon", *argv]) == 0
    assert pmain.main(["daemon", *argv, "--torch-device", "cpu"]) == 0
    (jcfg, jkw), (pcfg, pkw) = seen
    assert asdict(pcfg) == asdict(jcfg)
    assert jkw == {} and pkw == {"device": "cpu"}
    mapped = pmain.daemon_config(
        pmain.build_parser().parse_args(["daemon", *argv]))
    assert asdict(mapped) == asdict(pcfg)


SCHEDULER_ARGVS = [
    [],
    ["--host", "0.0.0.0", "--port", "0", "--manager", "10.0.0.9:65003",
     "--metrics-port", "9002"],
    ["--config", "@scheduler", "--port", "8100"],
]


@pytest.mark.parametrize("argv", SCHEDULER_ARGVS,
                         ids=lambda a: " ".join(a) or "defaults")
def test_scheduler_flags_build_the_jax_config(monkeypatch, argv,
                                              json_configs):
    import dragonfly2_tpu.scheduler.server as jserver_mod
    import dragonfly2_tpu_torch.scheduler.server as pserver_mod

    argv = [json_configs["scheduler"] if a == "@scheduler" else a
            for a in argv]
    seen = _record(monkeypatch, [(jserver_mod, "SchedulerServer"),
                                 (pserver_mod, "SchedulerServer")])
    assert jmain.main(["scheduler", *argv]) == 0
    assert pmain.main(["scheduler", *argv]) == 0
    (jcfg, _), (pcfg, _) = seen
    assert asdict(pcfg) == asdict(jcfg)
    # With no --config the fleet is on, as the JAX defaults have it.
    assert pcfg.fleet.enabled
    assert asdict(pextra.scheduler_config(pmain.build_parser().parse_args(
        ["scheduler", *argv]))) == asdict(pcfg)


MANAGER_ARGVS = [
    [],
    ["--host", "0.0.0.0", "--port", "18080", "--grpc-port", "18065",
     "--db", "/tmp/m.db", "--metrics-port", "-1", "--keepalive-timeout",
     "5", "--keepalive-gc-interval", "2.5"],
]


@pytest.mark.parametrize("argv", MANAGER_ARGVS,
                         ids=lambda a: " ".join(a) or "defaults")
def test_manager_flags_build_the_jax_config(monkeypatch, argv):
    import dragonfly2_tpu.manager.server as jserver_mod
    import dragonfly2_tpu_torch.manager.server as pserver_mod
    from dragonfly2_tpu_torch.manager import __main__ as pmanager_main

    seen = _record(monkeypatch, [(jserver_mod, "ManagerServer"),
                                 (pserver_mod, "ManagerServer")])
    assert jmain.main(["manager", *argv]) == 0
    assert pmain.main(["manager", *argv]) == 0
    # The module entry point parses the same flags, defined once.
    assert pmanager_main.main(argv) == 0
    (jcfg, _), (pcfg, _), (mcfg, _) = seen
    assert asdict(pcfg) == asdict(jcfg) == asdict(mcfg)


DFGET_ARGVS = [
    ["http://o/x", "-O", "out.bin"],
    ["file:///data/x", "-O", "o", "--tag", "t", "--application", "app",
     "--tenant", "team", "--priority", "5", "--digest", "sha256:" + "a" * 64,
     "--filter", "sig&exp", "--range", "0-99", "--header", "A: 1",
     "--header", "B:2:3", "--disable-back-source", "--pod-broadcast",
     "--delta-base", "base-id", "--explain", "--pod", "--recursive",
     "--level", "2", "--timeout", "9.5"],
    ["http://o/y", "--device", "tpu"],
    ["http://o/y", "--device", "tpu", "-O", "y", "--no-daemon",
     "--scheduler", "10.0.0.1:8002", "--manager", "10.0.0.9:65003"],
]


class _DownloadRecorder:
    def __init__(self):
        self.cfgs = []

    async def download(self, cfg, on_progress=None):
        self.cfgs.append(cfg)
        if on_progress is not None:
            on_progress({"state": "running", "completed_length": 5,
                         "content_length": 10})
        return {"state": "done", "task_id": "f" * 64,
                "completed_length": 10, "from_p2p": True,
                "device_verified": True}

    @staticmethod
    async def alive(sock):
        return True


def _dfget_both(monkeypatch, capsys, argv, port_extra=()):
    out = {}
    for name, mod, main in (("jax", jdfget, jmain), ("port", pdfget, pmain)):
        rec = _DownloadRecorder()
        monkeypatch.setattr(mod, "download", rec.download)
        monkeypatch.setattr(mod, "is_daemon_alive", rec.alive)
        extra = list(port_extra) if name == "port" else []
        rc = main.main(["dfget", *argv, *extra])
        err = capsys.readouterr().err
        out[name] = (rc, rec.cfgs, err)
    return out


def _summary(err: str) -> str:
    line = err.strip().splitlines()[-1].split("\r")[-1]
    return re.sub(r"in [0-9.]+s \([^)]*\)", "in <t>", line)


@pytest.mark.parametrize("argv", DFGET_ARGVS, ids=lambda a: " ".join(a[1:]))
def test_dfget_flags_build_the_jax_config(monkeypatch, tmp_path, capsys,
                                          argv):
    monkeypatch.setenv("DF_HOME", str(tmp_path / "env-home"))
    out = _dfget_both(monkeypatch, capsys, argv)
    (jrc, jcfgs, jerr), (prc, pcfgs, perr) = out["jax"], out["port"]
    assert prc == jrc == 0
    assert len(jcfgs) == len(pcfgs) == 1
    assert asdict(pcfgs[0]) == asdict(jcfgs[0])
    assert _summary(perr) == _summary(jerr)
    assert asdict(pmain.dfget_config(pmain.build_parser().parse_args(
        ["dfget", *argv]))) == asdict(pcfgs[0])


def test_dfget_device_cuda_is_sent_as_tpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("DF_HOME", str(tmp_path / "env-home"))
    rec = _DownloadRecorder()
    monkeypatch.setattr(pdfget, "download", rec.download)
    monkeypatch.setattr(pdfget, "is_daemon_alive", rec.alive)
    assert pmain.main(["dfget", "http://o/y", "--device", "cuda"]) == 0
    out = _dfget_both(monkeypatch, capsys, ["http://o/y", "--device", "tpu"])
    assert rec.cfgs[0].device == "tpu"
    assert asdict(rec.cfgs[0]) == asdict(out["jax"][1][0])


DFCACHE_ARGVS = [
    ["stat", "ckpt-1"],
    ["delete", "ckpt-1", "--tag", "t", "--application", "a",
     "--timeout", "5"],
    ["import", "ckpt-2", "--path", "/x", "--persistent", "--replica-count",
     "3", "--ttl", "60"],
    ["export", "ckpt-2", "--output", "/y"],
]


@pytest.mark.parametrize("argv", DFCACHE_ARGVS, ids=lambda a: " ".join(a))
def test_dfcache_flags_build_the_jax_config(monkeypatch, tmp_path, capsys,
                                            argv):
    argv = argv + ["--work-home", str(tmp_path / "h")]
    out = {}
    for name, mod, main in (("jax", jdfcache, jmain),
                            ("port", pdfcache, pmain)):
        calls = []

        def fake(op):
            async def call(cfg, *a, **kw):
                calls.append((op, cfg, a, kw))
                return {"op": op, "ok": True}
            return call

        for op in ("import_file", "export_file", "stat", "delete"):
            monkeypatch.setattr(mod, op, fake(op))
        rc = main.main(["dfcache", *argv])
        out[name] = (rc, calls, capsys.readouterr().out)
    (jrc, jcalls, jout), (prc, pcalls, pout) = out["jax"], out["port"]
    assert prc == jrc == 0 and pout == jout
    ((jop, jcfg, ja, jkw),), ((pop, pcfg, pa, pkw),) = jcalls, pcalls
    assert (pop, pa, pkw) == (jop, ja, jkw)
    assert asdict(pcfg) == asdict(jcfg)
    assert asdict(pextra.dfcache_config(pmain.build_parser().parse_args(
        ["dfcache", *argv]))) == asdict(pcfg)


@pytest.mark.parametrize("argv", [
    ["dfget", "http://o/x"],
    ["dfcache", "import", "c1"],
    ["dfcache", "export", "c1"],
    ["dfstore", "cp", "a"],
    ["dfstore", "stat"],
])
def test_usage_errors_exit_as_in_jax(monkeypatch, tmp_path, capsys, argv):
    monkeypatch.setenv("DF_HOME", str(tmp_path / "env-home"))
    got = {}
    for name, main in (("jax", jmain), ("port", pmain)):
        rc = main.main(list(argv))
        cap = capsys.readouterr()
        got[name] = (rc, cap.out, cap.err)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2


@pytest.mark.parametrize("argv", [
    ["dfget"], ["daemon", "--proxy-port", "x"], ["dfcache", "stat"],
    ["scheduler", "--port", "p"], ["dfstore", "mv"], [],
])
def test_argument_errors_exit_as_in_jax(capsys, argv):
    got = {}
    for name, main in (("jax", jmain), ("port", pmain)):
        with pytest.raises(SystemExit) as e:
            main.main(list(argv))
        err = capsys.readouterr().err
        # The usage lines list each parser's options (the port has
        # --torch-device): the error line is what must agree.
        got[name] = (e.value.code, err.strip().splitlines()[-1])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2


# -- dfget against daemons -------------------------------------------------

class _Origin(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _answer(self, body: bool):
        data = self.server.files.get(self.path)
        if data is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        start, end = 0, len(data) - 1
        rng = self.headers.get("Range")
        if rng:
            a, _, b = rng.split("=", 1)[1].partition("-")
            start = int(a) if a else len(data) - int(b)
            end = min(int(b), len(data) - 1) if (a and b) else len(data) - 1
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{end}/{len(data)}")
        else:
            self.send_response(200)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(end - start + 1))
        self.end_headers()
        if body:
            self.wfile.write(data[start:end + 1])

    def do_GET(self):
        self._answer(True)

    def do_HEAD(self):
        self._answer(False)


@pytest.fixture
def origin():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Origin)
    srv.files = {"/model.bin": CONTENT}
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="df-test-origin")
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _daemon_dict(home: str, name: str, **over) -> dict:
    d = {"work_home": home, "host": {"hostname": name, "ip": "127.0.0.1"},
         "metrics_port": -1, "gc_interval": 3600,
         "download": {"piece_concurrency": 1,
                      "concurrent_min_length": 1 << 40}}
    d.update(over)
    return d


def _port_cli(args, timeout=120) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cli.main", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _gone(pid: int, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


def test_a_cold_dfget_spawns_the_port_daemon_and_fetches_as_jax(
        tmp_path, origin, run_async):
    base, _srv = origin
    src = tmp_path / "src.bin"
    src.write_bytes(CONTENT)
    file_url = f"file://{src}"
    http_url = f"{base}/model.bin"
    home = str(tmp_path / "cold")
    # Cold: no daemon on the socket, so dfget spawns the port's.
    cold = _port_cli(["dfget", file_url, "-O", str(tmp_path / "p-file"),
                      "--work-home", home, "--torch-device", "cpu"])
    assert cold.returncode == 0, cold.stderr[-3000:]
    pid = int(re.search(r"spawned daemon .*pid=(\d+)", cold.stderr).group(1))
    try:
        warm = _port_cli(["dfget", http_url, "-O", str(tmp_path / "p-http"),
                          "--work-home", home, "--no-daemon", "--digest",
                          "sha256:" + hashlib.sha256(CONTENT).hexdigest()])
        assert warm.returncode == 0, warm.stderr[-3000:]
        assert "spawned daemon" not in warm.stderr
        assert "downloaded 1.22MiB" in warm.stderr
    finally:
        os.kill(pid, signal.SIGTERM)
    assert _gone(pid, 30)
    with open(os.path.join(home, "logs", "daemon-spawn.log")) as f:
        spawn_log = f.read()
    assert "daemon up" in spawn_log and "Traceback" not in spawn_log

    # The JAX CLI against a JAX daemon on its own work home.
    jhome = str(tmp_path / "jax")

    async def jax_side():
        d = JDaemon(JDaemonConfig.from_dict(_daemon_dict(jhome, "j")))
        await d.start()
        try:
            for url, out in ((file_url, "j-file"), (http_url, "j-http")):
                rc = await asyncio.to_thread(jmain.main, [
                    "dfget", url, "-O", str(tmp_path / out),
                    "--work-home", jhome, "--no-daemon"])
                assert rc == 0
        finally:
            await d.stop()

    run_async(jax_side(), timeout=120)
    for name in ("p-file", "p-http", "j-file", "j-http"):
        assert (tmp_path / name).read_bytes() == CONTENT, name


def test_the_daemon_without_a_card_raises(tmp_path):
    """``--torch-device`` defaults to cuda and nothing falls back: on a
    machine without CUDA the daemon does not start."""
    proc = _port_cli(["daemon", "--work-home", str(tmp_path / "h"),
                      "--metrics-port", "-1"], timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


async def _library_runs(pkg: str, home: str, tmp_path, base: str) -> dict:
    lib, cfg_cls, meta_cls, err_cls = (
        (jdfget, jdfget.DfgetConfig, JUrlMeta, JDfError) if pkg == "jax"
        else (pdfget, pdfget.DfgetConfig, UrlMeta, DfError))
    d_dict = _daemon_dict(home, pkg)
    d = (JDaemon(JDaemonConfig.from_dict(d_dict)) if pkg == "jax"
         else Daemon(DaemonConfig.from_dict(d_dict), device="cpu"))
    tree = tmp_path / "tree"
    sha = "sha256:" + hashlib.sha256(CONTENT).hexdigest()
    out = {}
    await d.start()
    try:
        sock = d.config.unix_sock
        for name, url in (("file", f"file://{tmp_path / 'src.bin'}"),
                          ("http", f"{base}/model.bin")):
            dest = tmp_path / f"{pkg}-lib-{name}"
            frames = []
            final = await lib.download(cfg_cls(
                url=url, output=str(dest), daemon_sock=sock,
                meta=meta_cls(digest=sha)), frames.append)
            out[name] = (sorted(final), final["state"],
                         final["completed_length"],
                         dest.read_bytes() == CONTENT,
                         sorted({f["state"] for f in frames}))
        rdest = tmp_path / f"{pkg}-tree"
        res = await lib.download(cfg_cls(
            url=f"file://{tree}", output=str(rdest), daemon_sock=sock,
            recursive=True, level=1))
        out["recursive"] = (res, sorted(
            os.path.relpath(os.path.join(r, f), rdest)
            for r, _, fs in os.walk(rdest) for f in fs))
    finally:
        await d.stop()
    dead = str(tmp_path / f"{pkg}-nobody.sock")
    fb = tmp_path / f"{pkg}-fallback"
    out["fallback"] = await lib.download(cfg_cls(
        url=f"{base}/model.bin", output=str(fb), daemon_sock=dead,
        meta=meta_cls(digest="sha256:" + hashlib.sha256(
            CONTENT[:100]).hexdigest(), range="0-99")))
    out["fallback_bytes"] = fb.read_bytes() == CONTENT[:100]
    bad = tmp_path / f"{pkg}-bad"
    with pytest.raises(err_cls) as e:
        await lib.download(cfg_cls(
            url=f"{base}/model.bin", output=str(bad), daemon_sock=dead,
            meta=meta_cls(digest="sha256:" + "0" * 64)))
    out["mismatch"] = (int(e.value.code),
                       e.value.message, bad.exists())
    with pytest.raises(err_cls) as e:
        await lib.download(cfg_cls(
            url=f"{base}/model.bin", output=str(tmp_path / f"{pkg}-dev"),
            daemon_sock=dead, device="tpu"))
    out["device_refused"] = int(e.value.code)
    out["alive_dead"] = await lib.is_daemon_alive(dead)
    return out


def test_the_libraries_fetch_alike(tmp_path, origin, run_async):
    base, srv = origin
    (tmp_path / "src.bin").write_bytes(CONTENT)
    tree = tmp_path / "tree"
    (tree / "sub" / "deeper").mkdir(parents=True)
    (tree / "a.bin").write_bytes(CONTENT[:1000])
    (tree / "sub" / "b.bin").write_bytes(CONTENT[:5000])
    (tree / "sub" / "deeper" / "c.bin").write_bytes(CONTENT[:7])
    srv.files["/model.bin"] = CONTENT
    j = run_async(_library_runs("jax", str(tmp_path / "jh"), tmp_path,
                                base), timeout=120)
    p = run_async(_library_runs("port", str(tmp_path / "ph"), tmp_path,
                                base), timeout=120)
    assert p == j
    assert p["file"][1:] == ("done", len(CONTENT), True, ["done", "running"])
    assert p["recursive"][1] == ["a.bin", "sub/b.bin"]
    assert p["fallback"]["from_source"] and p["fallback_bytes"]
    assert p["mismatch"][2] is False and "digest mismatch" in p["mismatch"][1]
    assert p["device_refused"] == 4007 and p["alive_dead"] is False


def test_explain_prints_the_jax_qos_line(tmp_path, origin, run_async,
                                         capsys):
    base, _ = origin

    async def run(pkg):
        home = str(tmp_path / f"{pkg}-x")
        d_dict = _daemon_dict(home, pkg)
        d = (JDaemon(JDaemonConfig.from_dict(d_dict)) if pkg == "jax"
             else Daemon(DaemonConfig.from_dict(d_dict), device="cpu"))
        main = jmain if pkg == "jax" else pmain
        await d.start()
        try:
            rc = await asyncio.to_thread(main.main, [
                "dfget", f"{base}/model.bin", "-O",
                str(tmp_path / f"{pkg}-x.bin"), "--work-home", home,
                "--no-daemon", "--explain", "--tenant", "Team-A",
                "--priority", "6"])
        finally:
            await d.stop()
        err = capsys.readouterr().err
        return rc, [ln for ln in err.splitlines() if ln.startswith("qos:")]

    port, jax = run_async(run("port")), run_async(run("jax"))
    assert port == jax
    assert port[0] == 0 and len(port[1]) == 1
    assert "class=interactive (priority=6)" in port[1][0]


# -- dfcache ---------------------------------------------------------------

def _mask_cache(v):
    if isinstance(v, dict):
        return {k: _mask_cache(x) for k, x in v.items()
                if k not in ("peer_id", "cost_ms", "wall_s", "elapsed_s",
                             "output", "path")}
    if isinstance(v, (list, tuple)):
        return [_mask_cache(x) for x in v]
    return v


async def _cache_world(pkg: str, tmp_path, capsys_read=None) -> list:
    if pkg == "jax":
        cfg = JSchedConfig()
        cfg.podlens.enabled = False
        sched_cls, d_cls, d_cfg, lib, err = (
            JSchedServer, JDaemon, JDaemonConfig, jdfcache, JDfError)
    else:
        cfg = SchedulerConfig()
        sched_cls, d_cls, d_cfg, lib, err = (
            SchedulerServer, Daemon, DaemonConfig, pdfcache, DfError)
    cfg.server.port = 0
    cfg.metrics_port = -1
    cfg.scheduling.retry_interval = 0.05
    cfg.gc.interval = 3600
    sched = sched_cls(cfg)
    await sched.start()
    daemons = []
    for name in ("a", "b"):
        d_dict = _daemon_dict(str(tmp_path / f"{pkg}-{name}"), f"{pkg}-{name}",
                              scheduler={"addrs": [f"127.0.0.1:{sched.port()}"]})
        d = (d_cls(d_cfg.from_dict(d_dict)) if pkg == "jax"
             else d_cls(d_cfg.from_dict(d_dict), device="cpu"))
        await d.start()
        daemons.append(d)
    a, b = daemons
    src = tmp_path / "cache-src.bin"
    src.write_bytes(CONTENT)
    log = []
    try:
        ca = lib.DfcacheConfig(daemon_sock=a.config.unix_sock,
                               cache_id="ckpt-v1", tag="t")
        cb = lib.DfcacheConfig(daemon_sock=b.config.unix_sock,
                               cache_id="ckpt-v1", tag="t")
        log.append(("task_id", lib.task_id_of(ca)))
        log.append(("import", await lib.import_file(ca, str(src))))
        log.append(("stat", await lib.stat(ca)))
        out = tmp_path / f"{pkg}-exported.bin"
        log.append(("export", await lib.export_file(cb, str(out))))
        log.append(("exported", out.read_bytes() == CONTENT))
        log.append(("delete", await lib.delete(ca)))
        with pytest.raises(err) as e:
            await lib.stat(ca)
        log.append(("stat gone", int(e.value.code), e.value.message))
        with pytest.raises(err) as e:
            await lib.export_file(lib.DfcacheConfig(
                daemon_sock=b.config.unix_sock, cache_id="never",
                timeout=20), str(tmp_path / f"{pkg}-never"))
        log.append(("export missing", int(e.value.code)))
        if pkg == "port":
            # The subcommand prints what the library returns.
            rc = await asyncio.to_thread(pmain.main, [
                "dfcache", "stat", "ckpt-v1", "--tag", "t", "--work-home",
                str(tmp_path / "port-b")])
            log.append(("cli stat", rc, json.loads(capsys_read().out),
                        await lib.stat(cb)))
    finally:
        for d in daemons:
            await d.stop()
        await sched.stop()
    return log


def test_dfcache_answers_as_jax(tmp_path, run_async, capsys):
    j = run_async(_cache_world("jax", tmp_path), timeout=120)
    p = run_async(_cache_world("port", tmp_path, capsys.readouterr),
                  timeout=120)
    cli = p.pop()
    assert _mask_cache(p) == _mask_cache(j)
    assert ("exported", True) in p
    assert cli[1] == 0 and cli[2] == cli[3]
