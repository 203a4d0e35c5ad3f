"""Rules the PyTorch port keeps, and its small own copies.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package
  (checked in a subprocess, since ``tests/conftest.py`` imports jax into
  every test process, and by an AST scan of the sources).
- Its entry points run on the card unless told ``device="cpu"``: without
  CUDA they raise instead of quietly using the CPU.
- The kernels build with nvcc or raise with nvcc's output; nothing falls
  back to the plain versions.
- Its copies of the piece math and the counter registry agree with the
  JAX package's. Tolerance 0: these are integers.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from dragonfly2_tpu.pkg import piece as jax_piece
from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.client.device import swap_generation
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager
from dragonfly2_tpu_torch.dataset.device_feed import DeviceFeed
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink, assemble_delta_u8
from dragonfly2_tpu_torch.parallel.ici import make_mesh
from dragonfly2_tpu_torch.parallel.multihost import global_mesh
from dragonfly2_tpu_torch.pkg import metrics, piece

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dragonfly2_tpu_torch")


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
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
            "dragonfly2_tpu_torch.parallel.topology"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


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
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "absent.so"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()


def test_failed_compile_raises_with_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'checksum.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "build" / "k.so"))
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
