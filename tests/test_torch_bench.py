"""The port's device bench on the CPU, and the example twins.

The bench measures only on a CUDA card (``python -m
dragonfly2_tpu_torch.bench``, run through ``chip_smoke.py`` too); here it
is checked for what it does without one: its sink smoke on the CPU, no
metric and exit 2 without CUDA, a history that takes only verified card
runs, and launch accounting. The GPU twins of the JAX examples run with
``--device cpu`` in subprocesses, as ``tests/test_delta.py`` runs the JAX
hot-swap example; each asserts at its end that it imported no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from dragonfly2_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _line(**over) -> dict:
    line = {"value": 100.0, "vs_baseline": 200.0,
            "staged_host_to_hbm_gbps": 10.0,
            "staged_pinned_host_to_hbm_gbps": 50.0, "swap_verify_gbps": 90.0,
            "sink_smoke": "ok", "backend": "cuda",
            "device": "NVIDIA H100 80GB HBM3", "card": CARD}
    line.update(over)
    return line


def test_sink_smoke_on_the_cpu_is_ok():
    assert bench.sink_smoke(device="cpu") == "ok"


def test_sink_smoke_reports_a_corrupt_landing(monkeypatch):
    real = bench.HBMSink.land_piece

    def flip_a_bit(self, num, data):
        data = bytearray(data)
        if num == 3:
            data[5] ^= 1
        real(self, num, bytes(data))

    monkeypatch.setattr(bench.HBMSink, "land_piece", flip_a_bit)
    assert bench.sink_smoke(device="cpu") == "bytes mismatch"


def test_main_without_cuda_exits_2_and_prints_no_metric(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    history = tmp_path / "history.json"
    assert bench.main(["--history", str(history)]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
    assert not history.exists()


def test_module_run_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "dragonfly2_tpu_torch.bench",
                           "--history", os.devnull], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == "", proc.stderr[-2000:]


@pytest.mark.parametrize("bad", [
    {"device": ""}, {"card": ""}, {"backend": "cpu"}, {"sink_smoke": "failed"},
    {"device": None}])
def test_history_refuses_an_entry_without_a_cuda_card(tmp_path, bad):
    path = tmp_path / "history.json"
    entry = bench.history_entry(_line())
    entry.update(bad)
    with pytest.raises(ValueError, match="not a verified CUDA card run"):
        bench.record_history(entry, str(path))
    assert not path.exists()


def test_history_appends_verified_runs_and_keeps_the_last(tmp_path):
    path = tmp_path / "history.json"
    for i in range(bench.HISTORY_KEEP + 3):
        bench.record_history(bench.history_entry(_line(value=float(i))),
                             str(path))
    history = json.loads(path.read_text())
    assert len(history) == bench.HISTORY_KEEP
    assert [h["gbps"] for h in history][-1] == bench.HISTORY_KEEP + 2
    assert all(h["card"] == CARD and h["backend"] == "cuda" for h in history)
    assert not (tmp_path / "history.json.tmp").exists()


def test_history_refuses_a_file_that_is_not_a_list(tmp_path):
    path = tmp_path / "history.json"
    path.write_text('{"gbps": 1}')
    with pytest.raises(ValueError, match="does not hold a list"):
        bench.record_history(bench.history_entry(_line()), str(path))


def test_bench_sizes_are_the_jax_bench_sizes():
    import inspect

    import bench as jax_bench

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    assert (bench.LAND_MB, bench.PIECE_MB, bench.LAND_BATCH) == (
        default(jax_bench.bench_device_sink, "total_mb"),
        default(jax_bench.bench_device_sink, "piece_mb"),
        default(jax_bench.bench_device_sink, "batch_pieces"))
    assert bench.STAGE_MB == default(jax_bench.bench_staged_transfer,
                                     "total_mb")
    assert (bench.SWAP_MB, bench.PIECE_MB) == (
        default(jax_bench.bench_swap_verify, "total_mb"),
        default(jax_bench.bench_swap_verify, "piece_mb"))


def test_bench_launch_constants_follow_the_bench_sizes():
    """``chip_smoke.BENCH_LAUNCHES``, restated from the bench's sizes and
    ``device_time``'s calls (1 warm + n + 3 windows of n)."""
    timed = 1 + bench.TIMED_CALLS + 3 * bench.TIMED_CALLS
    batches = bench.LAND_MB // bench.PIECE_MB // bench.LAND_BATCH
    # The sink smoke: 3 K2 flushes, 2 K1 launches in its gate.
    assert chip_smoke.BENCH_LAUNCHES == {
        "land_and_checksum": (timed + 1) * batches + 3,
        "chunk_checksums": 1 + bench.GATE_ITERS + timed + 2}


def test_launch_counts_reads_both_wrappers(monkeypatch):
    from dragonfly2_tpu_torch.ops import checksum, gear

    monkeypatch.setattr(checksum.chunk_checksums, "launches", 5)
    monkeypatch.setattr(checksum.land_and_checksum, "launches", 7)
    monkeypatch.setattr(gear.gear_candidates, "launches", 3)
    assert checksum.launch_counts() == {"chunk_checksums": 5,
                                        "land_and_checksum": 7,
                                        "gear_candidates": 3}


def test_cpu_sha256_baseline_is_a_rate():
    assert bench.bench_cpu_sha256(b"\0" * (1 << 20), repeats=2) > 0


def test_chip_smoke_keeps_one_copy_of_the_timing_helpers():
    for name in ("device_time", "host_ms", "bound_ms", "card_bandwidth",
                 "smi_line"):
        assert getattr(chip_smoke, name) is getattr(bench, name), name
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "def device_time(" not in src and "def smi_line(" not in src


def test_chip_smoke_last_line_names_the_card():
    """The last line's ``kind`` is the name ``torch.cuda.get_device_name``
    gave, bound once in ``main`` and never rebound by a later loop."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    kinds = [v.id for d in ast.walk(main) if isinstance(d, ast.Dict)
             for k, v in zip(d.keys, d.values)
             if isinstance(k, ast.Constant) and k.value == "kind"]
    assert len(kinds) == 1
    bound = []
    for node in ast.walk(main):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.For) else [])
        for t in targets:
            bound += [n for n in ast.walk(t)
                      if isinstance(n, ast.Name) and n.id == kinds[0]]
    assert len(bound) == 1, f"{kinds[0]} bound {len(bound)} times in main"


def test_bench_bounds_follow_the_card():
    assert bench.card_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bench.card_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    # K2 over 512 MiB: every byte read once and written once.
    assert bench.bound_ms(2 * (512 << 20), 3.35e12) == pytest.approx(
        0.32051, rel=1e-4)


# ---------------------------------------------------------------------- #
# The example twins, on the CPU
# ---------------------------------------------------------------------- #

def _run_example(*args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_example_torch_checkpoint_hotswap_smoke():
    proc = _run_example(os.path.join("examples", "torch_checkpoint_hotswap.py"),
                        "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "serving generation 1 (checkpoint step 1" in proc.stdout
    assert "flipped to generation 2 (checkpoint step 2)" in proc.stdout, (
        proc.stdout)
    assert "copied device to device" in proc.stdout


def test_example_torch_pod_checkpoint_smoke():
    proc = _run_example(os.path.join("examples", "torch_pod_checkpoint.py"),
                        "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh={'dp': 1, 'tp': 1}" in proc.stdout
    assert "forward-pass exact: OK" in proc.stdout, proc.stdout
    assert "download_global: w2 pulled" in proc.stdout
    assert "bit-exact: OK" in proc.stdout


def test_example_torch_pod_checkpoint_without_the_fabric():
    proc = _run_example(os.path.join("examples", "torch_pod_checkpoint.py"),
                        "--device", "cpu", "--no-fabric")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "forward-pass exact: OK" in proc.stdout
    assert "download_global" not in proc.stdout
