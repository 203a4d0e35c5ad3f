"""The slice as a whole: the port's ``DeviceSinkManager`` inside the
reference daemon, against a daemon that lands with the JAX sink.

The reference ``Daemon`` is built with ``tpu_sink.enabled=False`` and the
port's manager (``device="cpu"``) is set as its task manager's
``device_sinks``. A safetensors object is pulled through the P2P machinery
with the JAX package's ``client.device.download_to_device``; the landed
bytes and the named tensors must equal those a second daemon lands with
the JAX sink. Eviction, disk-only degradation, corruption and the stale
rebuild mirror ``tests/test_device_sink.py``. Tolerance 0: byte equality.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from dragonfly2_tpu.client import device as device_lib
from dragonfly2_tpu.client import dfget as dfget_lib
from dragonfly2_tpu.daemon.daemon import Daemon
from dragonfly2_tpu.pkg.testing import start_range_origin
from dragonfly2_tpu_torch.daemon.peer import device_sink as pds
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops import hbm_sink as phbm
from dragonfly2_tpu_torch.ops import safetensors as pst
from tests.test_p2p_e2e import daemon_config, start_scheduler
from tests.test_safetensors import make_safetensors


def _checkpoint() -> tuple[dict, bytes]:
    """~5 MiB: two 4 MiB pieces, the second one short."""
    rng = np.random.default_rng(17)
    tensors = {
        "model.embed": rng.standard_normal((512, 2048)).astype(np.float32),
        "model.w_bf16": rng.integers(0, 1 << 16, (1024, 512), np.uint16),
        "model.norm": rng.standard_normal(4096).astype(np.float16),
        "model.step": np.array([7], np.int32),
    }
    dtypes = {"model.embed": "F32", "model.w_bf16": "BF16",
              "model.norm": "F16", "model.step": "I32"}
    return tensors, make_safetensors(tensors, dtypes)


async def _port_daemon(tmp_path, name, sched_port, **mgr_kwargs):
    cfg = daemon_config(tmp_path, name, sched_port)
    cfg.tpu_sink.enabled = False
    d = Daemon(cfg)
    d.task_manager.device_sinks = pds.DeviceSinkManager(device="cpu",
                                                        **mgr_kwargs)
    await d.start()
    return d


async def _jax_daemon(tmp_path, name, sched_port):
    cfg = daemon_config(tmp_path, name, sched_port)
    cfg.tpu_sink.enabled = True
    d = Daemon(cfg)
    await d.start()
    return d


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(-1).view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


def test_port_sink_pull_matches_jax_sink(run_async, tmp_path):
    """A checkpoint pulled into the port's sink through the reference
    daemon lands byte-identical to the JAX sink's landing, and the named
    tensors are bit-equal."""
    tensors, ckpt = _checkpoint()

    async def body():
        runner, url, _ = await start_range_origin(ckpt)
        sched = await start_scheduler()
        daemons = []
        try:
            port_d = await _port_daemon(tmp_path, "port", sched.port())
            daemons.append(port_d)
            landed_before = pds.SINK_LANDED_BYTES.value()
            ok_before = pds.SINK_VERIFY_COUNT.value("ok")
            port_r = await device_lib.download_to_device(port_d, url)
            assert isinstance(port_r.sink, pds.TaskDeviceSink)
            assert port_r.sink.verified and len(port_r.sink.landed) == 2
            port_bytes = port_r.as_bytes_array().numpy().tobytes()
            assert port_bytes == ckpt
            assert pds.SINK_LANDED_BYTES.value() - landed_before == len(ckpt)
            assert pds.SINK_VERIFY_COUNT.value("ok") == ok_before + 1

            jax_d = await _jax_daemon(tmp_path, "jax", sched.port())
            daemons.append(jax_d)
            jax_r = await device_lib.download_to_device(jax_d, url)
            assert np.asarray(jax_r.as_bytes_array()).tobytes() == port_bytes

            got = pst.load_from_sink(port_r.sink)
            want = jax_r.load_safetensors()
            assert set(got) == set(want) == set(tensors)
            for name in tensors:
                np.testing.assert_array_equal(_bits(got[name]),
                                              _bits(want[name]), name)
            assert got["model.w_bf16"].dtype == torch.bfloat16
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=120)


def test_single_piece_with_odd_length_lands(run_async, tmp_path):
    """A single-piece task whose length is not a word multiple: the piece
    size rounds up to 4 bytes and the padding is checksum-neutral."""
    content = random.Random(5).randbytes(1001)

    async def body():
        runner, url, _ = await start_range_origin(content)
        sched = await start_scheduler()
        d = await _port_daemon(tmp_path, "odd", sched.port())
        try:
            r = await device_lib.download_to_device(d, url)
            assert r.sink.sink.piece_size % 4 == 0
            assert r.as_bytes_array().numpy().tobytes() == content
            t = r.as_tensor("uint8", [1001])
            assert t.numpy().tobytes() == content
        finally:
            await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=60)


def test_sink_cap_degrades_to_disk(run_async, tmp_path):
    """No sink fits (max_tasks=0): the request completes from disk with
    device_verified=False rather than failing."""
    content = random.Random(6).randbytes(3 * 1024 * 1024 + 17)

    async def body():
        runner, url, _ = await start_range_origin(content)
        sched = await start_scheduler()
        d = await _port_daemon(tmp_path, "capped", sched.port(), max_tasks=0)
        try:
            r = await dfget_lib.download(dfget_lib.DfgetConfig(
                url=url, output=str(tmp_path / "o"),
                daemon_sock=d.config.unix_sock, device="tpu",
                allow_source_fallback=False, timeout=60.0))
            assert r["state"] == "done"
            assert not r["device_verified"]
            assert (tmp_path / "o").read_bytes() == content
        finally:
            await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=60)


def test_device_corruption_fails_request_but_not_store(run_async, tmp_path):
    """A corrupt device copy fails the requesting pull only; the disk
    store stays valid and serves the next request from reuse. Divergence
    at the seam: the reference task manager maps only its own package's
    DeviceSinkError to a DfError, so the port's error reaches the caller
    as the port's DeviceSinkError."""
    content = random.Random(7).randbytes(2 * 1024 * 1024)

    async def body():
        runner, url, _ = await start_range_origin(content)
        sched = await start_scheduler()
        d = await _port_daemon(tmp_path, "corrupt", sched.port())
        try:
            async def bad_finalize(task_id, store):
                raise pds.DeviceSinkError("piece 0 corrupt in HBM: injected")

            d.task_manager.device_sinks.finalize = bad_finalize
            with pytest.raises(pds.DeviceSinkError, match="piece 0"):
                await device_lib.download_to_device(d, url)
            r = await dfget_lib.download(dfget_lib.DfgetConfig(
                url=url, output=str(tmp_path / "o"),
                daemon_sock=d.config.unix_sock,
                allow_source_fallback=False, timeout=60.0))
            assert r["state"] == "done" and r["from_reuse"]
            assert (tmp_path / "o").read_bytes() == content
        finally:
            await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=60)


def test_resident_sinks_evict_for_new_landing(run_async, tmp_path):
    """Verified, unclaimed residents yield to a new landing, oldest first."""
    content = random.Random(8).randbytes(256 * 1024)

    async def body():
        runner, url, _ = await start_range_origin(content)
        sched = await start_scheduler()
        d = await _port_daemon(tmp_path, "evict", sched.port(), max_tasks=2)
        sinks = d.task_manager.device_sinks
        sinks.claim_grace_s = 0.0
        try:
            r1 = await device_lib.download_to_device(
                d, url, range_header="0-65535", claim=False)
            r2 = await device_lib.download_to_device(
                d, url, range_header="65536-131071", claim=False)
            assert sinks.get(r1.task_id) is not None
            assert sinks.get(r2.task_id) is not None
            r3 = await device_lib.download_to_device(
                d, url, range_header="131072-196607", claim=False)
            assert (r3.as_bytes_array().numpy().tobytes()
                    == content[131072:196608])
            assert sinks.get(r1.task_id) is None, "oldest must be evicted"
            assert sinks.get(r2.task_id) is not None
        finally:
            await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=60)


def test_stale_sink_rebuilt_when_store_content_changed(run_async, tmp_path):
    """A resident sink whose piece digests no longer match the store is
    rebuilt from the store, never verified as a mixed buffer."""

    async def body():
        from dragonfly2_tpu.storage.local_store import (
            LocalTaskStore,
            TaskStoreMetadata,
        )

        piece = 256 * 1024
        old = random.Random(3).randbytes(piece * 2)
        new = random.Random(4).randbytes(piece * 2)
        store = LocalTaskStore(
            str(tmp_path / "t1"),
            TaskStoreMetadata(task_id="t-stale", content_length=piece * 2,
                              piece_size=piece, total_piece_count=2))
        store.write_piece(0, new[:piece])
        store.write_piece(1, new[piece:])
        mgr = pds.DeviceSinkManager(device="cpu")
        try:
            sink = mgr._create("t-stale", piece * 2, piece)
            sink.land(0, old[:piece], "md5:stale-digest-0")
            sink.land(1, old[piece:], "md5:stale-digest-1")
            result = await mgr.finalize("t-stale", store)
            assert result is not None and result.verified
            assert result.as_bytes_array().numpy().tobytes() == new
        finally:
            mgr.close()

    run_async(body(), timeout=60)


def _two_piece_store(tmp_path, task_id: str):
    from dragonfly2_tpu.storage.local_store import (
        LocalTaskStore,
        TaskStoreMetadata,
    )

    piece = 256 * 1024
    data = random.Random(9).randbytes(piece * 2)
    store = LocalTaskStore(
        str(tmp_path / task_id),
        TaskStoreMetadata(task_id=task_id, content_length=piece * 2,
                          piece_size=piece, total_piece_count=2))
    store.write_piece(0, data[:piece])
    store.write_piece(1, data[piece:])
    return store


@pytest.mark.parametrize("stage", ["on_piece", "finalize"])
def test_kernel_fault_propagates_instead_of_degrading(run_async, tmp_path,
                                                      monkeypatch, stage):
    """A failed kernel launch fails the landing loudly, out of both
    on_piece and finalize; it never becomes a quiet disk-only result."""
    store = _two_piece_store(tmp_path, "t-fault")

    def failed_launch(*args):
        raise _build.KernelLaunchError("land_and_checksum: injected")

    monkeypatch.setattr(phbm, "land_and_checksum", failed_launch)

    async def body():
        mgr = pds.DeviceSinkManager(device="cpu", batch_pieces=1)
        try:
            with pytest.raises(_build.KernelLaunchError, match="injected"):
                if stage == "on_piece":
                    await mgr.on_piece("t-fault", store,
                                       store.metadata.pieces[0])
                else:
                    await mgr.finalize("t-fault", store)
            assert mgr.get("t-fault") is None
        finally:
            mgr.close()

    run_async(body(), timeout=60)


@pytest.mark.parametrize("stage", ["on_piece", "finalize"])
def test_environment_fault_degrades_to_disk_only(run_async, tmp_path,
                                                 monkeypatch, stage):
    """An environment fault (device out of memory) in the same place
    degrades the task to disk-only: finalize returns None."""
    store = _two_piece_store(tmp_path, "t-oom")

    def out_of_memory(*args):
        raise torch.OutOfMemoryError("CUDA out of memory: injected")

    monkeypatch.setattr(phbm, "land_and_checksum", out_of_memory)

    async def body():
        mgr = pds.DeviceSinkManager(device="cpu", batch_pieces=1)
        try:
            if stage == "on_piece":
                await mgr.on_piece("t-oom", store, store.metadata.pieces[0])
            assert await mgr.finalize("t-oom", store) is None
            assert mgr.get("t-oom") is None
        finally:
            mgr.close()

    run_async(body(), timeout=60)


def test_corrupt_device_copy_fails_verification():
    piece = 256 * 1024
    data0 = random.Random(1).randbytes(piece)
    data1 = random.Random(2).randbytes(piece)
    sink = pds.TaskDeviceSink("t-corrupt", piece * 2, piece, device="cpu")
    sink.land(0, data0)
    # Record piece 1's checksum for DIFFERENT bytes than land.
    sink.sink.host_checksums[1] = (0x12345678, 0x9ABCDEF0)
    sink.sink.landed.add(1)
    sink.sink._pending.append((1, np.frombuffer(data1, dtype="<u4")))
    corrupt_before = pds.SINK_VERIFY_COUNT.value("corrupt")
    with pytest.raises(pds.DeviceSinkError, match="piece 1"):
        sink.verify()
    assert pds.SINK_VERIFY_COUNT.value("corrupt") == corrupt_before + 1
    assert not sink.verified


def test_misaligned_multi_piece_task_refused():
    with pytest.raises(pds.DeviceSinkError, match="aligned"):
        pds.TaskDeviceSink("t", 3000, 1001, device="cpu")


def test_manager_lifecycle_protect_take_discard_gc():
    mgr = pds.DeviceSinkManager(device="cpu", max_tasks=1)
    try:
        a = mgr._create("a", 1024, 256)
        a.verified, a.verified_at = True, 0.0
        mgr.protect("a")
        assert mgr._create("b", 1024, 256) is None     # protected: no room
        mgr.unprotect("a")
        assert mgr._create("b", 1024, 256) is not None  # evicts a
        assert mgr.get("a") is None
        assert mgr.take("b") is not None and mgr.get("b") is None
        mgr._create("c", 1024, 256)
        mgr.discard("c")
        assert mgr.get("c") is None
        mgr.ttl = -1.0
        mgr._create("d", 1024, 256)
        mgr.gc()
        assert mgr.get("d") is None
    finally:
        mgr.close()
