"""The port's delta hot-swap against the JAX package's.

``assemble_delta_u8`` with the gate ``verify_u8_against_host``, the
``DoubleBuffer`` flip under reader threads, manifests and ``plan_delta``
over manifests the JAX package built, the assembly's coalescing, the
device half ``swap_generation`` (gate mismatch, out-of-memory degrade,
kernel faults), the base manifest built from the landed base when none
was published (``local_base_manifest``), and ``download_delta`` end to
end on reference daemons, held against the JAX package's
``download_delta``, with both manifests published and with none, and
``fetch_or_build_manifest`` over a reference object gateway (built after a
miss, a stale, a corrupt or another params' manifest; then a hit).
Tolerance 0 everywhere: bytes, plans, byte counts and resolution counts
are compared for equality.
"""

from __future__ import annotations

import hashlib
import os
import random
import sys
import threading
from urllib.parse import unquote, urlsplit

import numpy as np
import pytest
import torch

from dragonfly2_tpu.client import device as jdev
from dragonfly2_tpu.client.dfstore import Dfstore as JStore
from dragonfly2_tpu.delta import manifest as jman
from dragonfly2_tpu.delta.chunker import CDCParams as JParams
from dragonfly2_tpu.delta.manifest import build_manifest
from dragonfly2_tpu.delta.manifest import manifest_from_store as jfrom_store
from dragonfly2_tpu.delta.resolver import plan_delta as jplan
from dragonfly2_tpu.ops import checksum as jck
from dragonfly2_tpu.ops import hbm_sink as jhbm
from dragonfly2_tpu.pkg.testing import start_gateway_fixture
from dragonfly2_tpu.storage.local_store import LocalTaskStore, TaskStoreMetadata
from dragonfly2_tpu_torch.client import device as pdev
from dragonfly2_tpu_torch.client.dfstore import Dfstore as PStore
from dragonfly2_tpu_torch.delta import manifest as pman
from dragonfly2_tpu_torch.delta.resolver import plan_delta as pplan
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops import hbm_sink as phbm
from dragonfly2_tpu_torch.ops import safetensors as pst
from dragonfly2_tpu_torch.pkg import errors as perr
from tests.test_delta import _make_safetensors, scattered_mutation

P = JParams(mask_bits=12, min_size=2 << 10, max_size=32 << 10)


def _u8(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def _random_parts(rng: random.Random, live_len: int, n: int) -> list:
    parts = []
    for _ in range(n):
        if rng.random() < 0.5:
            src = rng.randrange(0, live_len)
            parts.append(("r", src, rng.randrange(0, live_len - src + 1)))
        else:
            parts.append(("f", rng.randbytes(rng.randrange(0, 300))))
        if rng.random() < 0.4 and parts[-1][0] == "r":
            # a run the assembly may coalesce: the next span of the source
            _, src, length = parts[-1]
            nxt = min(live_len - src - length, rng.randrange(0, 200))
            parts.append(("r", src + length, nxt))
    return parts


ASSEMBLE_CASES = [
    [("r", 1024, 1024), ("f", b"F" * 512), ("r", 0, 1024)],
    [("r", 0, 1000), ("r", 1000, 1000), ("r", 2000, 2096)],
    [("f", b"a" * 100), ("f", b"b" * 200), ("r", 7, 9)],
    [("f", os.urandom(4096))],
]


@pytest.mark.parametrize("parts", ASSEMBLE_CASES,
                         ids=["mixed", "one-run", "adjacent-fetched",
                              "all-fetched"])
def test_assemble_and_verify_match_the_reference(parts):
    old = np.random.default_rng(1).integers(0, 256, 4096, np.uint8).tobytes()
    got = phbm.assemble_delta_u8(_u8(old), parts)
    want = jhbm.assemble_delta_u8(jhbm.jnp.asarray(np.frombuffer(old, np.uint8)),
                                  parts)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    content = got.numpy().tobytes()
    piece = 2048
    checks = {i: jck.checksum_numpy(content[i * piece:(i + 1) * piece])
              for i in range(-(-len(content) // piece))}
    phbm.verify_u8_against_host(got, piece, checks)
    jhbm.verify_u8_against_host(want, piece, checks)
    corrupt = bytearray(content)
    corrupt[-1] ^= 0xFF
    last = len(checks) - 1
    with pytest.raises(ValueError, match=f"piece {last}"):
        phbm.verify_u8_against_host(_u8(bytes(corrupt)), piece, checks)
    with pytest.raises(ValueError, match=f"piece {last}"):
        jhbm.verify_u8_against_host(
            jhbm.jnp.asarray(np.frombuffer(bytes(corrupt), np.uint8)), piece,
            checks)


@pytest.mark.parametrize("seed", range(6))
def test_coalesced_copies_give_the_bytes_of_one_copy_per_part(seed):
    rng = random.Random(seed)
    live = rng.randbytes(2048)
    parts = _random_parts(rng, len(live), 40)
    got = phbm.assemble_delta_u8(_u8(live), parts).numpy().tobytes()
    one_each = b"".join(live[p[1]:p[1] + p[2]] if p[0] == "r" else p[1]
                        for p in parts)
    assert got == one_each
    want = jhbm.assemble_delta_u8(
        jhbm.jnp.asarray(np.frombuffer(live, np.uint8)), parts)
    assert got == np.asarray(want).tobytes()
    runs = phbm.coalesce_parts(parts)
    assert sum(r[3] for r in runs) == len(one_each)
    for a, b in zip(runs, runs[1:]):
        assert b[1] == a[1] + a[3]          # runs tile the output
        assert a[0] != b[0] or (a[0] == "r" and a[2] + a[3] != b[2])


def test_coalescing_counts_copies():
    parts = [("r", 0, 10), ("r", 10, 5), ("f", b"x"), ("f", b"yz"),
             ("r", 100, 4), ("r", 200, 4), ("r", 204, 1)]
    runs = phbm.coalesce_parts(parts)
    assert [(r[0], r[1], r[3]) for r in runs] == [
        ("r", 0, 15), ("f", 15, 3), ("r", 18, 4), ("r", 22, 5)]
    with pytest.raises(ValueError, match="outside"):
        phbm.assemble_delta_u8(_u8(b"\0" * 8), [("r", 4, 8)])
    with pytest.raises(ValueError, match="live buffer"):
        phbm.assemble_delta_u8(None, [("r", 0, 1)], device="cpu")
    with pytest.raises(ValueError, match="kind"):
        phbm.coalesce_parts([("x", 1)])
    assert phbm.assemble_delta_u8(None, [], device="cpu").numel() == 0


def test_double_buffer_flip_is_atomic_under_reader_threads():
    """Readers hammering snapshot() during flips see only complete
    generations: every tensor in a snapshot carries the same version
    sentinel, never a mix."""

    def gen_views(version: float):
        tensors = {f"t{i}": np.full((16,), version, np.float32)
                   for i in range(4)}
        u8 = _u8(_make_safetensors(tensors))
        header, ds = pst.read_header(u8)
        return u8, pst.tensor_views(u8, header, ds)

    hot = phbm.DoubleBuffer()
    assert hot.snapshot() == (0, None, {})
    hot.flip(*gen_views(1.0))
    bad: list = []
    seen: set = set()
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            gen, buf, views = hot.snapshot()
            vals = {float(v[0]) for v in views.values()}
            if vals != {float(gen)} or any(
                    v.untyped_storage().data_ptr()
                    != buf.untyped_storage().data_ptr()
                    for v in views.values()):
                bad.append((gen, vals))
            seen.add(gen)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader, name=f"df-test-reader-{i}")
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        for version in range(2, 12):
            hot.flip(*gen_views(float(version)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad, f"mixed-generation snapshots observed: {bad[:3]}"
    assert hot.generation == 11 and seen
    gen, buf, views = hot.snapshot()
    assert float(views["t0"][0]) == 11.0 and hot.buffer() is buf


# ------------------------------------------------------------------ #
# Manifests and plans
# ------------------------------------------------------------------ #

def _versions(seed: int = 5) -> tuple[bytes, bytes]:
    base = random.Random(seed).randbytes(300_000)
    return base, scattered_mutation(base, frac=0.02, sites=5, seed=seed)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_plan_over_reference_manifests_equals_the_reference(seed):
    base, new = _versions(seed)
    jb = build_manifest(base, "base", P)
    jn = build_manifest(new, "new", P)
    pb = pman.DeltaManifest.from_json_bytes(jb.to_json_bytes())
    pn = pman.DeltaManifest.from_json_bytes(jn.to_json_bytes())
    assert pb.to_json_bytes() == jb.to_json_bytes()
    assert pn.to_json_bytes() == jn.to_json_bytes()
    assert pn.params == pman.CDCParams(P.mask_bits, P.min_size, P.max_size)
    got, want = pplan(pn, pb), jplan(jn, jb)
    assert [(n.offset, n.length, n.sha256, b.offset) for n, b in got.reused] \
        == [(n.offset, n.length, n.sha256, b.offset) for n, b in want.reused]
    assert [(c.offset, c.length) for c in got.fetched] == [
        (c.offset, c.length) for c in want.fetched]
    assert got.fetch_spans() == want.fetch_spans()
    assert (got.reused_bytes, got.fetched_bytes) == (
        want.reused_bytes, want.fetched_bytes)
    assert got.reused_bytes > 0 and got.fetched_bytes > 0


def test_manifest_errors_match_the_reference():
    from dragonfly2_tpu.delta.manifest import DeltaManifest as JMan
    from dragonfly2_tpu.delta.manifest import ManifestError as JErr

    base, new = _versions()
    good = build_manifest(base, "b", P).to_json_bytes()
    bad_tiling = good.replace(b'[[0,', b'[[1,', 1)
    for raw in (b"{", b'{"v": 2}', bad_tiling, good[:-5]):
        with pytest.raises(pman.ManifestError):
            pman.DeltaManifest.from_json_bytes(raw)
        with pytest.raises(JErr):
            JMan.from_json_bytes(raw)
    other = pman.DeltaManifest.from_json_bytes(
        build_manifest(new, "n", JParams()).to_json_bytes())
    with pytest.raises(pman.ManifestError, match="params differ"):
        pplan(other, pman.DeltaManifest.from_json_bytes(good))
    with pytest.raises(ValueError, match="CDC bounds"):
        pman.CDCParams(min_size=0)


# ------------------------------------------------------------------ #
# The device half: swap_generation
# ------------------------------------------------------------------ #

class _Store:
    """A completed task store over host bytes: the surface the hot-swap
    reads (metadata, read_into, get_pieces, read_piece, pinning)."""

    class _Rec:
        def __init__(self, num):
            self.num = num

    def __init__(self, content: bytes, piece_size: int, corrupt_piece=None):
        self.content = content
        n = -(-len(content) // piece_size)
        self.metadata = type("M", (), {
            "content_length": len(content), "piece_size": piece_size,
            "total_piece_count": n, "task_id": "t-new"})()
        self.pieces = [self._Rec(i) for i in range(n)]
        self.corrupt_piece = corrupt_piece

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read_into(self, offset, length, buf):
        memoryview(buf)[:length] = self.content[offset:offset + length]

    def get_pieces(self):
        return self.pieces

    def read_piece(self, num):
        ps = self.metadata.piece_size
        data = bytearray(self.content[num * ps:(num + 1) * ps])
        if num == self.corrupt_piece:
            data[0] ^= 1
        return bytes(data)


def _hot_swap_inputs():
    rng = np.random.RandomState(3)
    v1 = {"w1": rng.randn(256, 256).astype(np.float32),
          "w2": rng.randn(256, 128).astype(np.float32),
          "bias": rng.randn(512).astype(np.float32)}
    v2 = {k: v.copy() for k, v in v1.items()}
    v2["bias"][7] += 1.0
    v2["w2"][3, :8] *= 1.5
    old, new = _make_safetensors(v1), _make_safetensors(v2)
    jb, jn = build_manifest(old, "v1", P), build_manifest(new, "v2", P)
    pb = pman.DeltaManifest.from_json_bytes(jb.to_json_bytes())
    pn = pman.DeltaManifest.from_json_bytes(jn.to_json_bytes())
    hot = phbm.DoubleBuffer()
    live = _u8(old)
    header, ds = pst.read_header(live)
    hot.flip(live, pst.tensor_views(live, header, ds))
    return v2, new, pn, pb, hot, jplan(jn, jb)


def test_swap_generation_reuses_the_plan_and_flips():
    v2, new, pn, pb, hot, plan = _hot_swap_inputs()
    store = _Store(new, 64 << 10)
    r = pdev.swap_generation(store, live_u8=hot.buffer(), new_m=pn,
                             base_m=pb, hot=hot, device="cpu",
                             task_id="t-new")
    assert r.flipped and r.on_device and hot.generation == r.generation == 2
    assert r.buffer.numpy().tobytes() == new
    assert (r.reused_device_bytes, r.staged_bytes) == (
        plan.reused_bytes, plan.fetched_bytes)
    parts, _, _ = pdev._device_parts(pn, pb)
    assert r.copies == len(phbm.coalesce_parts(parts)) < len(pn.chunks)
    assert set(r.timings) == {"parts_s", "assemble_s", "host_checksum_s",
                              "gate_s", "flip_s"}
    for name, want in v2.items():
        np.testing.assert_array_equal(hot.tensors()[name].numpy(), want)


def test_device_parts_equal_the_reference(tmp_path):
    _, new, pn, pb, hot, _ = _hot_swap_inputs()
    piece = 64 << 10
    store = LocalTaskStore(str(tmp_path / "s"), TaskStoreMetadata(
        task_id="t", content_length=len(new), piece_size=piece,
        total_piece_count=-(-len(new) // piece)))
    for i in range(store.metadata.total_piece_count):
        store.write_piece(i, new[i * piece:(i + 1) * piece])
    from dragonfly2_tpu.delta.manifest import DeltaManifest as JMan

    got, g_reused, g_staged = pdev._device_parts(pn, pb)
    want, w_reused, w_staged = jdev._device_parts(
        JMan.from_json_bytes(pn.to_json_bytes()),
        JMan.from_json_bytes(pb.to_json_bytes()), store)
    assert (g_reused, g_staged) == (w_reused, w_staged)
    assert all(p[0] in ("r", "s") for p in got)   # fetched runs stay on disk

    def fetched(part) -> bytes:
        if part[0] == "s":
            return new[part[1]:part[1] + part[2]]
        return bytes(part[1])

    def flat(parts):
        return [(k, dst, src if k == "r" else b"".join(map(fetched, src)), n)
                for k, dst, src, n in phbm.coalesce_parts(parts)]

    assert flat(got) == flat(want)
    with store:      # the assembly reads the store spans into its staging
        assembled = phbm.assemble_delta_u8(hot.buffer(), got, store=store)
    assert assembled.numpy().tobytes() == new
    assert pdev._host_piece_checksums(store) == jdev._host_piece_checksums(
        store)


def test_swap_generation_gate_mismatch_does_not_flip():
    _, new, pn, pb, hot, _ = _hot_swap_inputs()
    live = hot.snapshot()
    with pytest.raises(perr.DfError, match="piece 1 corrupt") as e:
        pdev.swap_generation(_Store(new, 64 << 10, corrupt_piece=1),
                             live_u8=hot.buffer(), new_m=pn, base_m=pb,
                             hot=hot, device="cpu")
    assert e.value.code == perr.Code.ClientPieceDownloadFail
    assert hot.snapshot() is live and hot.generation == 1


def test_swap_generation_without_manifests_stages_everything():
    v2, new, _, _, hot, _ = _hot_swap_inputs()
    r = pdev.swap_generation(_Store(new, 64 << 10), live_u8=hot.buffer(),
                             hot=hot, device="cpu")
    assert (r.reused_device_bytes, r.staged_bytes, r.copies) == (
        0, len(new), 1)
    assert r.buffer.numpy().tobytes() == new and hot.generation == 2
    single = pdev.swap_generation(_Store(new, 1 << 20), device="cpu")
    assert not single.flipped and single.generation == 1
    np.testing.assert_array_equal(single.tensors["bias"].numpy(), v2["bias"])


def test_local_base_manifest_equals_the_jax_fallback(tmp_path):
    """No published base manifest: the landed base store chunked with the
    new manifest's params, as the JAX download_delta does
    (``manifest_from_store(base_store, url, new_m.params)``), the same JSON
    bytes; the swap then reuses exactly the plan's bytes."""
    v2, new, pn, pb, hot, plan = _hot_swap_inputs()
    old = hot.buffer().numpy().tobytes()
    piece = 64 << 10
    base = LocalTaskStore(str(tmp_path / "base"), TaskStoreMetadata(
        task_id="t-base", url="http://origin/v1", content_length=len(old),
        piece_size=piece, total_piece_count=-(-len(old) // piece)))
    for i in range(base.metadata.total_piece_count):
        base.write_piece(i, old[i * piece:(i + 1) * piece])
    got = pdev.local_base_manifest(base, pn, device="cpu")
    want = jfrom_store(base, base.metadata.url, P)
    assert got.to_json_bytes() == want.to_json_bytes()
    assert got.name == "http://origin/v1" and got.chunks == pb.chunks
    assert pdev.local_base_manifest(base, pn, pb) is pb
    assert pdev.local_base_manifest(None, pn) is None
    assert pdev.local_base_manifest(base, None) is None
    r = pdev.swap_generation(_Store(new, piece), live_u8=hot.buffer(),
                             new_m=pn, base_m=got, hot=hot, device="cpu")
    assert (r.reused_device_bytes, r.staged_bytes) == (
        plan.reused_bytes, plan.fetched_bytes)
    assert r.reused_device_bytes > 0 and r.buffer.numpy().tobytes() == new


def test_swap_generation_degrades_to_the_host_on_out_of_memory(monkeypatch):
    v2, new, pn, pb, hot, _ = _hot_swap_inputs()

    def out_of_memory(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory: injected")

    monkeypatch.setattr(pdev, "assemble_delta_u8", out_of_memory)
    r = pdev.swap_generation(_Store(new, 64 << 10), live_u8=hot.buffer(),
                             new_m=pn, base_m=pb, hot=hot, device="cpu")
    assert not r.on_device and r.flipped and hot.generation == 2
    assert (r.reused_device_bytes, r.staged_bytes) == (0, len(new))
    assert r.buffer.numpy().tobytes() == new
    for name, want in v2.items():
        np.testing.assert_array_equal(r.tensors[name].numpy(), want)


def test_swap_after_an_out_of_memory_degrade_targets_the_device(
        monkeypatch):
    """One out-of-memory degrades that swap alone: the next swap lands on
    the requested device again, reusing the live buffer where it lies
    there, and reports ``on_device`` only for a buffer on that device."""
    v2, new, pn, pb, hot, _ = _hot_swap_inputs()
    real = pdev.assemble_delta_u8
    calls = []

    def out_of_memory_once(*args, **kw):
        calls.append(kw["device"])
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory: injected")
        return real(*args, **kw)

    monkeypatch.setattr(pdev, "assemble_delta_u8", out_of_memory_once)
    first = pdev.swap_generation(_Store(new, 64 << 10), live_u8=hot.buffer(),
                                 new_m=pn, base_m=pb, hot=hot, device="cpu")
    assert not first.on_device and hot.generation == 2
    v3 = {k: v.copy() for k, v in v2.items()}
    v3["w1"][0, :4] += 2.0
    gen3 = _make_safetensors(v3)
    p3 = pman.DeltaManifest.from_json_bytes(
        build_manifest(gen3, "v3", P).to_json_bytes())
    second = pdev.swap_generation(_Store(gen3, 64 << 10),
                                  live_u8=hot.buffer(), new_m=p3, base_m=pn,
                                  hot=hot, device="cpu")
    assert calls == [torch.device("cpu")] * 2
    assert second.on_device and second.buffer.device == torch.device("cpu")
    assert second.reused_device_bytes > 0 and hot.generation == 3
    assert second.buffer.numpy().tobytes() == gen3
    for name, want in v3.items():
        np.testing.assert_array_equal(hot.tensors()[name].numpy(), want)


def test_swap_generation_does_not_reuse_a_live_buffer_off_the_device():
    """A live buffer on another device than the target (on the card: the
    host buffer an out-of-memory degrade left) is not reused: the whole
    generation is staged onto the target device. A meta tensor stands in
    for it here; reading it would fail."""
    v2, new, pn, pb, hot, _ = _hot_swap_inputs()
    elsewhere = torch.empty(hot.buffer().numel(), dtype=torch.uint8,
                            device="meta")
    r = pdev.swap_generation(_Store(new, 64 << 10), live_u8=elsewhere,
                             new_m=pn, base_m=pb, hot=hot, device="cpu")
    assert r.on_device and r.buffer.device == torch.device("cpu")
    assert (r.reused_device_bytes, r.staged_bytes, r.copies) == (
        0, len(new), 1)
    assert r.buffer.numpy().tobytes() == new and hot.generation == 2
    for name, want in v2.items():
        np.testing.assert_array_equal(hot.tensors()[name].numpy(), want)


def test_swap_generation_kernel_fault_raises(monkeypatch):
    _, new, pn, pb, hot, _ = _hot_swap_inputs()

    def failed_launch(*args):
        raise _build.KernelLaunchError("chunk_checksums: injected")

    monkeypatch.setattr(phbm, "chunk_checksums", failed_launch)
    with pytest.raises(_build.KernelLaunchError, match="injected"):
        pdev.swap_generation(_Store(new, 64 << 10), live_u8=hot.buffer(),
                             new_m=pn, base_m=pb, hot=hot, device="cpu")
    assert hot.generation == 1


# ------------------------------------------------------------------ #
# download_delta end to end
# ------------------------------------------------------------------ #

def test_download_delta_hotswap_e2e_matches_the_reference(run_async,
                                                          tmp_path):
    """Version N lands in the port's sink through the fabric, version N+1
    arrives as a delta, reused chunks copy out of the live buffer, the
    spare verifies and the DoubleBuffer flips: the same byte accounting
    and the same tensors as the JAX package's download_delta on a
    JAX-sink daemon."""
    from dragonfly2_tpu.daemon.daemon import Daemon
    from dragonfly2_tpu.delta.resolver import publish_manifest_for
    from dragonfly2_tpu_torch.daemon.peer import device_sink as pds
    from tests import test_p2p_e2e as e2e
    from tests.test_delta import _drain_task, _file_req, _two_blob_origin
    from tests.test_device_sink import _start_sink_daemon

    v2, new, _, _, hot0, _ = _hot_swap_inputs()
    old = hot0.buffer().numpy().tobytes()
    sha1 = "sha256:" + hashlib.sha256(old).hexdigest()
    sha2 = "sha256:" + hashlib.sha256(new).hexdigest()

    async def body():
        origin, base_url, _ = await _two_blob_origin(old, new)
        sched = await e2e.start_scheduler()
        daemons = []
        try:
            seed = await e2e.start_daemon(tmp_path, "seedd", sched.port(),
                                          seed=True)
            daemons.append(seed)
            cfg = e2e.daemon_config(tmp_path, "portpod", sched.port())
            cfg.tpu_sink.enabled = False
            port_pod = Daemon(cfg)
            port_pod.task_manager.device_sinks = pds.DeviceSinkManager(
                device="cpu")
            await port_pod.start()
            daemons.append(port_pod)
            jax_pod = await _start_sink_daemon(tmp_path, "jaxpod",
                                               sched.port())
            daemons.append(jax_pod)
            r1 = await _drain_task(seed.task_manager,
                                   _file_req(f"{base_url}/v1", sha1))
            r2 = await _drain_task(seed.task_manager,
                                   _file_req(f"{base_url}/v2", sha2))
            await publish_manifest_for(seed.task_manager, r1.task_id,
                                       params=P)
            await publish_manifest_for(seed.task_manager, r2.task_id,
                                       params=P)

            first = await pdev.download_to_device(port_pod, f"{base_url}/v1",
                                                  digest=sha1)
            hot = phbm.DoubleBuffer()
            hot.flip(first.as_bytes_array(), first.load_safetensors())
            swap = await pdev.download_delta(port_pod, f"{base_url}/v2",
                                             base=first.task_id, hot=hot,
                                             digest=sha2, device="cpu")

            jfirst = await jdev.download_to_device(jax_pod, f"{base_url}/v1",
                                                   digest=sha1)
            jhot = jhbm.DoubleBuffer()
            jhot.flip(jfirst.as_bytes_array(), jfirst.load_safetensors())
            jswap = await jdev.download_delta(jax_pod, f"{base_url}/v2",
                                              base=jfirst.task_id, hot=jhot,
                                              digest=sha2)

            assert swap.flipped and swap.on_device and hot.generation == 2
            assert swap.task_id == jswap.task_id
            assert swap.reused_device_bytes > 0.5 * len(new)
            assert (swap.reused_device_bytes, swap.staged_bytes) == (
                jswap.reused_device_bytes, jswap.staged_bytes)
            assert swap.stats["reused_bytes"] + swap.stats[
                "fetched_bytes"] == len(new)
            assert swap.buffer.numpy().tobytes() == new
            for name, want in v2.items():
                got = hot.tensors()[name]
                assert got.numpy().tobytes() == np.asarray(
                    jhot.tensors()[name]).tobytes() == want.tobytes(), name
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await origin.cleanup()

    run_async(body(), timeout=120)


def _big_versions():
    """Two generations of a safetensors file of 8 MiB and more, so the
    default CDCParams cut several chunks; generation 2 changes two small
    spans."""
    rng = np.random.RandomState(11)
    v1 = {"w1": rng.randn(1024, 1024).astype(np.float32),
          "w2": rng.randn(1024, 1024).astype(np.float32),
          "bias": rng.randn(4096).astype(np.float32)}
    v2 = {k: v.copy() for k, v in v1.items()}
    v2["bias"][7] += 1.0
    v2["w2"][3, :8] *= 1.5
    return v2, _make_safetensors(v1), _make_safetensors(v2)


def test_download_delta_without_published_manifests_matches_the_reference(
        run_async, tmp_path):
    """The first delta of a series whose manifests were never published:
    the daemon's delta engine misses the new manifest, lands the new
    version in full and publishes only its manifest; the client then
    misses the base manifest and chunks the landed base itself. The port
    reuses and stages exactly the bytes the JAX download_delta does, with
    reuse > 0, and flips to the same tensors."""
    from dragonfly2_tpu.daemon.daemon import Daemon
    from dragonfly2_tpu_torch.daemon.peer import device_sink as pds
    from dragonfly2_tpu_torch.delta import resolver as pres
    from tests import test_p2p_e2e as e2e
    from tests.test_delta import _drain_task, _file_req, _two_blob_origin
    from tests.test_device_sink import _start_sink_daemon

    v2, old, new = _big_versions()
    assert len(old) >= 8 << 20
    sha1 = "sha256:" + hashlib.sha256(old).hexdigest()
    sha2 = "sha256:" + hashlib.sha256(new).hexdigest()

    async def body():
        # One origin a pod, so that neither sees the manifests the other's
        # daemon publishes.
        origin, base_url, _ = await _two_blob_origin(old, new)
        jorigin, jbase_url, _ = await _two_blob_origin(old, new)
        sched = await e2e.start_scheduler()
        daemons = []
        try:
            seed = await e2e.start_daemon(tmp_path, "seedd", sched.port(),
                                          seed=True)
            daemons.append(seed)
            cfg = e2e.daemon_config(tmp_path, "portpod", sched.port())
            cfg.tpu_sink.enabled = False
            port_pod = Daemon(cfg)
            port_pod.task_manager.device_sinks = pds.DeviceSinkManager(
                device="cpu")
            await port_pod.start()
            daemons.append(port_pod)
            jax_pod = await _start_sink_daemon(tmp_path, "jaxpod",
                                               sched.port())
            daemons.append(jax_pod)
            for url in (base_url, jbase_url):
                await _drain_task(seed.task_manager,
                                  _file_req(f"{url}/v1", sha1))
                await _drain_task(seed.task_manager,
                                  _file_req(f"{url}/v2", sha2))

            first = await pdev.download_to_device(port_pod, f"{base_url}/v1",
                                                  digest=sha1)
            hot = phbm.DoubleBuffer()
            hot.flip(first.as_bytes_array(), first.load_safetensors())
            swap = await pdev.download_delta(port_pod, f"{base_url}/v2",
                                             base=first.task_id, hot=hot,
                                             digest=sha2, device="cpu")

            jfirst = await jdev.download_to_device(jax_pod, f"{jbase_url}/v1",
                                                   digest=sha1)
            jhot = jhbm.DoubleBuffer()
            jhot.flip(jfirst.as_bytes_array(), jfirst.load_safetensors())
            jswap = await jdev.download_delta(jax_pod, f"{jbase_url}/v2",
                                              base=jfirst.task_id, hot=jhot,
                                              digest=sha2)

            # Each daemon landed the new version in full (no delta stats)
            # and published its manifest alone; each client chunked its
            # landed base.
            for pod, base_id, new_id in (
                    (port_pod, first.task_id, swap.task_id),
                    (jax_pod, jfirst.task_id, jswap.task_id)):
                storage = pod.task_manager.storage
                assert storage.find_completed_task(
                    pres.manifest_request(base_id).task_id()) is None
                assert storage.find_completed_task(
                    pres.manifest_request(new_id).task_id()) is not None
            assert swap.stats == jswap.stats == {}
            assert swap.flipped and swap.on_device and hot.generation == 2
            assert swap.reused_device_bytes > 0.5 * len(new)
            assert (swap.reused_device_bytes, swap.staged_bytes) == (
                jswap.reused_device_bytes, jswap.staged_bytes)
            assert swap.buffer.numpy().tobytes() == new
            for name, want in v2.items():
                got = hot.tensors()[name]
                assert got.numpy().tobytes() == np.asarray(
                    jhot.tensors()[name]).tobytes() == want.tobytes(), name
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await origin.cleanup()
            await jorigin.cleanup()

    run_async(body(), timeout=240)


# ------------------------------------------------------------------ #
# The gateway-cached manifest (fetch_or_build_manifest)
# ------------------------------------------------------------------ #

def _fetches(counter, read) -> dict:
    return {r: read(counter.labels(r))
            for r in ("built", "hit", "stale", "corrupt")}


@pytest.mark.parametrize("cached", ["none", "published", "stale", "corrupt",
                                    "other params"])
def test_fetch_or_build_manifest_matches_the_reference(run_async, tmp_path,
                                                       cached):
    """Each package's function over its own bucket of one reference
    gateway, the same object and the same cached manifest beside it: the
    same manifest bytes, the same published object and the same
    resolution counts, then a hit each."""
    content = _versions(8)[0] * 3
    key = "ckpt/model.safetensors"
    pp = pman.CDCParams(P.mask_bits, P.min_size, P.max_size)
    seed = {"none": None,
            "published": build_manifest(content, key, P).to_json_bytes(),
            "stale": build_manifest(content[:-4096], key, P).to_json_bytes(),
            "corrupt": b"{not a manifest",
            "other params": build_manifest(
                content, key, JParams(P.mask_bits - 1, P.min_size,
                                      P.max_size)).to_json_bytes()}[cached]

    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = JStore(fx.endpoint), PStore(fx.endpoint)
        try:
            for b in ("j", "p"):
                await js.create_bucket(b)
                await js.put_object(b, key, content, mode="write_back")
                if seed is not None:
                    await js.put_object(b, pman.manifest_object_key(key), seed,
                                        mode="write_back")
            j0 = _fetches(jman.MANIFEST_FETCHES, lambda c: c._value.get())
            p0 = _fetches(pman.MANIFEST_FETCHES,
                          lambda c: c._metric.value(*c._key))
            stats: dict = {}
            jm = await jman.fetch_or_build_manifest(js, "j", key, params=P)
            pm = await pman.fetch_or_build_manifest(ps, "p", key, params=pp,
                                                    device="cpu", stats=stats)
            assert pm.to_json_bytes() == jm.to_json_bytes()
            jd = {r: v - j0[r] for r, v in _fetches(
                jman.MANIFEST_FETCHES, lambda c: c._value.get()).items()}
            pd = {r: v - p0[r] for r, v in _fetches(
                pman.MANIFEST_FETCHES,
                lambda c: c._metric.value(*c._key)).items()}
            assert pd == jd
            want = {"none": "built", "published": "hit",
                    "other params": "stale"}.get(cached, cached)
            assert stats["result"] == want
            assert pd[want] == 1 and pd["built"] == (want != "hit")
            if want != "hit":
                assert stats["feeds"] == -(-len(content) // (1 << 20))
            # What each published, read from the gateway's backend (a GET
            # through the gateway may still be served the overwritten
            # object from the daemon's task store).
            published = []
            for b in ("j", "p"):
                path = urlsplit(fx.object_url(b, pman.manifest_object_key(key)))
                with open(unquote(path.path), "rb") as f:
                    published.append(f.read())
            assert published[1] == published[0] == jm.to_json_bytes()
            if cached in ("none", "published"):
                stats.clear()
                again = await pman.fetch_or_build_manifest(
                    ps, "p", key, params=pp, device="cpu", stats=stats)
                assert again.to_json_bytes() == jm.to_json_bytes()
                assert stats == {"result": "hit"}
            with pytest.raises(Exception) as je:
                await jman.fetch_or_build_manifest(js, "j", "absent")
            with pytest.raises(Exception) as pe:
                await pman.fetch_or_build_manifest(ps, "j", "absent",
                                                   device="cpu")
            assert (type(pe.value).__name__, pe.value.status,
                    str(pe.value)) == (type(je.value).__name__,
                                       je.value.status, str(je.value))
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)
