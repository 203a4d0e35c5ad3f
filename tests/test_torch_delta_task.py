"""The port's delta task against the JAX package's, on one origin.

A port ``TaskManager`` and a JAX one, each over its own data directory
and with no scheduler, land version 1 of a content from an aiohttp origin
(``tests/test_delta.py``'s two-blob origin), receive the same published
manifest of version 2 (the JAX builder's bytes, imported as the
``dfdelta://`` task), and land version 2 through ``start_delta_task`` (the
port with ``device="cpu"``). They must agree on the landed store (its
metadata and data bytes), ``delta_stats``, the terminal progress frame
(all but the peer id) and the digest, on every rung and fault of the
delta plane:

- the delta proper, with the base manifest published and with none (then
  built from the base store and published);
- a completed task reused, a running task joined;
- no base landed, no published manifest, no chunk in common: a full
  download, then the new version's manifest published;
- a corrupt base chunk re-fetched (``corrupt_base``); a re-fetch that
  fails its sha256 (``ClientPieceDownloadFail``); an accounting drift
  (``UnknownError``); an early close (``ClientContextCanceled``, the
  landed pieces kept for the resume).

Then ``download_delta`` end to end on the port's own daemon parts (the
port's task manager with the port's scheduler client and conductor
factory, the JAX scheduler and a JAX seed) against the JAX
``download_delta`` on a JAX daemon: the same ``staged_bytes``,
``reused_device_bytes``, ``stats`` and tensors.

Content is made with numpy from a seed. Tolerance 0: bytes exact.
"""

from __future__ import annotations

import asyncio
import hashlib
import json

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
from dragonfly2_tpu.delta import resolver as jres
from dragonfly2_tpu.delta.chunker import CDCParams as JParams
from dragonfly2_tpu.delta.manifest import build_manifest
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
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
from dragonfly2_tpu_torch.delta import resolver as pres
from dragonfly2_tpu_torch.proto.common import UrlMeta as PMeta
from dragonfly2_tpu_torch.storage import StorageManager as PSM
from dragonfly2_tpu_torch.storage import StorageOption as PSMOption
from tests.test_delta import _two_blob_origin

P = JParams(mask_bits=12, min_size=2 << 10, max_size=32 << 10)
MB = 1 << 20


def _versions(seed: int = 31, size: int = 3 * MB + 777):
    """Version 1, and version 2 with a few spans redrawn."""
    rng = np.random.default_rng(seed)
    v1 = rng.integers(0, 256, size, np.uint8)
    v2 = v1.copy()
    for start in (4096, size // 3, size // 2 + 12345, size - 9000):
        v2[start:start + 3000] = rng.integers(0, 256, 3000, np.uint8)
    return v1.tobytes(), v2.tobytes()


V1, V2 = _versions()
SHA2 = "sha256:" + hashlib.sha256(V2).hexdigest()


def _managers(root, *, sinks: bool = False):
    """(jax_tm, port_tm) over data directories of their own, no scheduler;
    one origin stream each, as the JAX delta tests configure theirs."""
    jax = JTM(JSM(JSMOption(data_dir=str(root / "jax"))),
              JPM(JPMOption(concurrency=1)),
              device_sinks=JSinks() if sinks else None)
    port = PTM(PSM(PSMOption(data_dir=str(root / "port"))),
               PPM(PPMOption(concurrency=1)),
               device_sinks=PSinks(device="cpu") if sinks else None)
    return jax, port


def _requests(url: str, **meta):
    return (JRequest(url=url, output="", meta=JMeta(**meta)),
            PRequest(url=url, output="", meta=PMeta(**meta)))


async def _drain(it) -> list:
    return [p async for p in it]


def _delta(tm, req, base: str):
    if isinstance(tm, PTM):
        return tm.start_delta_task(req, base, device="cpu")
    return tm.start_delta_task(req, base)


_FINAL = ("state", "task_id", "content_length", "completed_length",
          "piece_count", "total_piece_count", "digest", "error",
          "from_reuse", "from_p2p", "device_verified")


def _final(progress: list) -> dict:
    d = progress[-1].to_wire()
    return {k: d[k] for k in _FINAL}


def _store_facts(tm, task_id: str) -> dict:
    s = tm.storage.try_get(task_id)
    m = s.metadata.to_json()
    for key in ("created_at", "last_access", "peer_id"):
        m.pop(key)
    m["pieces"] = {(p["num"], p["offset"], p["size"], p["digest"])
                   for p in m["pieces"].values()}
    try:
        with open(s.data_path, "rb") as f:
            m["data"] = hashlib.sha256(f.read()).hexdigest()
    except FileNotFoundError:       # an invalid store's data went with it
        m["data"] = None
    return m


async def _land_base(tm, req) -> str:
    final = (await _drain(tm.start_file_task(req)))[-1]
    assert final.state == "done", final
    return final.task_id


async def _publish(tm, content_task_id: str, manifest, tmp_path) -> None:
    """Import ``manifest`` as the content's ``dfdelta://`` task, as it
    arrives from a publishing peer."""
    req = (jres._manifest_request(content_task_id) if isinstance(tm, JTM)
           else pres.manifest_request(content_task_id))
    path = tmp_path / f"manifest-{type(tm).__module__.split('.')[0]}.json"
    path.write_bytes(manifest.to_json_bytes())
    await tm.import_task(str(path), req)


def _published(tm, content_task_id: str) -> bool:
    req = pres.manifest_request(content_task_id)
    return tm.storage.find_completed_task(req.task_id()) is not None


def _corrupt(tm, task_id: str, offset: int) -> None:
    with open(tm.storage.try_get(task_id).data_path, "r+b") as f:
        f.seek(offset)
        f.write(b"\xde\xad\xbe\xef" * 8)


CASES = ["delta", "delta-base-published", "completed", "running",
         "no-base", "no-manifest", "zero-overlap", "corrupt-base",
         "refetch-fails", "drift"]


@pytest.mark.parametrize("case", CASES)
def test_delta_task_equals_jax(run_async, tmp_path, case):
    v2 = bytes(reversed(V1)) if case == "zero-overlap" else V2
    served = v2
    new_m = build_manifest(v2, "v2", P)
    first_reused = None
    if case == "refetch-fails":
        # The origin's bytes differ from the manifest's at the chunk whose
        # base copy is corrupt: its re-fetch fails the sha256 too.
        first_reused = jres.plan_delta(new_m, build_manifest(V1, "", P)
                                       ).reused[0]
        bad = bytearray(v2)
        bad[first_reused[0].offset] ^= 0xFF
        served = bytes(bad)

    async def body():
        origin, base_url, stats = await _two_blob_origin(V1, served)
        try:
            out = {}
            for tm in _managers(tmp_path):
                jax = isinstance(tm, JTM)
                breq, nreq = _requests(f"{base_url}/v1"), _requests(
                    f"{base_url}/v2", digest="" if case == "refetch-fails"
                    else "sha256:" + hashlib.sha256(v2).hexdigest())
                breq, nreq = breq[0 if jax else 1], nreq[0 if jax else 1]
                base_id = (await _land_base(tm, breq)
                           if case != "no-base" else breq.task_id())
                if case != "no-manifest":
                    await _publish(tm, nreq.task_id(), new_m, tmp_path)
                if case in ("delta-base-published", "corrupt-base",
                            "refetch-fails"):
                    # Published from the clean base: the corrupt copy here
                    # fails the sha256 this manifest names.
                    await _publish(tm, base_id, build_manifest(V1, "v1", P),
                                   tmp_path)
                if case in ("corrupt-base", "refetch-fails"):
                    b = (first_reused[1].offset if first_reused
                         else 100_000)
                    _corrupt(tm, base_id, b)
                if case == "completed":
                    await _drain(_delta(tm, nreq, base_id))
                before = stats["v2"]
                if case == "running":
                    plain = asyncio.ensure_future(
                        _drain(tm.start_file_task(nreq)))
                    while not tm.is_task_running(nreq.task_id()):
                        await asyncio.sleep(0.001)
                if case == "drift":
                    mod = jres if jax else pres
                    real = mod._chunk_bytes

                    async def drifting(*args, **kw):
                        view = await real(*args, **kw)
                        st = next(a for a in args if isinstance(a, dict)
                                  and "reused_bytes" in a)
                        if st["chunks_reused"] + st["chunks_fetched"] == 1:
                            st["reused_bytes"] -= 1
                        return view
                    mod._chunk_bytes = drifting
                try:
                    prog = await _drain(_delta(tm, nreq, base_id))
                finally:
                    if case == "drift":
                        mod._chunk_bytes = real
                if case == "running":
                    assert (await plain)[-1].state == "done"
                tid = nreq.task_id()
                out["jax" if jax else "port"] = {
                    "final": _final(prog),
                    "stats": tm.delta_stats.get(tid),
                    "store": (_store_facts(tm, tid)
                              if tm.storage.try_get(tid) else None),
                    "origin_v2": stats["v2"] - before,
                    "published_new": _published(tm, tid),
                    "published_base": _published(tm, base_id),
                    "running": tm.is_task_running(tid)}
            j, p = out["jax"], out["port"]
            assert p == j
            final, st = p["final"], p["stats"]
            if case in ("refetch-fails", "drift"):
                code = 4005 if case == "refetch-fails" else 1000
                assert final["state"] == "failed"
                assert final["error"]["code"] == code, final
                assert p["store"]["invalid"]
                return
            assert final["state"] == "done"
            assert p["store"]["done"] and not p["store"]["invalid"]
            assert p["store"]["data"] == hashlib.sha256(v2).hexdigest()
            assert final["digest"] == "sha256:" + p["store"]["data"]
            if case in ("delta", "delta-base-published", "corrupt-base"):
                assert st["reused_bytes"] + st["fetched_bytes"] == len(v2)
                assert st["reused_bytes"] > 0.8 * len(v2)
                assert st["corrupt_base"] == (case == "corrupt-base")
                assert p["published_base"]
                # Only the fetched spans crossed the wire, each after a
                # 1-byte probe.
                assert st["fetched_bytes"] < p["origin_v2"] <= \
                    st["fetched_bytes"] + 64
            elif case in ("completed", "running"):
                # Joined or reused: only the running plain task (if any)
                # fetched; the completed task keeps its first delta's stats.
                assert final["from_reuse"]
                assert (st is None) == (case == "running")
                assert p["origin_v2"] == (len(v2) + 1 if case == "running"
                                          else 0)
            else:
                # A full download, then this host's manifest published.
                assert st is None and p["published_new"]
                assert p["origin_v2"] == len(v2) + 1
        finally:
            await origin.cleanup()

    run_async(body(), timeout=120)


BIG1, BIG2 = _versions(37, 24 * MB + 99)


async def _after_close(tm, task_id: str) -> None:
    # The JAX delta's inner generators end when the loop finalizes them,
    # one a turn; the port's end within aclose().
    for _ in range(500):
        if not tm.is_task_running(task_id):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the closed delta task still runs")


def test_an_early_close_keeps_the_landed_pieces_for_the_resume(run_async,
                                                               tmp_path):
    """The consumer closes the delta's progress once a piece landed: the
    task ends, its landed pieces stay in a valid store, and the retry
    lands the rest to the same store as the JAX one."""
    async def body():
        origin, base_url, stats = await _two_blob_origin(BIG1, BIG2)
        try:
            out = {}
            for tm in _managers(tmp_path):
                jax = isinstance(tm, JTM)
                k = 0 if jax else 1
                breq = _requests(f"{base_url}/v1")[k]
                nreq = _requests(f"{base_url}/v2", digest="sha256:" + (
                    hashlib.sha256(BIG2).hexdigest()))[k]
                base_id = await _land_base(tm, breq)
                await _publish(tm, nreq.task_id(),
                               build_manifest(BIG2, "", P), tmp_path)
                tid = nreq.task_id()
                it = _delta(tm, nreq, base_id)
                first = await it.__anext__()
                while not tm.storage.try_get(tid).metadata.pieces:
                    await it.__anext__()
                landed = set(tm.storage.try_get(tid).metadata.pieces)
                await it.aclose()
                await _after_close(tm, tid)
                store = tm.storage.try_get(tid)
                closed = {"first": first.state,
                          "landed": sorted(landed),
                          "kept": sorted(store.metadata.pieces),
                          "invalid": store.metadata.invalid,
                          "done": store.metadata.done,
                          "running": tm.is_task_running(tid)}
                prog = await _drain(_delta(tm, nreq, base_id))
                out["jax" if jax else "port"] = {
                    "closed": closed, "final": _final(prog),
                    "store": _store_facts(tm, tid),
                    "stats": tm.delta_stats[tid]}
            for side in out.values():
                c = side.pop("closed")
                assert c["first"] == "running" and c["landed"]
                assert c["kept"] == c["landed"] and not c["invalid"]
                assert not c["done"] and not c["running"]
            assert out["port"] == out["jax"]
            assert out["port"]["final"]["state"] == "done"
        finally:
            await origin.cleanup()

    run_async(body(), timeout=120)


def test_a_waiter_on_a_closed_delta_sees_client_context_canceled(
        run_async, tmp_path):
    """A file request for the same task that joins a delta in flight gets
    the delta's end: ``ClientContextCanceled`` after an early close."""
    async def body():
        origin, base_url, _ = await _two_blob_origin(V1, V2)
        try:
            codes = []
            for tm in _managers(tmp_path):
                k = 0 if isinstance(tm, JTM) else 1
                breq = _requests(f"{base_url}/v1")[k]
                nreq = _requests(f"{base_url}/v2", digest=SHA2)[k]
                base_id = await _land_base(tm, breq)
                await _publish(tm, nreq.task_id(), build_manifest(V2, "", P),
                               tmp_path)
                it = _delta(tm, nreq, base_id)
                await it.__anext__()
                waiter = asyncio.ensure_future(
                    _drain(tm.start_file_task(nreq)))
                await asyncio.sleep(0.01)
                await it.aclose()
                await _after_close(tm, nreq.task_id())
                codes.append((await waiter)[-1].error["code"])
            assert codes == [4003, 4003]
        finally:
            await origin.cleanup()

    run_async(body(), timeout=120)


def test_the_delta_metrics_book_every_byte_once(run_async, tmp_path):
    """``peer_delta_bytes_total{kind}`` and ``peer_delta_chunks_total`` in
    the port's registry move as the JAX package's do over the same delta,
    and sum to the content length."""
    from dragonfly2_tpu_torch.pkg import metrics as pmetrics

    def jvalue(counter, label):
        return counter.labels(label)._value.get()

    async def body():
        origin, base_url, _ = await _two_blob_origin(V1, V2)
        try:
            moved = []
            for tm in _managers(tmp_path):
                jax = isinstance(tm, JTM)
                k = 0 if jax else 1
                mod = jres if jax else pres
                value = jvalue if jax else (
                    lambda c, label: c.value(label))
                keys = [(mod.DELTA_BYTES, "reused"),
                        (mod.DELTA_BYTES, "fetched"),
                        (mod.DELTA_CHUNKS, "reused"),
                        (mod.DELTA_CHUNKS, "fetched")]
                breq = _requests(f"{base_url}/v1")[k]
                nreq = _requests(f"{base_url}/v2", digest=SHA2)[k]
                base_id = await _land_base(tm, breq)
                await _publish(tm, nreq.task_id(), build_manifest(V2, "", P),
                               tmp_path)
                before = [value(c, label) for c, label in keys]
                await _drain(_delta(tm, nreq, base_id))
                moved.append([value(c, label) - b
                              for (c, label), b in zip(keys, before)])
            assert moved[1] == moved[0]
            assert moved[1][0] + moved[1][1] == len(V2)
            text = pmetrics.render()[0].decode()
            assert "peer_delta_bytes_total" in text
            assert "peer_delta_chunks_total" in text
        finally:
            await origin.cleanup()

    run_async(body(), timeout=120)


def test_the_delta_task_records_its_time_split(run_async, tmp_path):
    """A port-only readout beside ``delta_stats``: the delta's host seconds
    by phase, in ``TaskManager.delta_timings``."""
    async def body():
        origin, base_url, _ = await _two_blob_origin(V1, V2)
        try:
            _, tm = _managers(tmp_path)
            base_id = await _land_base(tm, _requests(f"{base_url}/v1")[1])
            nreq = _requests(f"{base_url}/v2")[1]
            await _publish(tm, nreq.task_id(), build_manifest(V2, "", P),
                           tmp_path)
            await _drain(_delta(tm, nreq, base_id))
            t = tm.delta_timings[nreq.task_id()]
            assert set(t) == {"resolve_s", "base_manifest_s", "assemble_s",
                              "base_read_s", "sha256_s", "span_wait_s",
                              "store_write_s", "finalize_s"}
            assert all(v >= 0 for v in t.values())
            assert t["base_read_s"] + t["sha256_s"] <= t["assemble_s"]
        finally:
            await origin.cleanup()

    run_async(body(), timeout=60)


# ------------------------------------------------------------------ #
# download_delta end to end on the port's own daemon
# ------------------------------------------------------------------ #

def _safetensors_versions():
    from tests.test_delta import _make_safetensors

    rng = np.random.RandomState(23)
    v1 = {"w1": rng.randn(512, 512).astype(np.float32),
          "w2": rng.randn(512, 256).astype(np.float32),
          "bias": rng.randn(4096).astype(np.float32)}
    v2 = {k: v.copy() for k, v in v1.items()}
    v2["bias"][::97] += 0.5
    v2["w2"][5, :16] *= 1.25
    return v2, _make_safetensors(v1), _make_safetensors(v2)


@pytest.mark.parametrize("published", [True, False],
                         ids=["manifests-published", "none-published"])
def test_download_delta_on_the_port_daemon_equals_the_jax_daemon(
        run_async, tmp_path, published):
    """Version 1 lands on a port pod (the port's task manager, scheduler
    client and conductor factory, the port's sink on the CPU) and on a JAX
    pod (the JAX sink), both over the JAX scheduler and a JAX seed;
    version 2 arrives through each package's ``download_delta`` on its
    own daemon. With both manifests published, the delta tasks reuse the
    base; with none, each lands version 2 in full and publishes its
    manifest, and each client chunks its base. The same staged and reused
    bytes, the same stats, the same tensors."""
    from dragonfly2_tpu.client import device as jdev
    from dragonfly2_tpu.ops import hbm_sink as jhbm
    from dragonfly2_tpu_torch.client import device as pdev
    from dragonfly2_tpu_torch.ops import hbm_sink as phbm
    from tests import test_p2p_e2e as e2e
    from tests.test_delta import _drain_task, _file_req
    from tests.test_device_sink import _start_sink_daemon
    from tests.test_torch_p2p import PortPeer

    tensors2, old, new = _safetensors_versions()
    sha1 = "sha256:" + hashlib.sha256(old).hexdigest()
    sha2 = "sha256:" + hashlib.sha256(new).hexdigest()

    async def body():
        # One origin a pod, so that neither sees the other's manifests.
        origin, base_url, _ = await _two_blob_origin(old, new)
        jorigin, jbase_url, _ = await _two_blob_origin(old, new)
        sched = await e2e.start_scheduler()
        daemons = []
        try:
            seed = await e2e.start_daemon(tmp_path, "seedd", sched.port(),
                                          seed=True)
            daemons.append(seed)
            port_pod = await PortPeer(tmp_path, "portpod", sched.port(),
                                      device_sinks=PSinks(device="cpu")
                                      ).start()
            daemons.append(port_pod)
            jax_pod = await _start_sink_daemon(tmp_path, "jaxpod",
                                               sched.port())
            daemons.append(jax_pod)
            for url in (base_url, jbase_url):
                r1 = await _drain_task(seed.task_manager,
                                       _file_req(f"{url}/v1", sha1))
                r2 = await _drain_task(seed.task_manager,
                                       _file_req(f"{url}/v2", sha2))
                if published:
                    for r in (r1, r2):
                        await jres.publish_manifest_for(
                            seed.task_manager, r.task_id, params=P)

            swaps = []
            for pod, dev, hbm, url in (
                    (port_pod, pdev, phbm, base_url),
                    (jax_pod, jdev, jhbm, jbase_url)):
                first = await dev.download_to_device(pod, f"{url}/v1",
                                                     digest=sha1)
                hot = hbm.DoubleBuffer()
                hot.flip(first.as_bytes_array(), first.load_safetensors())
                kw = {"device": "cpu"} if dev is pdev else {}
                swap = await dev.download_delta(pod, f"{url}/v2",
                                                base=first.task_id, hot=hot,
                                                digest=sha2, **kw)
                swaps.append((swap, hot))
            (swap, hot), (jswap, jhot) = swaps
            assert swap.task_id == _requests(f"{base_url}/v2",
                                             digest=sha2)[1].task_id()
            assert swap.flipped and swap.on_device and hot.generation == 2
            assert swap.reused_device_bytes > (0.5 * len(new) if published
                                               else 0)
            assert (swap.reused_device_bytes, swap.staged_bytes) == (
                jswap.reused_device_bytes, jswap.staged_bytes)
            assert swap.stats == jswap.stats
            if published:
                assert swap.stats["reused_bytes"] + swap.stats[
                    "fetched_bytes"] == len(new)
                assert swap.stats["corrupt_base"] == 0
            else:
                assert swap.stats == {}
            assert bytes(swap.buffer.numpy()) == new
            for name, want in tensors2.items():
                got = hot.tensors()[name].numpy().tobytes()
                assert got == np.asarray(jhot.tensors()[name]).tobytes() \
                    == want.tobytes(), name
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await origin.cleanup()
            await jorigin.cleanup()

    run_async(body(), timeout=180)


def test_the_download_service_routes_delta_base_to_the_delta_task(
        run_async, tmp_path):
    """``Daemon.Download`` with ``delta_base`` on the port's server runs
    the port's delta task with the server's device: the frames are the
    JAX server's, and the delta stats equal."""
    from dragonfly2_tpu.daemon.rpcserver import DaemonRpcServer as JServer
    from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
    from dragonfly2_tpu.rpc import Client as JClient
    from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer

    async def body():
        origin, base_url, _ = await _two_blob_origin(V1, V2)
        try:
            out = []
            for tm in _managers(tmp_path):
                jax = isinstance(tm, JTM)
                k = 0 if jax else 1
                base_id = await _land_base(tm, _requests(f"{base_url}/v1")[k])
                nreq = _requests(f"{base_url}/v2", digest=SHA2)[k]
                await _publish(tm, nreq.task_id(), build_manifest(V2, "", P),
                               tmp_path)
                server = JServer(tm) if jax else DaemonRpcServer(
                    tm, device="cpu")
                await server.serve_download(JNetAddr.tcp("127.0.0.1", 0))
                cli = JClient(JNetAddr.tcp("127.0.0.1",
                                           server.download_server.port()))
                try:
                    stream = await cli.open_stream(
                        "Daemon.Download",
                        {"url": f"{base_url}/v2", "output": "",
                         "device": "tpu", "meta": {"digest": SHA2},
                         "delta_base": base_id})
                    frames = []
                    while (msg := await stream.recv()) is not None:
                        frames.append(msg)
                finally:
                    await cli.close()
                    await server.close()
                last = dict(frames[-1])
                last.pop("peer_id")
                out.append((last, tm.delta_stats[nreq.task_id()]))
            assert out[1] == out[0]
            assert out[1][0]["state"] == "done"
        finally:
            await origin.cleanup()

    run_async(body(), timeout=120)


def test_delta_manifests_are_the_same_json(tmp_path):
    """The manifest a port delta task publishes for its base is the JAX
    builder's JSON byte for byte (so that JAX hosts fetch it)."""
    from dragonfly2_tpu_torch.delta.manifest import build_manifest as pbuild

    a = json.loads(build_manifest(V1, "v1", P).to_json_bytes())
    b = json.loads(pbuild(V1, "v1", P, device="cpu").to_json_bytes())
    assert a == b
