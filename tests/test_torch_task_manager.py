"""The port's daemon piece path against the JAX package's, on one origin.

A port ``StorageManager`` + ``PieceManager`` + ``TaskManager`` and the
JAX package's three, each over its own data directory, fetch the same
``file://`` and ``http://`` content (an aiohttp origin, as the JAX tests
use) and must agree on:

- the sequential and the concurrent ranged paths (``concurrent_min_length``
  lowered as the JAX tests lower it, and left at its default): task ids,
  the final progress, the store metadata, the piece digests (as sets:
  concurrent groups land in another order each run), the data bytes, the
  output, and the origin requests;
- reuse of a completed task, dedup of a running one, a ranged request off
  a local parent (the export, and the ranged task's import), both
  without an origin request;
- ``disable_back_source`` with no scheduler, and an origin 404: the same
  ``DfError`` code; a failed task's store is invalid and a retry is fresh;
- ``import_task`` from a local file, and the persistent import that needs
  a scheduler;
- with ``DeviceSinkManager(device="cpu")`` on the port side and the JAX
  sink on the JAX side: ``download_to_device`` (whole, ranged, a
  content digest), ``download_sharded`` and the dataset plane's
  ``DaemonRangeFetcher`` give the same bytes and tensors.

Content is made with numpy from a seed; at most a few MiB. Tolerance 0.
"""

from __future__ import annotations

import asyncio
import hashlib
import os

import numpy as np
import pytest
import torch
from aiohttp import web

from dragonfly2_tpu.client import device as jdev
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
from dragonfly2_tpu.dataset.shard_reader import (
    DaemonRangeFetcher as JFetcher,
)
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.pkg.piece import Range as JRange
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu_torch.client import device as pdev
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
from dragonfly2_tpu_torch.dataset.shard_reader import (
    DaemonRangeFetcher as PFetcher,
)
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import Range as PRange
from dragonfly2_tpu_torch.proto.common import UrlMeta as PMeta
from tests.test_safetensors import make_safetensors

MB = 1 << 20
CONTENT = np.random.default_rng(21).integers(
    0, 256, 10 * MB + 4321, np.uint8).tobytes()
SHA = "sha256:" + hashlib.sha256(CONTENT).hexdigest()


def _checkpoint() -> tuple[dict, bytes]:
    """~5 MiB of tensors in four dtypes."""
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


async def start_origin(content: bytes):
    """``content`` at /blob (ranges honoured) and at /plain (no ranges);
    404 elsewhere. ``stats`` counts GETs and HEADs by path."""
    stats: dict[str, int] = {}

    def handler(ranges: bool):
        async def h(request):
            key = f"{request.method} {request.path}"
            stats[key] = stats.get(key, 0) + 1
            hdr = request.headers.get("Range")
            if ranges and hdr:
                r = JRange.parse_http(hdr, len(content))
                data = content[r.start:r.start + r.length]
                return web.Response(status=206, body=data, headers={
                    "Accept-Ranges": "bytes", "Content-Range":
                    f"bytes {r.start}-{r.start + len(data) - 1}"
                    f"/{len(content)}"})
            return web.Response(body=content, headers=(
                {"Accept-Ranges": "bytes"} if ranges else {}))
        return h

    app = web.Application()
    app.router.add_route("*", "/blob", handler(True))
    app.router.add_route("*", "/plain", handler(False))
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}", stats


class _Daemon:
    """The surface the client entry points use: ``task_manager``."""

    def __init__(self, tm):
        self.task_manager = tm


def _managers(root, *, sinks: bool = False, **pm_opt):
    """(jax_tm, port_tm) over data directories of their own, built as the
    daemon builds them."""
    jax = JTM(JSM(JSMOption(data_dir=str(root / "jax"))),
              JPM(JPMOption(**pm_opt)),
              device_sinks=JSinks() if sinks else None)
    port = PTM(_port_storage(root / "port"), PPM(PPMOption(**pm_opt)),
               device_sinks=PSinks(device="cpu") if sinks else None)
    return jax, port


def _port_storage(path):
    from dragonfly2_tpu_torch.storage import StorageManager, StorageOption

    return StorageManager(StorageOption(data_dir=str(path)))


def _requests(url: str, output: str = "", **meta):
    return (JRequest(url=url, output=output + ".jax" if output else "",
                     meta=JMeta(**meta)),
            PRequest(url=url, output=output + ".port" if output else "",
                     meta=PMeta(**meta)))


async def _run(tm, req) -> list:
    return [p async for p in tm.start_file_task(req)]


_FINAL = ("state", "task_id", "content_length", "completed_length",
          "piece_count", "total_piece_count", "digest", "error",
          "from_reuse", "from_p2p", "device_verified")


def _final(progress: list) -> dict:
    d = progress[-1].to_wire()
    if d["error"]:
        d["error"] = {"code": d["error"]["code"]}
    return {k: d[k] for k in _FINAL}


def _store_facts(tm, task_id: str) -> dict:
    s = tm.storage.try_get(task_id)
    m = s.metadata.to_json()
    for key in ("created_at", "last_access", "peer_id"):
        m.pop(key)
    m["pieces"] = {(p["num"], p["offset"], p["size"], p["digest"])
                   for p in m["pieces"].values()}
    with open(s.data_path, "rb") as f:
        m["data"] = hashlib.sha256(f.read()).hexdigest()
    return m


@pytest.mark.parametrize("digest", ["", SHA], ids=["no-digest", "digest"])
@pytest.mark.parametrize("path", ["sequential", "concurrent"])
@pytest.mark.parametrize("origin", ["file", "http"])
def test_file_task_equals_jax(run_async, tmp_path, origin, path, digest):
    src = tmp_path / "src.bin"
    src.write_bytes(CONTENT)
    pm_opt = ({"concurrent_min_length": MB} if path == "concurrent"
              else {"concurrency": 1})

    async def body():
        runner, base, stats = await start_origin(CONTENT)
        try:
            url = base + "/blob" if origin == "http" else f"file://{src}"
            jtm, ptm = _managers(tmp_path, **pm_opt)
            jreq, preq = _requests(url, str(tmp_path / "out"), digest=digest)
            jprog = await _run(jtm, jreq)
            jax_gets = dict(stats)
            stats.clear()
            pprog = await _run(ptm, preq)
            assert _final(pprog) == _final(jprog)
            assert _final(pprog)["state"] == "done"
            assert all(p.state == "running" for p in pprog[:-1])
            tid = preq.task_id()
            assert tid == jreq.task_id() == pprog[-1].task_id
            facts = _store_facts(ptm, tid)
            assert facts == _store_facts(jtm, tid)
            assert facts["done"] and facts["data"] == SHA[7:]
            assert (tmp_path / "out.port").read_bytes() == CONTENT
            assert stats == jax_gets
            if origin == "http":
                groups = 3 if path == "concurrent" else 1
                assert stats == {"GET /blob": 1 + groups}
        finally:
            await runner.cleanup()

    run_async(body())


def test_an_origin_without_ranges_streams_as_the_jax_one(run_async, tmp_path):
    async def body():
        runner, base, stats = await start_origin(CONTENT)
        try:
            jtm, ptm = _managers(tmp_path, concurrent_min_length=MB)
            jreq, preq = _requests(base + "/plain")
            jprog = await _run(jtm, jreq)
            assert stats == {"GET /plain": 2}
            pprog = await _run(ptm, preq)
            assert _final(pprog) == _final(jprog)
            assert stats == {"GET /plain": 4}
            assert _store_facts(ptm, preq.task_id()) == \
                _store_facts(jtm, jreq.task_id())
        finally:
            await runner.cleanup()

    run_async(body())


def test_reuse_and_dedup_equal_jax(run_async, tmp_path):
    async def body():
        runner, base, stats = await start_origin(CONTENT)
        try:
            jtm, ptm = _managers(tmp_path, concurrent_min_length=MB)
            finals = []
            for tm, i in ((jtm, 0), (ptm, 1)):
                reqs = _requests(base + "/blob", str(tmp_path / "o"),
                                 digest=SHA)
                a, b = await asyncio.gather(_run(tm, reqs[i]),
                                            _run(tm, reqs[i]))
                c = await _run(tm, reqs[i])
                finals.append([_final(a), _final(b), _final(c)])
            assert finals[1] == finals[0]
            first, waiter, reuse = finals[1]
            assert not first["from_reuse"] and waiter["from_reuse"]
            assert reuse["from_reuse"] and reuse["digest"] == SHA
            assert stats == {"GET /blob": 2 * (1 + 3)}   # one download each
            assert (tmp_path / "o.port").read_bytes() == CONTENT
        finally:
            await runner.cleanup()

    run_async(body())


@pytest.mark.parametrize("rng", ["bytes=0-99", "bytes=1048570-3145730",
                                 f"bytes={len(CONTENT) - 10}-"
                                 f"{len(CONTENT) + 100}"])
def test_ranged_tasks_off_a_local_parent_equal_jax(run_async, tmp_path, rng):
    async def body():
        runner, base, stats = await start_origin(CONTENT)
        try:
            jtm, ptm = _managers(tmp_path, concurrent_min_length=MB)
            url = base + "/blob"
            for tm, i in ((jtm, 0), (ptm, 1)):
                await _run(tm, _requests(url)[i])
            stats.clear()
            r = PRange.parse_http(rng, len(CONTENT))
            want = CONTENT[r.start:r.start + r.length]
            # With an output: the slice exported off the parent.
            got = []
            for tm, i in ((jtm, 0), (ptm, 1)):
                req = _requests(url, str(tmp_path / "r"), range=rng)[i]
                req.range = (JRange if i == 0 else PRange).parse_http(rng)
                got.append(_final(await _run(tm, req)))
            assert got[1] == got[0] and got[1]["from_reuse"]
            assert (tmp_path / "r.port").read_bytes() == want
            # Without one: a ranged task of its own, imported.
            got = []
            for tm, i in ((jtm, 0), (ptm, 1)):
                req = _requests(url, range=rng)[i]
                req.range = (JRange if i == 0 else PRange).parse_http(rng)
                got.append((_final(await _run(tm, req)),
                            _store_facts(tm, req.task_id())))
            assert got[1] == got[0]
            assert got[1][0]["content_length"] == len(want)
            assert got[1][1]["data"] == hashlib.sha256(want).hexdigest()
            assert stats == {}
        finally:
            await runner.cleanup()

    run_async(body())


@pytest.mark.parametrize("case", ["no-back-source", "origin-404",
                                  "file-missing", "bad-digest"])
def test_failures_carry_the_jax_codes(run_async, tmp_path, case):
    async def body():
        runner, base, _ = await start_origin(CONTENT)
        try:
            jtm, ptm = _managers(tmp_path)
            url = {"no-back-source": base + "/blob",
                   "origin-404": base + "/none",
                   "file-missing": f"file://{tmp_path}/none",
                   "bad-digest": base + "/blob"}[case]
            digest = "sha256:" + "0" * 64 if case == "bad-digest" else ""
            got = []
            for tm, i in ((jtm, 0), (ptm, 1)):
                req = _requests(url, digest=digest)[i]
                req.disable_back_source = case == "no-back-source"
                got.append(_final(await _run(tm, req)))
                store = tm.storage.try_get(req.task_id())
                assert store is None or store.metadata.invalid
            assert got[1] == got[0] and got[1]["state"] == "failed"
            want = {"no-back-source": Code.ClientBackSourceError,
                    "origin-404": Code.SourceNotFound,
                    "file-missing": Code.SourceNotFound,
                    "bad-digest": Code.ClientPieceDownloadFail}[case]
            assert got[1]["error"]["code"] == want
            if case == "bad-digest":     # a retry starts fresh and fails
                req = _requests(url, digest=digest)[1]
                assert _final(await _run(ptm, req)) == got[1]
        finally:
            await runner.cleanup()

    run_async(body())


def test_import_task_equals_jax(run_async, tmp_path):
    src = tmp_path / "local.bin"
    src.write_bytes(CONTENT)

    async def body():
        jtm, ptm = _managers(tmp_path)
        got = []
        for tm, i in ((jtm, 0), (ptm, 1)):
            req = _requests("dfcache://local.bin", digest=SHA)[i]
            res = await tm.import_task(str(src), req)
            res.pop("peer_id")
            got.append((res, _store_facts(tm, req.task_id())))
            again = await tm.import_task(str(src), req)
            assert again["task_id"] == res["task_id"]
            with pytest.raises((DfError, JDfError)) as e:
                await tm.import_task(str(src), req, persistent=True)
            got.append((int(e.value.code), e.value.message))
        assert got[2] == got[0] and got[3] == got[1]
        assert got[3] == (Code.BadRequest,
                          "persistent import needs a scheduler connection")
        assert got[2][1]["done"] and got[2][1]["digest"] == SHA

    run_async(body())


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).reshape(-1).view(np.uint8).tobytes()


def test_device_landings_equal_the_jax_daemons(run_async, tmp_path):
    tensors, ckpt = _checkpoint()
    sha = "sha256:" + hashlib.sha256(ckpt).hexdigest()

    async def body():
        runner, base, stats = await start_origin(ckpt)
        jtm, ptm = _managers(tmp_path, sinks=True,
                             concurrent_min_length=MB)
        jd, pd = _Daemon(jtm), _Daemon(ptm)
        try:
            url = base + "/blob"
            got = await pdev.download_to_device(pd, url, digest=sha)
            want = await jdev.download_to_device(jd, url, digest=sha)
            assert got.task_id == want.task_id and not got.from_reuse
            assert _bits(got.as_bytes_array()) == \
                _bits(want.as_bytes_array()) == ckpt
            # Warm: the completed task, backfilled into a fresh sink.
            got = await pdev.download_to_device(pd, url, digest=sha)
            assert got.from_reuse and _bits(got.as_bytes_array()) == ckpt
            # Ranged tasks find their parent by the task id without a
            # digest: land that one, then nothing more comes from the
            # origin.
            for d in (pd, jd):
                await (pdev if d is pd else jdev).download_to_device(d, url)
            gets = stats["GET /blob"]
            for rng in ("0-65535", "bytes=1000003-4200000"):
                got = await pdev.download_to_device(pd, url,
                                                    range_header=rng)
                want = await jdev.download_to_device(jd, url,
                                                     range_header=rng)
                r = PRange.parse_http(PRange.normalize_header(rng))
                assert got.task_id == want.task_id
                assert _bits(got.as_bytes_array()) == \
                    _bits(want.as_bytes_array()) == \
                    ckpt[r.start:r.start + r.length]
            names = ["model.w_bf16", "model.norm"]
            got = await pdev.download_sharded(pd, url, names=names)
            want = await jdev.download_sharded(jd, url, names=names)
            assert set(got) == set(want) == set(names)
            for name in names:
                assert _bits(got[name]) == _bits(want[name]) == \
                    tensors[name].tobytes()
            assert got["model.w_bf16"].dtype == torch.bfloat16
            # The ranged tasks imported from the complete parents.
            assert stats["GET /blob"] == gets
            # The dataset plane's ranged reads: the same spans, reused.
            for lo, hi in ((8, 4104), (3 * MB + 1, 4 * MB + 77)):
                a, b = bytearray(hi - lo), bytearray(hi - lo)
                pf, jf = PFetcher(ptm, url), JFetcher(jtm, url)
                await pf.fetch_into(lo, hi, memoryview(a))
                await jf.fetch_into(lo, hi, memoryview(b))
                assert a == b == ckpt[lo:hi]
                assert pf.stats == jf.stats
            assert stats["GET /blob"] == gets
        finally:
            ptm.device_sinks.close()
            await runner.cleanup()

    run_async(body(), timeout=120)


def test_a_device_request_fails_on_a_corrupt_device_copy(run_async,
                                                         tmp_path,
                                                         monkeypatch):
    """A landing whose device copy disagrees with its host checksums fails
    the request with the JAX code, and the disk store stays reusable."""
    _, ckpt = _checkpoint()

    async def body():
        runner, base, _ = await start_origin(ckpt)
        _, ptm = _managers(tmp_path, sinks=True)
        try:
            from dragonfly2_tpu_torch.ops import hbm_sink

            real = hbm_sink.HBMSink.land_piece

            def flip(self, num, data):
                real(self, num, data)
                s, x = self.host_checksums[num]
                self.host_checksums[num] = (s ^ 1, x)

            monkeypatch.setattr(hbm_sink.HBMSink, "land_piece", flip)
            with pytest.raises(DfError) as e:
                await pdev.download_to_device(_Daemon(ptm), base + "/blob")
            assert e.value.code == Code.ClientPieceDownloadFail
            monkeypatch.setattr(hbm_sink.HBMSink, "land_piece", real)
            got = await pdev.download_to_device(_Daemon(ptm), base + "/blob")
            assert got.from_reuse and _bits(got.as_bytes_array()) == ckpt
        finally:
            ptm.device_sinks.close()
            await runner.cleanup()

    run_async(body())


@pytest.mark.parametrize("stage", ["cold", "warm"])
def test_a_kernel_fault_fails_the_request(run_async, tmp_path, monkeypatch,
                                          stage):
    """A failed launch of the port's kernel is never a disk-only result:
    in a landing (one piece a batch, so each piece launches) it fails the
    task and its store is invalid; in a warm request's finalize the fault
    reaches the caller and the disk store stays complete."""
    _, ckpt = _checkpoint()

    async def body():
        runner, base, _ = await start_origin(ckpt)
        _, ptm = _managers(tmp_path)
        ptm.device_sinks = PSinks(device="cpu", batch_pieces=1)
        try:
            from dragonfly2_tpu_torch.ops import _build, hbm_sink

            url = base + "/blob"
            if stage == "warm":
                await _run(ptm, _requests(url)[1])

            def failed_launch(*args):
                raise _build.KernelLaunchError("land_and_checksum: injected")

            monkeypatch.setattr(hbm_sink, "land_and_checksum", failed_launch)
            with pytest.raises((DfError, _build.KernelLaunchError),
                               match="injected") as e:
                await pdev.download_to_device(_Daemon(ptm), url)
            store = ptm.storage.try_get(_requests(url)[1].task_id())
            if stage == "cold":
                assert e.value.code == Code.UnknownError
                assert store.metadata.invalid
            else:
                assert isinstance(e.value, _build.KernelLaunchError)
                assert store.metadata.done and not store.metadata.invalid
            assert ptm.device_sinks.get(store.metadata.task_id) is None
        finally:
            ptm.device_sinks.close()
            await runner.cleanup()

    run_async(body())


def test_the_task_manager_keeps_its_threads_named(run_async, tmp_path):
    """Store I/O and origin reads run off the event loop, on threads the
    port names ``df-``; the loop's default executor is asyncio's own."""
    async def body():
        runner, base, _ = await start_origin(CONTENT)
        _, ptm = _managers(tmp_path, concurrent_min_length=MB)
        try:
            await _run(ptm, _requests(base + "/blob")[1])
            from dragonfly2_tpu_torch.source import get_client

            client = get_client(base)
            names = [t.name for t in client._pool._threads]
            assert names and all(n.startswith("df-") for n in names)
        finally:
            await runner.cleanup()

    run_async(body())
    assert os.path.isdir(tmp_path / "port" / "tasks")


def test_the_intended_divergences_from_the_jax_daemon(tmp_path):
    """What the port's task manager leaves out or adds, pinned: the
    traffic shaper's options as in JAX (the daemon drives its loop); PEX and
    the flight recorder as the JAX task manager has them (the same flight
    events in the task manager and the delta engine, but the PEX pull's
    ``EV_LANDED`` of each piece, which the JAX one leaves out; a PEX
    announce on every task kind, one daemon-wide quarantine); the delta
    task takes
    ``device=`` (where a base manifest is built) and keeps its time split
    in ``delta_timings``; no native-transport commit (``record_piece``,
    ``data_fd``) or serving observer in the store (its certification came
    with the P2P half); the GC interval and idle-fd close of the JAX
    storage options (the daemon's GC loop runs ``gc``), but not its
    ``keep_storage``, which nothing reads; no unused option fields."""
    import dataclasses
    import inspect
    import re

    from dragonfly2_tpu.daemon.peer import task_manager as jtm
    from dragonfly2_tpu.delta import resolver as jres
    from dragonfly2_tpu.storage import LocalTaskStore as JStore
    from dragonfly2_tpu.storage import StorageOption as JOpt
    from dragonfly2_tpu_torch.daemon.peer import task_manager as ptm
    from dragonfly2_tpu_torch.delta import resolver as pres
    from dragonfly2_tpu_torch.pkg.quarantine import ParentQuarantine
    from dragonfly2_tpu_torch.storage import LocalTaskStore as PStore
    from dragonfly2_tpu_torch.storage import StorageOption as POpt

    def params(fn) -> set:
        return set(inspect.signature(fn).parameters)

    j = params(JTM)
    p = params(PTM)
    assert p == j
    for name in ("start_stream_task", "start_seed_task", "start_delta_task",
                 "_maybe_prefetch", "_run_background_download",
                 "_finalize_device_for_seed", "_persistent_call",
                 "_import_local", "_stream_ordered", "_stream_from_store",
                 "_pex_download", "_pex_announce"):
        assert hasattr(JTM, name) and hasattr(PTM, name), name
    assert params(PTM._pex_download) == params(JTM._pex_download)
    assert params(PTM.start_delta_task) - params(JTM.start_delta_task) \
        == {"device"}
    # Options nothing sets are the JAX package's alone: the port's chunk
    # params come from the published manifest, and its span fetches are
    # the module constant ``SPAN_FETCHES`` (the JAX default).
    assert params(pres.run_delta_task) - params(jres.run_delta_task) \
        == {"device"}
    assert params(jres.run_delta_task) - params(pres.run_delta_task) \
        == {"params", "fetch_concurrency"}
    assert pres.SPAN_FETCHES == inspect.signature(
        jres.run_delta_task).parameters["fetch_concurrency"].default
    assert params(ptm.TaskManager._run_download) == params(
        jtm.TaskManager._run_download)
    # A seed's device fault is counted by kind in the port; the JAX
    # daemon only logs it.
    assert ptm.SEED_DEVICE_FAILURES.name == "peer_seed_device_failures_total"
    assert not hasattr(jtm, "SEED_DEVICE_FAILURES")
    # The flight recorder's events and PEX's announce are the JAX ones.
    for module, jmodule in ((ptm, jtm), (pres, jres)):
        with open(jmodule.__file__) as f:
            jsrc = f.read()
        with open(module.__file__) as f:
            src = f.read()
        events = set(re.findall(r"flightlib\.(EV_\w+)", src))
        # The port's PEX pull also records each piece's landing.
        assert events and events == set(re.findall(
            r"flightlib\.(EV_\w+)", jsrc)) | (
                {"EV_LANDED"} if module is ptm else set()), module.__name__
        assert "_pex_announce(task_id)" in src
        assert "finish_task(task_id, \"done\")" in src
        assert "finish_task(task_id, \"failed\"" in src
    jax, port = _managers(tmp_path)
    assert port.delta_timings == {} and port.delta_stats == {}
    assert not hasattr(jax, "delta_timings")
    # The traffic shaper is wired as in JAX; the quarantine is one a
    # daemon.
    assert (port.shaper.algorithm, port.shaper.total_rate) == (
        jax.shaper.algorithm, jax.shaper.total_rate)
    assert isinstance(port.quarantine, ParentQuarantine)
    assert port.pex is None and jax.pex is None
    for name in ("record_piece", "data_fd"):
        assert hasattr(JStore, name) and not hasattr(PStore, name)
    for name in ("apply_certification", "certifies",
                 "pieces_all_digest_verified",
                 "pieces_verified_against_digests"):
        assert hasattr(JStore, name) and hasattr(PStore, name)
    def fields(cls) -> set:
        return {f.name for f in dataclasses.fields(cls)}

    assert fields(JOpt) - fields(POpt) == {"keep_storage"}
    assert fields(JPMOption) - fields(PPMOption) == {"compute_digest",
                                                    "chunk_size"}



class _CorruptParent:
    """A downloader whose every piece fails as a corrupt (or otherwise
    typed) one, for both packages' ``pull_one_piece``."""

    def __init__(self, error):
        self.error = error

    async def download_piece_to_store(self, *a, **kw):
        return None     # the JAX native route declines: the generic path

    async def download_piece(self, *a, **kw):
        raise self.error

    async def close(self):
        pass


@pytest.mark.parametrize("reason,strikes", [
    ("corrupt", 1), ("truncated", 2), ("stall", 2), ("transport", 3),
    ("throttle", 0)])
def test_a_bad_parent_is_quarantined_daemon_wide_as_in_jax(run_async,
                                                           tmp_path, reason,
                                                           strikes):
    """A parent whose pieces fail with a typed reason: each package's
    conductor, built over its task manager's quarantine (the port's through
    ``conductor_factory``), penalizes the parent's endpoint after each
    failure exactly as the JAX one does; once it tips over, the parent is
    out of this task's selection and in its reschedule blocklist, and out
    of another task's too (the quarantine is the daemon's), with one
    ``EV_QUARANTINE`` in the flight and one count in
    ``peer_parent_quarantine_total{reason}``."""
    from dragonfly2_tpu.daemon.peer import conductor as jcond
    from dragonfly2_tpu.daemon.peer.piece_dispatcher import (
        PieceAssignment as JAssignment,
    )
    from dragonfly2_tpu.pkg import flight as jflight
    from dragonfly2_tpu_torch.daemon.peer import conductor as pcond
    from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import (
        PieceAssignment as PAssignment,
    )
    from dragonfly2_tpu_torch.pkg import flight as pflight

    jtm, ptm = _managers(tmp_path)
    jtm.flight, ptm.flight = jflight.FlightRecorder(), pflight.FlightRecorder()
    store = type("S", (), {"metadata": type("M", (), {"piece_size": 4})})

    def jax_conductor(task_id):
        return jcond.PeerTaskConductor(
            task_id=task_id, peer_id="child", url="http://x/", store=store,
            scheduler_client=None, piece_manager=None, host_info={},
            quarantine=jtm.quarantine, flight=jtm.flight.task(task_id))

    make = pcond.conductor_factory(scheduler_client=None,
                                   piece_manager=None, host_wire=dict,
                                   task_manager=ptm)

    def port_conductor(task_id):
        return make(task_id=task_id, peer_id="child",
                    request=PRequest(url="http://x/", output=""),
                    store=store, on_piece=None)

    async def body(build, assignment_cls, err):
        c = build("task-a")
        c.downloader = _CorruptParent(err)
        p = c.dispatcher.upsert_parent("bad-parent", "10.9.9.9", 65002)
        c.dispatcher.upsert_parent("good-parent", "10.9.9.8", 65002)
        steps = []
        for n in range(4):
            await c._download_one(assignment_cls(n, p, 4, ""))
            steps.append((sorted(x.peer_id for x in
                                 c.dispatcher.active_parents()),
                          sorted(c.dispatcher.unusable_parent_ids())))
        other = build("task-b")
        q = other.dispatcher.upsert_parent("bad-parent-b", "10.9.9.9", 65002)
        events = [e[1] for e in c.flight.events()]
        return (steps, [x.peer_id for x in other.dispatcher.active_parents()],
                q is not None, events)

    jerr = JDfError(int(Code.ClientPieceDownloadFail),
                    "piece 0 digest mismatch", {"reason": reason})
    perr = DfError(Code.ClientPieceDownloadFail, "piece 0 digest mismatch",
                   {"reason": reason})
    pcount = pcond.PARENT_QUARANTINE_COUNT.value(reason)
    jgot = run_async(body(jax_conductor, JAssignment, jerr))
    pgot = run_async(body(port_conductor, PAssignment, perr))
    assert pgot == jgot
    key = "10.9.9.9:65002"
    assert ptm.quarantine.is_quarantined(key) == jtm.quarantine.is_quarantined(
        key) == (strikes > 0)
    assert ptm.quarantine.score(key) > 0 or strikes == 0
    assert pgot[3].count(pflight.EV_QUARANTINE) == int(strikes > 0)
    assert pgot[3].count(pflight.EV_FAILED) == 4
    assert pcond.PARENT_QUARANTINE_COUNT.value(reason) - pcount == int(
        strikes > 0)
    if strikes:
        # Out of selection from the strike that tipped it, in the
        # blocklist, and out of the other task's selection.
        assert "bad-parent" not in pgot[0][-1][0]
        assert "bad-parent" in pgot[0][-1][1]
        assert pgot[1] == []
