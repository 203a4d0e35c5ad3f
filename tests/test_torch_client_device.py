"""The port's client paths against the JAX package's client.

A reference daemon carries the port's ``DeviceSinkManager(device="cpu")``
as its device sink; the port's ``download_to_device``,
``fetch_safetensors_header`` and ``download_sharded`` must return the
bytes and tensors the JAX package's client returns on a daemon that lands
with the JAX sink. The port's copies of the request types must give the
same task ids, the same ranges and the same error codes. Tolerance 0
everywhere: bytes, ids and codes are compared for equality.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from dragonfly2_tpu.client import device as jdev
from dragonfly2_tpu.daemon.daemon import Daemon
from dragonfly2_tpu.daemon.peer.task_manager import FileTaskRequest as JReq
from dragonfly2_tpu.delta import resolver as jres
from dragonfly2_tpu.ops import safetensors as jst
from dragonfly2_tpu.pkg import errors as jerr
from dragonfly2_tpu.pkg.piece import Range as JRange
from dragonfly2_tpu.pkg.testing import start_range_origin
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
from dragonfly2_tpu_torch.client import device as pdev
from dragonfly2_tpu_torch.daemon.peer import device_sink as pds
from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest as PReq
from dragonfly2_tpu_torch.delta import resolver as pres
from dragonfly2_tpu_torch.ops import hbm_sink as phbm
from dragonfly2_tpu_torch.ops import safetensors as pst
from dragonfly2_tpu_torch.pkg import errors as perr
from dragonfly2_tpu_torch.pkg.piece import Range as PRange
from dragonfly2_tpu_torch.proto.common import UrlMeta as PMeta
from tests.test_p2p_e2e import daemon_config, start_scheduler
from tests.test_safetensors import make_safetensors


def _checkpoint() -> tuple[dict, bytes]:
    """~5 MiB over two 4 MiB pieces, with a BF16 and a zero-element
    tensor."""
    rng = np.random.default_rng(23)
    tensors = {
        "model.embed": rng.standard_normal((512, 2048)).astype(np.float32),
        "model.empty": np.zeros((0, 8), np.float32),
        "model.w_bf16": rng.integers(0, 1 << 16, (1024, 512), np.uint16),
        "model.norm": rng.standard_normal(4096).astype(np.float16),
        "model.step": np.array([7], np.int32),
    }
    dtypes = {"model.embed": "F32", "model.empty": "F32",
              "model.w_bf16": "BF16", "model.norm": "F16",
              "model.step": "I32"}
    return tensors, make_safetensors(tensors, dtypes)


async def _daemons(tmp_path, sched_port):
    """A daemon with the port's sink, and one with the JAX sink."""
    cfg = daemon_config(tmp_path, "port", sched_port)
    cfg.tpu_sink.enabled = False
    port_d = Daemon(cfg)
    port_d.task_manager.device_sinks = pds.DeviceSinkManager(device="cpu")
    await port_d.start()
    cfg = daemon_config(tmp_path, "jax", sched_port)
    cfg.tpu_sink.enabled = True
    jax_d = Daemon(cfg)
    await jax_d.start()
    return port_d, jax_d


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).reshape(-1).view(np.uint8).tobytes()


def test_download_to_device_whole_and_ranged_match_reference(run_async,
                                                             tmp_path):
    _, ckpt = _checkpoint()

    async def body():
        runner, url, _ = await start_range_origin(ckpt)
        sched = await start_scheduler()
        daemons = []
        try:
            port_d, jax_d = await _daemons(tmp_path, sched.port())
            daemons += [port_d, jax_d]
            got = await pdev.download_to_device(port_d, url)
            want = await jdev.download_to_device(jax_d, url)
            assert got.task_id == want.task_id
            assert got.content_length == want.content_length == len(ckpt)
            assert _bits(got.as_bytes_array()) == _bits(want.as_bytes_array())
            assert _bits(got.as_bytes_array()) == ckpt
            assert port_d.task_manager.device_sinks.get(got.task_id) is None

            for rng in ("0-65535", "bytes=1000003-4200000"):
                got = await pdev.download_to_device(port_d, url,
                                                    range_header=rng)
                want = await jdev.download_to_device(jax_d, url,
                                                     range_header=rng)
                r = JRange.parse_http(JRange.normalize_header(rng))
                assert got.task_id == want.task_id
                assert _bits(got.as_bytes_array()) == _bits(
                    want.as_bytes_array())
                assert _bits(got.as_bytes_array()) == ckpt[
                    r.start:r.start + r.length]

            t = await pdev.download_to_device(port_d, url, dtype="uint8",
                                              shape=[len(ckpt)])
            assert t.dtype == torch.uint8 and _bits(t) == ckpt
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=120)


@pytest.mark.parametrize("prefix_guess", [64, 256 << 10],
                         ids=["header-past-guess", "header-in-guess"])
def test_header_and_sharded_pulls_match_reference(run_async, tmp_path,
                                                  prefix_guess):
    tensors, ckpt = _checkpoint()

    async def body():
        runner, url, _ = await start_range_origin(ckpt)
        sched = await start_scheduler()
        daemons = []
        try:
            port_d, jax_d = await _daemons(tmp_path, sched.port())
            daemons += [port_d, jax_d]
            hd, ds, pfx = await pdev.fetch_safetensors_header(
                port_d, url, prefix_guess=prefix_guess)
            jhd, jds, jpfx = await jdev.fetch_safetensors_header(
                jax_d, url, prefix_guess=prefix_guess)
            assert (hd, ds) == (jhd, jds)
            assert _bits(pfx) == _bits(jpfx)

            for kw in ({"names": ["model.embed", "model.empty", "model.step"]},
                       {"selector": lambda n, m: m["dtype"] != "F32"},
                       {"names": ["model.norm", "model.step"],
                        "coalesce_gap": 0}):
                got = await pdev.download_sharded(
                    port_d, url, prefix_guess=prefix_guess, **kw)
                want = await jdev.download_sharded(
                    jax_d, url, prefix_guess=prefix_guess, **kw)
                assert set(got) == set(want) and got
                for name in got:
                    assert tuple(got[name].shape) == tuple(want[name].shape)
                    assert _bits(got[name]) == _bits(want[name]), name
                    assert _bits(got[name]) == tensors[name].tobytes(), name
            assert got["model.norm"].dtype == torch.float16

            with pytest.raises(pst.SafetensorsError, match="not in checkpoint"):
                await pdev.download_sharded(port_d, url, names=["typo"])
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=180)


def test_corrupt_landing_raises_dferror_and_store_stays_reusable(
        run_async, tmp_path, monkeypatch):
    """The port's client surfaces a corrupt device copy as
    DfError(ClientPieceDownloadFail), as the reference client does on a
    JAX-sink daemon; the disk store stays complete, and the next pull
    lands a fresh, verified sink from it."""
    _, ckpt = _checkpoint()

    def corrupt(self):
        raise ValueError("piece 1 corrupt in HBM: injected")

    async def body():
        runner, url, _ = await start_range_origin(ckpt)
        sched = await start_scheduler()
        cfg = daemon_config(tmp_path, "corrupt", sched.port())
        cfg.tpu_sink.enabled = False
        d = Daemon(cfg)
        d.task_manager.device_sinks = pds.DeviceSinkManager(device="cpu")
        await d.start()
        try:
            bad_before = pds.SINK_VERIFY_COUNT.value("corrupt")
            with monkeypatch.context() as mp:
                mp.setattr(phbm.HBMSink, "verify", corrupt)
                with pytest.raises(perr.DfError, match="piece 1") as e:
                    await pdev.download_to_device(d, url)
            assert e.value.code == perr.Code.ClientPieceDownloadFail
            assert pds.SINK_VERIFY_COUNT.value("corrupt") == bad_before + 1
            task_id = PReq(url=url, output="").task_id()
            assert d.task_manager.device_sinks.get(task_id) is None
            assert d.task_manager.storage.find_completed_task(task_id)

            again = await pdev.download_to_device(d, url)
            assert again.from_reuse and again.sink.verified
            assert _bits(again.as_bytes_array()) == ckpt
        finally:
            await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=120)


def test_daemon_without_device_sink_is_a_bad_request(run_async):
    daemon = types.SimpleNamespace(
        task_manager=types.SimpleNamespace(device_sinks=None))
    with pytest.raises(perr.DfError) as e:
        run_async(pdev.download_to_device(daemon, "http://origin/x"))
    assert e.value.code == perr.Code.BadRequest


@pytest.mark.parametrize("call", ["download_sharded", "download_delta",
                                  "load_safetensors"])
def test_shardings_wait_for_multi_device(run_async, call):
    daemon = types.SimpleNamespace(task_manager=None)
    shardings = {"w": object()}
    with pytest.raises(NotImplementedError, match="item 6"):
        if call == "download_sharded":
            run_async(pdev.download_sharded(daemon, "http://o/x",
                                            shardings=shardings))
        elif call == "download_delta":
            run_async(pdev.download_delta(daemon, "http://o/x", base="b",
                                          shardings=shardings))
        else:
            pdev.DeviceResult("t", 0, False, False, None).load_safetensors(
                shardings=shardings)


# ------------------------------------------------------------------ #
# The port's copies of the request types
# ------------------------------------------------------------------ #

DIGEST = "sha256:" + "ab" * 32
ID_CASES = [
    ("http://origin/model.safetensors", {}),
    ("http://origin/a?x=1&b=2", {}),
    ("http://origin/a?b=2&x=1&sig=abc", {"filter": "sig"}),
    ("http://origin/a?token=t&x=1&sig=abc&e=", {"filter": "sig&token",
                                                "tag": "t1"}),
    ("http://origin/m.safetensors", {"digest": DIGEST,
                                     "application": "trainer"}),
    ("http://origin/m.safetensors", {"range": "bytes=0-1023"}),
    ("http://origin/m.safetensors",
     {"range": "bytes=7-100", "tag": "ckpt", "application": "serve",
      "digest": DIGEST, "filter": "sig"}),
    ("s3://bucket/key/part-00001?versionId=3", {"tag": "v3"}),
    ("dfdelta://" + "0f" * 32, {"tag": "dfdelta-manifest"}),
]


@pytest.mark.parametrize("url,meta", ID_CASES)
def test_task_ids_equal_the_reference(url, meta):
    port = PReq(url=url, output="", meta=PMeta(**meta))
    ref = JReq(url=url, output="", meta=JMeta(**meta))
    assert port.task_id() == ref.task_id()
    assert port.parent_task_id() == ref.parent_task_id()


@pytest.mark.parametrize("content_task_id", ["", "a" * 64,
                                             JReq("http://o/x", "").task_id()])
def test_manifest_request_id_equals_the_reference(content_task_id):
    port = pres.manifest_request(content_task_id)
    ref = jres._manifest_request(content_task_id)
    assert port.task_id() == ref.task_id()
    assert (port.url, port.disable_back_source, port.meta.tag) == (
        ref.url, ref.disable_back_source, ref.meta.tag)


@pytest.mark.parametrize("cls_pair", [(PReq, JReq), (PMeta, JMeta)],
                         ids=["FileTaskRequest", "UrlMeta"])
def test_request_types_have_the_reference_fields(cls_pair):
    port, ref = cls_pair
    want = [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert [(f.name, f.default) for f in dataclasses.fields(port)] == want


def test_url_meta_values_equal_the_reference():
    kw = {"digest": DIGEST, "tag": "t", "range": "bytes=1-2",
          "filter": "a&b", "header": {"X": "1"}, "application": "app",
          "priority": 6, "tenant": "team"}
    assert dataclasses.asdict(PMeta(**kw)) == dataclasses.asdict(JMeta(**kw))
    assert dataclasses.asdict(PMeta()) == dataclasses.asdict(JMeta())
    assert dataclasses.replace(PMeta(**kw), range="").range == ""


RANGES = [("bytes=0-99", -1), ("bytes=100-", -1), ("bytes=100-", 1000),
          ("bytes=-100", 1000), ("bytes=-2000", 1000), ("5-9", -1),
          ("bytes=1500-", 1000), ("bytes=-100", -1), ("bytes=9-5", -1),
          ("bytes=0-1,5-6", -1), ("bytes=5", -1), ("", -1)]


def _outcome(fn):
    try:
        r = fn()
    except ValueError as e:
        return ("raises", type(e).__name__)
    return ("ok", None if r is None else (r.start, r.length, r.to_http()))


@pytest.mark.parametrize("header,length", RANGES)
def test_range_parse_equals_the_reference(header, length):
    port = _outcome(lambda: PRange.parse_http(header, length))
    ref = _outcome(lambda: JRange.parse_http(header, length))
    assert port == ref


@pytest.mark.parametrize("value", ["0-99", "bytes=0-99", " 0 - 99",
                                   "007-100", "bytes=100-", "100-", "-5",
                                   "9-5", ""])
def test_range_normalize_equals_the_reference(value):
    def norm(cls):
        try:
            return cls.normalize_header(value)
        except ValueError:
            return "raises"

    assert norm(PRange) == norm(JRange)


def test_error_codes_equal_the_reference():
    port = {n: int(c) for n, c in perr.Code.__members__.items()}
    assert port == {n: int(c) for n, c in jerr.Code.__members__.items()}


@pytest.mark.parametrize("code", list(jerr.Code), ids=lambda c: c.name)
def test_dferror_round_trips_every_reference_code(code):
    wire = jerr.DfError(code, "msg", {"k": 1}).to_wire()
    got = perr.DfError.from_wire(wire)
    assert (got.code.name, int(got.code)) == (code.name, int(code))
    assert got.to_wire() == wire
    back = jerr.DfError.from_wire(got.to_wire())
    assert back.code == code and back.message == "msg"


def test_dferror_unknown_code_keeps_the_raw_value():
    got = perr.DfError.from_wire({"code": 12345, "message": "new"})
    ref = jerr.DfError.from_wire({"code": 12345, "message": "new"})
    assert got.code == perr.Code.UnknownError
    assert got.to_wire() == ref.to_wire()
    assert perr.DfError.from_wire({}).to_wire() == jerr.DfError.from_wire(
        {}).to_wire()


# ------------------------------------------------------------------ #
# Span helpers
# ------------------------------------------------------------------ #

_spans = hst.lists(hst.tuples(hst.integers(0, 2000), hst.integers(0, 300))
                   .map(lambda t: (t[0], t[0] + t[1])), max_size=24)


@settings(max_examples=200, deadline=None)
@given(_spans)
def test_coalesce_spans_agrees_with_the_reference(spans):
    assert pdev.coalesce_spans(spans) == jdev.coalesce_spans(spans)


@settings(max_examples=200, deadline=None)
@given(_spans, hst.integers(0, 2400), hst.integers(0, 300))
def test_covering_span_agrees_with_the_reference(coverage, a, n):
    def cover(mod, err):
        try:
            return mod.covering_span(coverage, a, a + n)
        except err:
            return "raises"

    assert cover(pdev, pst.SafetensorsError) == cover(jdev,
                                                      jst.SafetensorsError)


@pytest.mark.parametrize("meta", [
    {"data_offsets": [0, 8]}, {"data_offsets": [8, 8]},
    {"data_offsets": [8, 4]}, {"data_offsets": [-1, 4]},
    {"data_offsets": [0]}, {"data_offsets": [True, 4]},
    {"data_offsets": "0-8"}, {}, "not-a-dict"])
def test_validated_span_agrees_with_the_reference(meta):
    def span(mod, err):
        try:
            return mod._validated_span("t", meta, 100)
        except err as e:
            return ("raises", str(e))

    assert span(pdev, pst.SafetensorsError) == span(jdev,
                                                    jst.SafetensorsError)
