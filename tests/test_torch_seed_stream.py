"""The port's seed and stream tasks and its ranged prefetch against the JAX
package's, on one origin.

A port ``TaskManager`` and a JAX one, each over its own data directory
and with no scheduler, take the same calls against one aiohttp origin
(``tests/test_torch_task_manager.py``'s, requests counted by path):

- ``start_seed_task``: a raw trigger range made canonical (the task id of
  a client's ``bytes=`` pull), a malformed range dropped with no task, the
  seed's and a normal peer's ids (``seed: False``), a content digest
  finalized (and a wrong one failing the store), a ``device: "tpu"``
  trigger joining a seed in flight and landing the content in the sink
  (the port's on the CPU, the JAX sink beside it), and a device fault
  that leaves the digest-checked disk store standing with the sink
  discarded;
- ``start_stream_task``: a completed task reused (``local_store``), a
  range a partial store covers served off it, the ordered stream of a
  live download, open ranges, and an unstarted body's ``aclose``
  releasing its broker subscription;
- ``prefetch``: a ranged miss also lands the whole task in the
  background.

The stores (metadata and data bytes), the attrs, the bytes streamed and
the origin's requests must agree. Content is made with numpy from a
seed; tolerance 0.
"""

from __future__ import annotations

import asyncio
import hashlib

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
from dragonfly2_tpu.daemon.peer.task_manager import (
    StreamTaskRequest as JStreamRequest,
)
from dragonfly2_tpu.daemon.peer.task_manager import TaskManager as JTM
from dragonfly2_tpu.pkg.piece import Range as JRange
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu.storage import TaskStoreMetadata as JMetadata
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
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    StreamTaskRequest as PStreamRequest,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    SEED_DEVICE_FAILURES,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager as PTM
from dragonfly2_tpu_torch.pkg.piece import Range as PRange
from dragonfly2_tpu_torch.proto.common import UrlMeta as PMeta
from dragonfly2_tpu_torch.storage import StorageManager as PSM
from dragonfly2_tpu_torch.storage import StorageOption as PSMOption
from dragonfly2_tpu_torch.ops._build import KernelError
from dragonfly2_tpu_torch.storage import TaskStoreMetadata as PMetadata
from tests.test_torch_task_manager import start_origin

MB = 1 << 20
CONTENT = np.random.default_rng(41).integers(
    0, 256, 10 * MB + 1234, np.uint8).tobytes()
SHA = "sha256:" + hashlib.sha256(CONTENT).hexdigest()
PIECE = 4 * MB


def _managers(root, *, sinks: bool = False, prefetch: bool = False):
    """(jax_tm, port_tm), no scheduler, each over its own directory."""
    jax = JTM(JSM(JSMOption(data_dir=str(root / "jax"))),
              JPM(JPMOption(concurrency=1)), prefetch=prefetch,
              device_sinks=JSinks() if sinks else None)
    port = PTM(PSM(PSMOption(data_dir=str(root / "port"))),
               PPM(PPMOption(concurrency=1)), prefetch=prefetch,
               device_sinks=PSinks(device="cpu") if sinks else None)
    return jax, port


def _jax(tm) -> bool:
    return isinstance(tm, JTM)


def _facts(tm, task_id: str) -> dict | None:
    s = tm.storage.try_get(task_id)
    if s is None:
        return None
    m = s.metadata.to_json()
    seed = m.pop("peer_id").endswith("_Seed")
    for key in ("created_at", "last_access"):
        m.pop(key)
    m["seed_peer"] = seed
    m["pieces"] = {(p["num"], p["offset"], p["size"], p["digest"])
                   for p in m["pieces"].values()}
    try:
        with open(s.data_path, "rb") as f:
            m["data"] = hashlib.sha256(f.read()).hexdigest()
    except FileNotFoundError:
        m["data"] = None
    return m


def _task_id(url: str, **meta) -> str:
    j = JRequest(url=url, output="", meta=JMeta(**meta)).task_id()
    assert PRequest(url=url, output="", meta=PMeta(**meta)).task_id() == j
    return j


async def _both(tmp_path, make, **kw):
    """``make(tm, base_url, stats)`` on each manager in turn, against one
    origin; returns ((jax_out, jax_requests), (port_out, port_requests))."""
    runner, base, stats = await start_origin(CONTENT)
    try:
        out = []
        for tm in _managers(tmp_path, **kw):
            stats.clear()
            res = await make(tm, base + "/blob")
            out.append((res, dict(stats)))
        return out
    finally:
        await runner.cleanup()


# --------------------------------------------------------------------- #
# Seed tasks
# --------------------------------------------------------------------- #

SEED_CASES = {
    "whole": {},
    "raw-range": {"range": "100-2000099"},
    "open-range": {"range": "bytes=5000000-"},
    "malformed-range": {"range": "x-y"},
    "normal-peer": {"seed": False},
    "digest": {"digest": SHA},
    "wrong-digest": {"digest": "sha256:" + "00" * 32},
    "tagged": {"tag": "t", "application": "a", "filters": ["X"]},
}


@pytest.mark.parametrize("case", list(SEED_CASES))
def test_seed_task_equals_jax(run_async, tmp_path, case):
    extra = SEED_CASES[case]

    async def make(tm, url):
        spec = {"url": url, **extra}
        await tm.start_seed_task(dict(spec))
        meta = {k: extra[k] for k in ("digest", "tag", "application")
                if k in extra}
        if "filters" in extra:
            meta["filter"] = "&".join(extra["filters"])
        if case not in ("malformed-range",) and "range" in extra:
            meta["range"] = JRange.normalize_header(extra["range"])
        tid = _task_id(url, **meta)
        return {"task_id": tid, "facts": _facts(tm, tid),
                "tasks": len(tm.storage.tasks()),
                "running": tm.is_task_running(tid)}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make))
    assert p == j and preq == jreq
    facts = p["facts"]
    if case == "malformed-range":
        assert p["tasks"] == 0 and jreq == {}
        return
    if case == "wrong-digest":
        assert facts["invalid"]
        return
    assert facts["done"] and not p["running"]
    assert facts["seed_peer"] == (case != "normal-peer")
    if case == "digest":
        assert facts["digest"] == SHA
    if "range" in extra:
        r = JRange.parse_http(JRange.normalize_header(extra["range"]),
                              len(CONTENT))
        want = CONTENT[r.start:r.start + r.length]
        assert facts["content_length"] == len(want)
    else:
        want = CONTENT
    assert facts["data"] == hashlib.sha256(want).hexdigest()


def _sink_bytes(sinks, task_id: str) -> bytes | None:
    sink = sinks.get(task_id)
    if sink is None:
        return None
    return np.asarray(sink.as_bytes_array()).tobytes()


def test_a_device_trigger_joins_the_seed_in_flight(run_async, tmp_path):
    """A plain seed runs; a ``device: "tpu"`` trigger of the same task
    waits for it, then lands the content in the sink; the sink holds the
    content, verified, as the JAX one does."""
    async def make(tm, url):
        tid = _task_id(url)
        plain = asyncio.ensure_future(tm.start_seed_task({"url": url}))
        while not tm.is_task_running(tid):
            await asyncio.sleep(0.001)
        await tm.start_seed_task({"url": url, "device": "tpu"})
        assert plain.done()
        await plain
        return {"facts": _facts(tm, tid),
                "sink": _sink_bytes(tm.device_sinks, tid) == CONTENT}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make, sinks=True))
    assert p == j and preq == jreq
    assert p["sink"] and p["facts"]["done"]
    assert preq == {"GET /blob": 2}


@pytest.mark.parametrize("fault", ["device", "kernel"])
def test_a_device_fault_leaves_the_seeded_store_standing(run_async,
                                                         tmp_path, fault):
    """The sink's finalize fails on a device trigger: the seed's disk
    store stays done and digest-checked, and the partial sink is
    discarded. The port counts the fault by its kind (an intended
    divergence: the JAX daemon only logs it), so that a kernel fault on a
    preheat shows as such."""
    def count(reason):
        return SEED_DEVICE_FAILURES.value(reason)

    async def make(tm, url):
        tid = _task_id(url, digest=SHA)
        before = (count("device"), count("kernel"))

        async def broken(task_id, store):
            if fault == "kernel" and isinstance(tm, PTM):
                raise KernelError("K1 launch failed")
            raise RuntimeError("device copy lost")
        tm.device_sinks.finalize = broken
        await tm.start_seed_task({"url": url, "digest": SHA,
                                  "device": "tpu"})
        counted = (count("device") - before[0], count("kernel") - before[1])
        return {"facts": _facts(tm, tid),
                "sink": tm.device_sinks.get(tid),
                "running": tm.is_task_running(tid)}, counted

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make, sinks=True))
    (j, jcounted), (p, pcounted) = j, p
    assert p == j and preq == jreq
    assert p["facts"]["done"] and not p["facts"]["invalid"]
    assert p["facts"]["digest"] == SHA and p["sink"] is None
    assert jcounted == (0, 0)
    assert pcounted == ((1, 0) if fault == "device" else (0, 1))


def test_a_second_seed_trigger_of_a_completed_task_runs_again(run_async,
                                                              tmp_path):
    """Without a scheduler, a completed seed re-triggered goes through the
    download path again over its complete store: one probe of the origin
    and no body, as the JAX one."""
    async def make(tm, url):
        await tm.start_seed_task({"url": url})
        first = _facts(tm, _task_id(url))
        await tm.start_seed_task({"url": url})
        return {"first": first, "again": _facts(tm, _task_id(url))}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make))
    assert p == j and preq == jreq
    assert p["first"] == p["again"]


# --------------------------------------------------------------------- #
# Stream tasks
# --------------------------------------------------------------------- #

def _stream_request(tm, url: str, rng=None):
    if _jax(tm):
        return JStreamRequest(url=url, range=rng and JRange(*rng))
    return PStreamRequest(url=url, range=rng and PRange(*rng))


def _attrs(attrs: dict) -> dict:
    out = dict(attrs)
    out.pop("peer_id")
    out["local_store"] = out.get("local_store") is not None
    rng = out.get("range")
    out["range"] = None if rng is None else (rng.start, rng.length)
    return out


async def _read(body) -> bytes:
    got = bytearray()
    async for chunk in body:
        got += chunk
    return bytes(got)


async def _until_idle(tm, task_id: str) -> None:
    for _ in range(2000):
        if not tm.is_task_running(task_id):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the background download did not end")


STREAM_CASES = {
    "completed": None,
    "completed-range": (1000, 3 * MB),
    "completed-open": (7 * MB, -1),
    "live": None,
    "live-range": (5 * MB + 3, MB),
    "live-open": (9 * MB, -1),
    "partial-range": (100, 5 * MB),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_task_equals_jax(run_async, tmp_path, case):
    rng = STREAM_CASES[case]

    async def make(tm, url):
        tid = _task_id(url)
        if case.startswith("completed"):
            req = (JRequest if _jax(tm) else PRequest)(url=url, output="")
            [p async for p in tm.start_file_task(req)]
        elif case == "partial-range":
            # A store with its first two pieces landed, not done.
            md = (JMetadata if _jax(tm) else PMetadata)(task_id=tid, url=url)
            store = tm.storage.register_task(md)
            store.update_task(content_length=len(CONTENT), piece_size=PIECE,
                              total_piece_count=3)
            for n in (0, 1):
                store.write_piece(n, CONTENT[n * PIECE:(n + 1) * PIECE])
        attrs, body = await tm.start_stream_task(
            _stream_request(tm, url, rng))
        data = await _read(body)
        await _until_idle(tm, tid)
        return {"attrs": _attrs(attrs), "data": data == _want(rng),
                "len": len(data), "facts": _facts(tm, tid),
                "subscribed": tid in tm.broker._tasks}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make))
    assert p == j and preq == jreq
    assert p["data"] and not p["subscribed"]
    assert p["attrs"]["from_reuse"] == (not case.startswith("live"))
    # The completed store's own fetch or the live download's: a probe and
    # one body; the stream itself asks the origin for nothing more.
    assert preq == ({} if case == "partial-range" else {"GET /blob": 2})
    assert p["facts"]["done"] != (case == "partial-range")


def _want(rng) -> bytes:
    if rng is None:
        return CONTENT
    start, length = rng
    return CONTENT[start:] if length < 0 else CONTENT[start:start + length]


def test_an_unstarted_stream_body_releases_its_subscription(run_async,
                                                            tmp_path):
    """``aclose`` before the first iteration unsubscribes from the broker
    (an unstarted generator's ``finally`` would not run); the download
    goes on to the end."""
    async def make(tm, url):
        tid = _task_id(url)
        attrs, body = await tm.start_stream_task(_stream_request(tm, url))
        subscribed = tid in tm.broker._tasks
        await body.aclose()
        released = tid not in tm.broker._tasks
        await _until_idle(tm, tid)
        return {"attrs": _attrs(attrs), "subscribed": subscribed,
                "released": released, "facts": _facts(tm, tid)}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make))
    assert p == j and preq == jreq
    assert p["subscribed"] and p["released"] and p["facts"]["done"]


@pytest.mark.parametrize("rng", [(0, 10), (5, -1), (0, -1), (3, 0)])
@pytest.mark.parametrize("length", [-1, 0, 4, 100])
def test_resolve_range_equals_jax(rng, length):
    j = JTM._resolve_range(JRange(*rng), length)
    p = PTM._resolve_range(PRange(*rng), length)
    assert (p.start, p.length) == (j.start, j.length)
    assert PTM._resolve_range(None, length) is None


# --------------------------------------------------------------------- #
# Ranged prefetch
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("prefetch", [True, False],
                         ids=["prefetch", "no-prefetch"])
def test_a_ranged_miss_prefetches_the_whole_task(run_async, tmp_path,
                                                 prefetch):
    """A ranged request to a file misses the local parent: the ranged task
    fetches its slice and, with ``prefetch``, the whole task lands in the
    background; the next overlapping range is then exported off it."""
    async def make(tm, url):
        parent = _task_id(url)
        out = tmp_path / ("jax" if _jax(tm) else "port")
        rq = JRequest if _jax(tm) else PRequest
        meta = JMeta if _jax(tm) else PMeta
        rg = JRange if _jax(tm) else PRange

        def ranged(suffix: str, header: str):
            req = rq(url=url, output=str(out) + suffix,
                     meta=meta(range=header))
            req.range = rg.parse_http(header)
            return req
        first = [p async for p in tm.start_file_task(
            ranged(".a", "bytes=1000-1999"))][-1]
        await _until_idle(tm, parent)
        second = [p async for p in tm.start_file_task(
            ranged(".b", "bytes=1500-2499"))][-1]
        return {"first": (first.state, first.from_reuse),
                "second": (second.state, second.from_reuse),
                "parent": _facts(tm, parent),
                "a": (out.parent / (out.name + ".a")).read_bytes()
                == CONTENT[1000:2000],
                "b": (out.parent / (out.name + ".b")).read_bytes()
                == CONTENT[1500:2500]}

    (j, jreq), (p, preq) = run_async(_both(tmp_path, make,
                                           prefetch=prefetch))
    assert p == j and preq == jreq
    assert p["a"] and p["b"]
    assert (p["parent"] is not None) == prefetch
    assert p["second"] == ("done", prefetch)
    if prefetch:
        assert p["parent"]["done"]
