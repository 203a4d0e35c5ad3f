"""The port's dataset plane against the JAX package's.

The tar indexer (index JSON bytes for USTAR, GNU and PAX shards under any
feed chunking, and the same typed errors), the epoch plans, the
pod-sharded loader over the reference gateway (``start_gateway_fixture``:
a real ``TaskManager`` behind the object gateway, the port's ``Dfstore``
beside the JAX one), the index resolutions (built, hit, stale, corrupt),
``DaemonRangeFetcher`` on the same task manager, ``DeviceFeed`` on the
CPU over the port's loader, the buffer pool, and a cut or cancelled epoch
that leaves no span buffer out. Tolerance 0: bytes, orders and counts are
compared for equality.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import tarfile

import numpy as np
import pytest
import torch

from dragonfly2_tpu.client.dfstore import Dfstore as JStore
from dragonfly2_tpu.dataset import device_feed as jfeed
from dragonfly2_tpu.dataset import loader as jloader
from dragonfly2_tpu.dataset import shard_reader as jreader
from dragonfly2_tpu.dataset import tar_index as jindex
from dragonfly2_tpu.pkg import bufpool as jbufpool
from dragonfly2_tpu.pkg.testing import start_gateway_fixture
from dragonfly2_tpu_torch import dataset as pdataset
from dragonfly2_tpu_torch.client.dfstore import Dfstore as PStore
from dragonfly2_tpu_torch.dataset import loader as ploader
from dragonfly2_tpu_torch.dataset import shard_reader as preader
from dragonfly2_tpu_torch.dataset import tar_index as pindex
from dragonfly2_tpu_torch.pkg import bufpool as pbufpool
from tests.test_dataset import expected_payload, make_shard
from tests.test_dataset_index import make_tar, webdataset_entries
from tests.test_torch_dfstore import _RawServer


def _index_both(data: bytes, chunk: int, shard: str = "s"):
    out = []
    for mod in (jindex, pindex):
        try:
            ix = mod.TarIndexer()
            for i in range(0, len(data), chunk):
                ix.feed(data[i:i + chunk])
            out.append(("ok", ix.finish(shard).to_json_bytes()))
        except Exception as e:   # compared between the two indexers
            out.append(("raised", type(e).__name__, str(e)))
    return out


# -- the tar index -------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, 511, 512, 513, 1 << 16, 1 << 30])
@pytest.mark.parametrize("fmt", [tarfile.USTAR_FORMAT, tarfile.GNU_FORMAT,
                                 tarfile.PAX_FORMAT],
                         ids=["ustar", "gnu", "pax"])
def test_index_json_equals_the_jax_index(fmt, chunk):
    entries = webdataset_entries(6) + [
        ("d/" + "x" * 120 + ".jpg", b"long" * 9),
        ("alias.jpg", None, tarfile.SYMTYPE, "000001.jpg"),
        ("hard.jpg", None, tarfile.LNKTYPE, "000002.jpg")]
    if fmt == tarfile.USTAR_FORMAT:
        entries = entries[:6 * 2]   # no long names in plain ustar
    data = make_tar(entries, fmt=fmt)
    want, got = _index_both(data, chunk, "train-3.tar")
    assert want[0] == "ok" and got == want


ARCHIVES = {
    "pax non-ascii": make_tar([("émoji/" + "x" * 120 + ".jpg", b"d" * 7)],
                              fmt=tarfile.PAX_FORMAT),
    "empty": make_tar([]),
    "no end blocks": make_tar(webdataset_entries(2))[:512 * 5],
    "no final padding": make_tar(webdataset_entries(3))[:512 * 10 + 2],
    "truncated mid-data": make_tar(webdataset_entries(3))[:512 * 9 + 40],
    "truncated mid-header": make_tar(webdataset_entries(2))[:100],
    "truncated mid-extension": make_tar([("n" * 150 + ".jpg", b"x")],
                                        fmt=tarfile.GNU_FORMAT)[:512 + 64],
    "bad checksum": bytes([0x30 ^ 0xFF]) + make_tar(webdataset_entries(1))[1:],
    "lone zero block": (make_tar(webdataset_entries(1))[:1024] + bytes(512)
                        + make_tar(webdataset_entries(1))[1024:]),
    "bad pax": make_tar([("p.jpg", b"y")], fmt=tarfile.PAX_FORMAT)
    .replace(b"path=", b"path\x00"),
}


@pytest.mark.parametrize("name", list(ARCHIVES))
def test_archives_index_or_raise_as_the_jax_indexer(name):
    data = ARCHIVES[name]
    for chunk in (1, 513, len(data) or 1):
        want, got = _index_both(data, chunk)
        assert got == want, (name, chunk)
    if name.startswith("truncated"):
        assert want[1] == "TruncatedShardError"


@pytest.mark.parametrize("raw", [
    b"not json",
    json.dumps({"v": 99, "shard": "s", "size": 0, "members": [],
                "samples": []}).encode(),
    json.dumps({"v": 1, "shard": "s", "size": 0, "members": [],
                "samples": [["k", [["jpg", 0]]]]}).encode(),
], ids=["garbage", "version", "member-out-of-range"])
def test_index_json_errors_match(raw):
    errs = []
    for mod in (jindex, pindex):
        with pytest.raises(mod.TarIndexError) as e:
            mod.ShardIndex.from_json_bytes(raw)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def test_index_round_trips_and_reads_the_jax_json():
    data = make_tar(webdataset_entries(4) + [
        ("alias.jpg", None, tarfile.SYMTYPE, "000000.jpg")])
    raw = jindex.index_tar_bytes(data, "t.tar").to_json_bytes()
    idx = pindex.ShardIndex.from_json_bytes(raw)
    assert idx.to_json_bytes() == raw
    assert pindex.index_tar_bytes(data, "t.tar").to_json_bytes() == raw
    assert pindex.index_object_key("a/b.tar") == \
        jindex.index_object_key("a/b.tar") == ".dfidx/a/b.tar.json"
    assert [m.name for _, m in idx.members_of(idx.samples[1], ("cls",))] \
        == ["000001.cls"]


# -- the epoch plan ------------------------------------------------------------

@pytest.mark.parametrize("interleave", [1, 2, 4])
@pytest.mark.parametrize("hosts", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 5, 123])
def test_plan_host_epoch_equals_the_jax_plan(seed, hosts, interleave):
    counts = [17, 3, 0, 25, 8, 40]
    union = []
    for host in range(hosts):
        for epoch in (0, 1):
            jo = jloader.LoaderOptions(seed=seed, num_hosts=hosts,
                                       host_id=host, interleave=interleave)
            po = ploader.LoaderOptions(seed=seed, num_hosts=hosts,
                                       host_id=host, interleave=interleave)
            got = ploader.plan_host_epoch(counts, po, epoch)
            assert got == jloader.plan_host_epoch(counts, jo, epoch)
            if epoch == 0:
                union += got
    assert sorted(union) == sorted(
        (s, k) for s, n in enumerate(counts) for k in range(n))
    flat = ploader.epoch_order(counts, seed, 2)
    assert flat == jloader.epoch_order(counts, seed, 2)
    assert ploader.host_partition(flat, hosts, 0) == \
        jloader.host_partition(flat, hosts, 0)
    assert ploader.interleave_shards(flat, interleave) == \
        jloader.interleave_shards(flat, interleave)


@pytest.mark.parametrize("kw", [{"num_hosts": 0}, {"num_hosts": 2,
                                                   "host_id": 2},
                                {"host_id": -1}])
def test_loader_options_refuse_as_the_jax_options(kw):
    errs = []
    for mod in (jloader, ploader):
        with pytest.raises(mod.LoaderError) as e:
            mod.LoaderOptions(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the loader over the reference gateway -------------------------------------

KEYS = [f"train-{s:05d}.tar" for s in range(3)]


async def _put_shards(store, bucket: str, n_samples: int = 7) -> dict:
    await store.create_bucket(bucket)
    shards = {}
    for s, key in enumerate(KEYS):
        shards[key] = make_shard(s, n_samples)
        await store.put_object(bucket, key, shards[key], mode="write_back")
    return shards


def _resolutions(counter, read) -> dict:
    return {r: read(counter.labels(r)) for r in ("built", "hit", "stale",
                                                 "corrupt")}


def _jvalue(child) -> float:
    return child._value.get()


def _pvalue(child) -> float:
    return child._metric.value(*child._key)


def test_loader_epochs_equal_the_jax_loader(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = JStore(fx.endpoint), PStore(fx.endpoint)
        try:
            await _put_shards(js, "j")
            await _put_shards(js, "p")
            j0 = _resolutions(jindex.INDEX_FETCHES, _jvalue)
            p0 = _resolutions(pindex.INDEX_FETCHES, _pvalue)
            opts = dict(seed=9, interleave=2, readahead=3)
            jl = await jloader.PodShardedLoader(
                js, "j", KEYS,
                options=jloader.LoaderOptions(**opts)).prepare()
            pl = await ploader.PodShardedLoader(
                ps, "p", KEYS,
                options=ploader.LoaderOptions(**opts)).prepare()
            for key in KEYS:     # each built and published its own index
                assert await ps.get_object("p", pindex.index_object_key(key)) \
                    == await js.get_object("j", jindex.index_object_key(key))
            assert pl.num_samples == jl.num_samples == 21
            for epoch in (0, 1):
                assert pl.plan(epoch) == jl.plan(epoch)
                want = [s async for s in jl.epoch(epoch)]
                got = [s async for s in pl.epoch(epoch)]
                assert got == want
                assert [s["__key__"] for s in got] == \
                    [k for _, k in pl.plan(epoch)]
            for s in got:
                sh, i = int(s["__key__"][:3]), int(s["__key__"][4:])
                assert s["jpg"] == expected_payload(sh, i)
            # A fresh loader hits the published indexes (the JAX package's
            # too: both clients read each other's index objects).
            again = await ploader.PodShardedLoader(ps, "j", KEYS).prepare()
            assert [i.to_json_bytes() for i in again.indexes] == \
                [i.to_json_bytes() for i in jl.indexes]
            jd = {r: v - j0[r] for r, v in _resolutions(
                jindex.INDEX_FETCHES, _jvalue).items()}
            pd = {r: v - p0[r] for r, v in _resolutions(
                pindex.INDEX_FETCHES, _pvalue).items()}
            assert jd == {"built": 3, "hit": 0, "stale": 0, "corrupt": 0}
            assert pd == {"built": 3, "hit": 3, "stale": 0, "corrupt": 0}
            assert pl.pool.stats()["outstanding"] == 0
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)


def test_exactly_once_over_four_hosts(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        ps = PStore(fx.endpoint)
        try:
            await _put_shards(ps, "w", n_samples=5)
            per_host = []
            for h in range(4):
                po = ploader.LoaderOptions(seed=42, num_hosts=4, host_id=h,
                                           interleave=2, readahead=3)
                jo = jloader.LoaderOptions(seed=42, num_hosts=4, host_id=h,
                                           interleave=2, readahead=3)
                loader = await ploader.PodShardedLoader(
                    ps, "w", KEYS, options=po).prepare()
                counts = [i.num_samples for i in loader.indexes]
                assert ploader.plan_host_epoch(counts, po, 0) == \
                    jloader.plan_host_epoch(counts, jo, 0)
                got = [s["__key__"] async for s in loader.epoch(0)]
                assert got == [k for _, k in loader.plan(0)]
                per_host.append(got)
            union = [k for host in per_host for k in host]
            assert sorted(union) == sorted(
                f"{s:03d}/{i:05d}" for s in range(3) for i in range(5))
        finally:
            await ps.close()
            await fx.aclose()

    run_async(run(), timeout=120)


@pytest.mark.parametrize("cached", ["stale", "corrupt", "other shard"])
def test_index_resolutions_match_the_jax_function(run_async, tmp_path,
                                                  cached):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = JStore(fx.endpoint), PStore(fx.endpoint)
        try:
            shards = {b: await _put_shards(js, b, 4) for b in ("j", "p")}
            key = KEYS[0]
            bad = {"stale": jindex.index_tar_bytes(
                       make_shard(0, 90), key).to_json_bytes(),
                   "corrupt": b"{not an index",
                   "other shard": jindex.index_tar_bytes(
                       shards["j"][key], "elsewhere").to_json_bytes()}[cached]
            for b in ("j", "p"):
                await js.put_object(b, jindex.index_object_key(key), bad,
                                    mode="write_back")
            j0 = _resolutions(jindex.INDEX_FETCHES, _jvalue)
            p0 = _resolutions(pindex.INDEX_FETCHES, _pvalue)
            ji = await jindex.fetch_or_build_index(js, "j", key)
            pi = await pindex.fetch_or_build_index(ps, "p", key)
            assert pi.to_json_bytes() == ji.to_json_bytes()
            jd = {r: v - j0[r] for r, v in _resolutions(
                jindex.INDEX_FETCHES, _jvalue).items()}
            pd = {r: v - p0[r] for r, v in _resolutions(
                pindex.INDEX_FETCHES, _pvalue).items()}
            assert pd == jd and pd["built"] == 1
            # Rebuilt and published again: the next resolution is a hit.
            assert (await pindex.fetch_or_build_index(ps, "p", key)
                    ).to_json_bytes() == ji.to_json_bytes()
            with pytest.raises(Exception) as je:
                await jindex.fetch_or_build_index(js, "j", "missing.tar")
            with pytest.raises(Exception) as pe:
                await pindex.fetch_or_build_index(ps, "p", "missing.tar")
            assert (type(pe.value).__name__, pe.value.status, str(pe.value)) \
                == (type(je.value).__name__, je.value.status,
                    str(je.value).replace("object j/", "object p/"))
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)


def test_daemon_range_fetcher_matches_the_jax_fetcher(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js = JStore(fx.endpoint)
        try:
            shards = await _put_shards(js, "d", 6)
            key = KEYS[1]
            idx = pindex.index_tar_bytes(shards[key], key)
            url = fx.object_url("d", key)
            jr = jreader.ShardReader(jreader.DaemonRangeFetcher(
                fx.tm, url, tag="d"), jindex.index_tar_bytes(shards[key], key))
            pr = preader.ShardReader(preader.DaemonRangeFetcher(
                fx.tm, url, tag="d"), idx)
            # JAX cold then the port's reuse on sample 2; the other way on 4.
            for first, second, i in ((jr, pr, 2), (pr, jr, 4)):
                a = await first.read_sample(first.index.samples[i])
                b = await second.read_sample(second.index.samples[i])
                assert a == b
                assert a["jpg"] == expected_payload(1, i)
            assert jr.fetcher.stats == pr.fetcher.stats == \
                {"cold": 1, "reuse": 1}
            assert pr.sample_spans(idx.samples[3]) == \
                jr.sample_spans(jr.index.samples[3])
            assert pr.pool.stats()["outstanding"] == 0
        finally:
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)


def test_device_feed_over_the_loader_equals_the_jax_feed(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = JStore(fx.endpoint), PStore(fx.endpoint)
        try:
            await _put_shards(js, "f", 9)
            opts = dict(seed=3, interleave=3, readahead=4)
            jl = await jloader.PodShardedLoader(
                js, "f", KEYS, options=jloader.LoaderOptions(**opts)).prepare()
            pl = await ploader.PodShardedLoader(
                ps, "f", KEYS, options=ploader.LoaderOptions(**opts)).prepare()
            record = 64 + 8     # make_shard's largest jpg payload
            jf = jfeed.DeviceFeed("jpg", record, 4, pad=True, force_hbm=True)
            pf = pdataset.DeviceFeed("jpg", record, 4, pad=True, device="cpu")
            want = [b async for b in jf.batches(jl.epoch(0))]
            got = [b async for b in pf.batches(pl.epoch(0))]
            assert [b.keys for b in got] == [b.keys for b in want]
            assert [len(b.keys) for b in got] == [4] * 6 + [3]
            for g, w in zip(got, want):
                assert isinstance(g.array, torch.Tensor) and g.on_device
                np.testing.assert_array_equal(g.array.numpy(),
                                              np.asarray(w.array))
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)


# -- span buffers: cut epochs and cancelled reads ------------------------------

def test_a_cut_epoch_leaves_no_span_buffer_out(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        ps = PStore(fx.endpoint)
        try:
            await _put_shards(ps, "c", 8)
            loader = await ploader.PodShardedLoader(
                ps, "c", KEYS, options=ploader.LoaderOptions(
                    readahead=6)).prepare()
            async with contextlib.aclosing(loader.epoch(0)) as samples:
                n = 0
                async for _ in samples:
                    n += 1
                    if n == 5:
                        break
            stats = loader.pool.stats()
            assert stats["outstanding"] == 0 and stats["acquires"] >= 5
            assert ploader.READAHEAD_DEPTH.value() == 0
        finally:
            await ps.close()
            await fx.aclose()

    run_async(run(), timeout=120)


def test_a_cancelled_sample_read_returns_its_buffer_unwritten(run_async):
    """A read cancelled mid-body: once read_sample returns, its span
    buffer is back in the pool, and the bytes still arriving are never
    written into it."""
    n = 64 << 10
    body = bytes([0x5A]) * n
    idx = pindex.ShardIndex(shard="s.tar", size=n + 1024, members=[
        pindex.TarMember("k.bin", 0, 512, n)], samples=[
        pindex.Sample("k", (("bin", 0),))])

    async def run():
        srv = _RawServer(body, first=1024)
        store = PStore(srv.endpoint)
        pool = pbufpool.BufferPool(name="test_cancel")
        reader = preader.ShardReader(
            preader.GatewayRangeFetcher(store, "b", "s.tar"), idx, pool=pool)
        try:
            task = asyncio.ensure_future(reader.read_sample(idx.samples[0]))
            while not srv.sent_first.is_set():
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.1)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            assert pool.stats()["outstanding"] == 0
            parked = pool.acquire(n)       # the very buffer of the read
            snapshot = bytes(parked)
            srv.release.set()
            await asyncio.sleep(0.3)
            assert bytes(parked) == snapshot
            assert snapshot[:1024] == body[:1024]
            assert snapshot[1024:] == bytes(n - 1024)
            pool.release(parked)
        finally:
            await store.close()
            srv.close()

    run_async(run())


def test_buffer_pool_matches_the_jax_pool():
    pools = [jbufpool.BufferPool(max_retained_bytes=300, name="tj"),
             pbufpool.BufferPool(max_retained_bytes=300, name="tp")]
    trace = []
    for pool in pools:
        a, b = pool.acquire(100), pool.acquire(250)
        a[:3] = b"abc"
        pool.release(a)
        c = pool.acquire(50)          # reuses a's buffer
        same, n = bytes(c[:3]) == b"abc", len(c)
        pool.release(b)
        pool.release(c)               # 250 + 100 > 300: dropped
        with pytest.raises(ValueError):
            pool.release(c)           # a second release is refused
        pool.release(b"plain bytes")  # not pooled: dropped
        trace.append((same, n, pool.stats()))
    assert trace[0] == trace[1]
    assert pbufpool.BUFPOOL_RETAINED.value("tp") == 250 == \
        trace[1][2]["retained_bytes"]
    assert pbufpool.BUFPOOL_ACQUIRES.value("tp", "pooled") == 1
    assert pbufpool.BUFPOOL_RELEASES.value("tp", "dropped") == 1


def test_metric_families_keep_the_jax_names():
    assert (pindex.INDEX_FETCHES.name, pindex.INDEX_FETCHES.labelnames) == \
        ("dataset_index_total", ("result",))
    assert (preader.RANGE_READS.name, preader.RANGE_READS.labelnames) == \
        ("dataset_range_reads_total", ("result",))
    assert (preader.DATASET_BYTES.name, preader.DATASET_BYTES.labelnames) \
        == ("dataset_bytes_total", ("direction",))
    assert [m.name for m in (ploader.SAMPLES, ploader.READAHEAD_DEPTH,
                             ploader.EPOCHS)] == [
        "dataset_samples_total", "dataset_readahead_depth",
        "dataset_epochs_total"]
    assert type(ploader.READAHEAD_DEPTH).__name__ == "Gauge"
    assert (pbufpool.BUFPOOL_RETAINED.name,
            pbufpool.BUFPOOL_RETAINED.labelnames) == \
        ("bufpool_retained_bytes", ("pool",))
    for name in ("Sample", "ShardIndex", "TarIndexer", "TarIndexError",
                 "TarMember", "TruncatedShardError", "fetch_or_build_index",
                 "index_tar_bytes", "DaemonRangeFetcher",
                 "GatewayRangeFetcher", "ShardReadError", "ShardReader",
                 "LoaderError", "LoaderOptions", "PodShardedLoader",
                 "epoch_order", "host_partition", "interleave_shards",
                 "plan_host_epoch", "DeviceFeed", "DeviceBatch",
                 "DeviceFeedError"):
        assert hasattr(pdataset, name), name
