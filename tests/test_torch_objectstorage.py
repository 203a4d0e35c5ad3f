"""The port's object gateway against the JAX one.

Both gateways serve twin ``fs`` roots, each on its own package's task
manager (the JAX one through ``start_gateway_fixture``), with a device
sink manager on the CPU. Every route is asked the same requests, and the
answers must agree: the status, the headers that carry meaning
(``Content-Type``, ``Content-Length``, ``Content-Range``, ``Allow``,
``Accept-Ranges`` and the ``X-Dragonfly-*`` ones) and the body, with each
root's path and the values made from the clock (``created_at``, ETags)
put aside. Task ids cannot be equal across two roots (the object's
``file://`` URL is part of the id), so each gateway's is held to the id
its own URL gives (``idgen.task_id_v1``, tag = the bucket). Then: PUT
replication's spec to a fake ``trigger_seed``; ``?device=tpu`` on a CPU
sink with ``device_verified``; the port's and the JAX ``Dfstore`` against
the port's gateway; a client that cuts a streamed GET leaves no store
pinned; a prefetch outlives its client; no ``df-`` thread outlives the
gateway. Content comes from numpy seeds; tolerance 0.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from dragonfly2_tpu.client import dfstore as jstore
from dragonfly2_tpu.pkg import idgen as jidgen
from dragonfly2_tpu.pkg.testing import start_gateway_fixture
from dragonfly2_tpu_torch.client import dfstore as pstore
from dragonfly2_tpu_torch.daemon.objectstorage import (
    OBJ_BYTES,
    OBJ_REQUESTS,
    ObjectStorageService,
)
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManager,
    PieceManagerOption,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager
from dragonfly2_tpu_torch.daemon.transport import P2PTransport
from dragonfly2_tpu_torch.pkg.objectstorage import (
    ObjectStorageError,
    new_client,
)
from dragonfly2_tpu_torch.pkg.objectstorage.fs import FSObjectStorage
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption

DATA = np.random.default_rng(21).integers(
    0, 256, (3 << 20) + 4321, dtype=np.uint8).tobytes()
MEANINGFUL = ("content-type", "content-length", "content-range", "allow",
              "accept-ranges", "x-dragonfly-digest", "x-dragonfly-from-reuse")


class PortGateway:
    """The port's gateway over ``workdir/buckets`` on a port
    ``TaskManager`` whose stores live in ``workdir/p2p``, as
    ``start_gateway_fixture`` builds the JAX one."""

    def __init__(self, workdir, *, rate: int = 0, **svc_kwargs):
        self.backend = FSObjectStorage(root=os.path.join(workdir, "buckets"))
        self.storage = StorageManager(
            StorageOption(data_dir=os.path.join(workdir, "p2p")))
        self.sinks = DeviceSinkManager(device="cpu")
        self.tm = TaskManager(
            self.storage, PieceManager(PieceManagerOption(concurrency=2)),
            device_sinks=self.sinks, total_rate_limit=rate)
        self.svc = ObjectStorageService(self.backend, P2PTransport(self.tm),
                                        **svc_kwargs)
        self.port = 0

    async def start(self) -> "PortGateway":
        self.port = await self.svc.serve("127.0.0.1", 0)
        return self

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def object_url(self, bucket: str, key: str) -> str:
        return self.backend.object_url(bucket, key)

    async def aclose(self) -> None:
        await self.svc.close()
        self.sinks.close(wait=True)
        self.storage.close()


def _request(port: int, method: str, path: str, body=None,
             headers=None) -> tuple[int, dict, bytes]:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _answer(result, root: str, path: str = "") -> dict:
    status, headers, body = result
    out = {"status": status,
           "headers": {k: v for k, v in headers.items() if k in MEANINGFUL},
           "etag": bool(headers.get("etag"))}
    if path.split("?")[0] == "/buckets" or "/metadatas" in path:
        # The listings' lengths follow the clock (created_at, ETags).
        out["headers"].pop("content-length", None)
    text = body.replace(root.encode(), b"<root>")
    if out["headers"].get("content-length") == str(len(body)):
        out["headers"]["content-length"] = str(len(text))
    try:
        data = json.loads(text)
    except ValueError:
        out["body"] = text
        return out
    for item in data if isinstance(data, list) else data.get(
            "metadatas", []) if isinstance(data, dict) else []:
        for k in ("created_at", "etag"):
            if k in item:
                item[k] = bool(item[k])
    if isinstance(data, dict):
        data.pop("task_id", None)
    out["body"] = data
    return out


# (method, path, body, headers): every route, on success and on failure.
REQUESTS = [
    ("GET", "/healthy", None, None), ("HEAD", "/healthy", None, None),
    ("GET", "/buckets", None, None), ("POST", "/buckets", None, None),
    ("PUT", "/buckets/b", None, None), ("PUT", "/buckets/.x", None, None),
    ("GET", "/buckets/b", None, None), ("HEAD", "/buckets", None, None),
    ("PUT", "/buckets/b/objects/k/data.bin", DATA, None),
    ("PUT", "/buckets/b/objects/t.json?mode=write_back", b'{"a": 1}',
     {"Content-Type": "application/json; charset=utf-8"}),
    ("PUT", "/buckets/missing/objects/x", b"abc", None),
    ("HEAD", "/buckets/b/objects/k/data.bin", None, None),
    ("HEAD", "/buckets/b/objects/t.json", None, None),
    ("HEAD", "/buckets/b/objects/nope", None, None),
    ("GET", "/buckets/b/metadatas?prefix=k", None, None),
    ("GET", "/buckets/b/metadatas?marker=k/data.bin&limit=5", None, None),
    ("GET", "/buckets/zz/metadatas", None, None),
    ("POST", "/buckets/b/metadatas", None, None),
    ("GET", "/buckets/b/objects/k/data.bin", None, None),
    ("GET", "/buckets/b/objects/k/data.bin", None, {"Range": "bytes=2-40000"}),
    ("GET", "/buckets/b/objects/k/data.bin", None, {"Range": "bytes=3145000-"}),
    ("GET", "/buckets/b/objects/k/data.bin", None,
     {"Range": "bytes=9999999-10000000"}),
    ("GET", "/buckets/b/objects/k/data.bin", None, {"Range": "bytes=abc"}),
    ("GET", "/buckets/b/objects/nope", None, None),
    ("GET", "/buckets/b/objects/", None, None),
    ("GET", "/buckets/b/objects/k/data.bin?ranged_task=1", None,
     {"Range": "bytes=100-70000"}),
    ("GET", "/buckets/b/objects/k/data.bin?ranged_task=1", None,
     {"Range": "bytes=100-70000"}),
    ("GET", "/buckets/b/objects/k/data.bin?ranged_task=1", None,
     {"Range": "bytes=x-1"}),
    ("GET", "/buckets/b/objects/nope?ranged_task=1", None,
     {"Range": "bytes=0-9"}),
    ("POST", "/buckets/b/prefetch/k/data.bin", None, None),
    ("POST", "/buckets/b/prefetch/k/data.bin?device=tpu", None, None),
    ("POST", "/buckets/b/prefetch/k/data.bin?device=gpu", None, None),
    ("POST", "/buckets/b/prefetch/k/data.bin?range=10-20", None, None),
    ("POST", "/buckets/b/prefetch/k/data.bin?range=zz", None, None),
    ("POST", "/buckets/b/prefetch/nope?device=tpu", None, None),
    ("GET", "/buckets/b/prefetch/k/data.bin", None, None),
    ("PATCH", "/buckets/b/objects/k/data.bin", None, None),
    ("DELETE", "/buckets/b/objects/t.json", None, None),
    ("DELETE", "/buckets/b/objects/t.json", None, None),
    ("DELETE", "/buckets/zz", None, None),
    ("GET", "/nothing", None, None), ("GET", "/buckets/b/other", None, None),
]


def test_every_route_answers_as_the_jax_gateway(run_async, tmp_path):
    async def run():
        pg = await PortGateway(tmp_path / "port").start()
        jg = await start_gateway_fixture(tmp_path / "jax",
                                         device_sinks=True)
        loop = asyncio.get_running_loop()
        try:
            for method, path, body, headers in REQUESTS:
                got = await loop.run_in_executor(
                    None, _request, pg.port, method, path, body, headers)
                want = await loop.run_in_executor(
                    None, _request, jg.port, method, path, body, headers)
                what = (method, path, headers)
                assert _answer(got, pg.backend.root, path) == _answer(
                    want, jg.backend.root, path), what
                if got[0] in (200, 206) and method == "GET" \
                        and "/objects/" in path:
                    key = path.split("/objects/", 1)[1].split("?")[0]
                    assert got[2] == want[2]
                    rng = (headers or {}).get("Range", "")
                    start = int(rng[6:].split("-")[0]) if rng else 0
                    assert got[2] == DATA[start:start + len(got[2])]
                    if "ranged_task" in path:
                        # Each id is the one its own object URL gives.
                        for (_, h, _), gw in ((got, pg), (want, jg)):
                            assert h["x-dragonfly-task-id"] == \
                                jidgen.task_id_v1(
                                    gw.object_url("b", key), tag="b",
                                    range_header="bytes=100-70000")
                if method == "POST" and got[0] == 200:
                    key = path.split("/prefetch/", 1)[1].split("?")[0]
                    rng = "bytes=10-20" if "range=" in path else ""
                    for (_, _, b), gw in ((got, pg), (want, jg)):
                        assert json.loads(b)["task_id"] == jidgen.task_id_v1(
                            gw.object_url("b", key), tag="b",
                            range_header=rng)
                    if "device=tpu" in path:
                        assert json.loads(got[2])["device_verified"] is True
                        tid = json.loads(got[2])["task_id"]
                        sink = pg.sinks.take(tid)
                        assert bytes(sink.as_bytes_array().numpy()) == DATA
        finally:
            await pg.aclose()
            await jg.aclose()

    run_async(run(), timeout=120)


def test_an_object_without_metadata_answers_as_in_jax(run_async, tmp_path):
    """Objects placed in the root by hand (no sidecar): HEAD and listing."""
    async def run():
        pg = await PortGateway(tmp_path / "port").start()
        jg = await start_gateway_fixture(tmp_path / "jax")
        loop = asyncio.get_running_loop()
        try:
            for gw in (pg, jg):
                os.makedirs(os.path.join(gw.backend.root, "raw", "d"))
                with open(os.path.join(gw.backend.root, "raw", "d", "f"),
                          "wb") as f:
                    f.write(DATA[:1000])
            for method, path in (("HEAD", "/buckets/raw/objects/d/f"),
                                 ("GET", "/buckets/raw/metadatas"),
                                 ("GET", "/buckets/raw/objects/d/f")):
                got, want = [await loop.run_in_executor(
                    None, _request, gw.port, method, path)
                    for gw in (pg, jg)]
                assert _answer(got, pg.backend.root, path) == _answer(
                    want, jg.backend.root, path), (method, path)
        finally:
            await pg.aclose()
            await jg.aclose()

    run_async(run())


def test_put_replicates_the_jax_spec_to_the_seeds(run_async, tmp_path):
    seeds = [{"ip": "10.0.0.1", "port": 1}, {"ip": "10.0.0.2", "port": 2}]

    def recorder(calls: list):
        async def trigger(seed, spec):
            calls.append((seed, spec))
            return seed["port"] == 1
        return trigger

    async def run():
        pcalls, jcalls = [], []
        pg = await PortGateway(tmp_path / "port",
                               get_seed_peers=lambda: seeds,
                               trigger_seed=recorder(pcalls)).start()
        jg = await start_gateway_fixture(tmp_path / "jax",
                                         get_seed_peers=lambda: seeds,
                                         trigger_seed=recorder(jcalls))
        loop = asyncio.get_running_loop()
        try:
            for gw in (pg, jg):
                await loop.run_in_executor(None, _request, gw.port, "PUT",
                                           "/buckets/b")
                for mode in ("write_back", "async_write_back"):
                    st, _, body = await loop.run_in_executor(
                        None, _request, gw.port, "PUT",
                        f"/buckets/b/objects/o-{mode}?mode={mode}",
                        DATA[:5000])
                    assert st == 200
            for _ in range(100):
                if len(pcalls) == len(jcalls) == 4:
                    break
                await asyncio.sleep(0.02)
            for calls, gw in ((pcalls, pg), (jcalls, jg)):
                assert len(calls) == 4
                for seed, spec in calls:
                    key = spec["url"].rsplit("/", 1)[1]
                    assert spec == {
                        "task_id": jidgen.task_id_v1(
                            gw.object_url("b", key), tag="b"),
                        "url": gw.object_url("b", key), "tag": "b",
                        "digest": json.loads(body)["digest"]}
            assert [s for s, _ in pcalls] == [s for s, _ in jcalls]
        finally:
            await pg.aclose()
            await jg.aclose()

    run_async(run())


def test_both_dfstore_clients_on_the_port_gateway(run_async, tmp_path):
    async def run():
        pg = await PortGateway(tmp_path).start()
        js, ps = jstore.Dfstore(pg.endpoint), pstore.Dfstore(pg.endpoint)
        try:
            await js.create_bucket("j")
            await ps.create_bucket("p")
            assert sorted(await ps.list_buckets()) == sorted(
                await js.list_buckets()) == ["j", "p"]
            dj = await js.put_object("j", "a/obj.bin", DATA,
                                     mode="write_back")
            dp = await ps.put_object("p", "a/obj.bin", DATA,
                                     mode="write_back")
            assert dj == dp and dj.startswith("sha256:")
            for bucket in ("j", "p"):
                ij = await js.stat_object(bucket, "a/obj.bin")
                ip = await ps.stat_object(bucket, "a/obj.bin")
                assert dataclasses.asdict(ip) == dataclasses.asdict(ij)
                for rng in ("", "bytes=3-99", "bytes=1048570-"):
                    got = await ps.get_object(bucket, "a/obj.bin", rng)
                    assert got == await js.get_object(bucket, "a/obj.bin",
                                                      rng)
                    start = int(rng[6:].split("-")[0]) if rng else 0
                    assert got == DATA[start:start + len(got)]
                for rng in ("", "5-1048580", "bytes=100-"):
                    parts = [bytes(c) async for c in await ps.stream_object(
                        bucket, "a/obj.bin", rng)]
                    jparts = [bytes(c) async for c in await js.stream_object(
                        bucket, "a/obj.bin", rng)]
                    assert b"".join(parts) == b"".join(jparts)
                assert [dataclasses.asdict(o)
                        for o in await ps.list_objects(bucket, "a/")] == [
                    dataclasses.asdict(o)
                    for o in await js.list_objects(bucket, "a/")]
            for store in (js, ps):
                a1, d1 = await store.read_object_range("j", "a/obj.bin",
                                                       1000, 40000)
                assert d1 == DATA[1000:40000]
            aj, _ = await js.read_object_range("j", "a/obj.bin", 7, 5000)
            ap, _ = await ps.read_object_range("j", "a/obj.bin", 7, 5000)
            assert (aj["from_reuse"], ap["from_reuse"]) == (False, True)
            assert aj["task_id"] == ap["task_id"] == jidgen.task_id_v1(
                pg.object_url("j", "a/obj.bin"), tag="j",
                range_header="bytes=7-4999")
            pj = await js.prefetch_object("j", "a/obj.bin", device="tpu")
            pp = await ps.prefetch_object("j", "a/obj.bin", device="tpu")
            assert pj == pp and pp["device_verified"] is True
            # A streaming copy: a chunked PUT from each client.
            cj = await js.copy_object("j", "a/obj.bin", "a/copy-j")
            cp = await ps.copy_object("j", "a/obj.bin", "a/copy-p",
                                      mode="write_back")
            assert cp == cj == dj
            assert await ps.get_object("j", "a/copy-p") == DATA
            await ps.delete_object("j", "a/copy-p")
            await js.delete_object("j", "a/copy-j")
            assert not await ps.is_object_exist("j", "a/copy-p")
            assert not await js.is_object_exist("j", "a/copy-j")
            for call in (lambda s: s.stat_object("j", "nope"),
                         lambda s: s.get_object("j", "a/obj.bin",
                                                "bytes=9999999-")):
                errs = []
                for store in (js, ps):
                    with pytest.raises(Exception) as e:
                        await call(store)
                    errs.append((e.value.status, str(e.value)))
                assert errs[0] == errs[1]
        finally:
            await ps.close()
            await js.close()
            await pg.aclose()

    run_async(run(), timeout=120)


def _cut_after(port: int, path: str, nbytes: int) -> int:
    """GET ``path`` and close the socket once ``nbytes`` of body came."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        got = b""
        while b"\r\n\r\n" not in got:
            got += s.recv(65536)
        head, body = got.split(b"\r\n\r\n", 1)
        n = len(body)
        while n < nbytes:
            n += len(s.recv(65536))
        return int(head.split()[1])
    finally:
        s.close()


def _connection_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name == "df-gateway"]


async def _until(pred, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.02)


def test_a_client_cutting_a_streamed_get_leaves_no_pin(run_async, tmp_path):
    """A cold GET of three 4 MiB pieces under a 4 MiB/s download streams
    from the running task; the client goes away after 256 KiB. Once the
    task is done no store is pinned, the gateway serves on, and its
    threads end with it."""
    big = np.random.default_rng(22).integers(
        0, 256, (12 << 20) + 7, dtype=np.uint8).tobytes()

    async def run():
        pg = await PortGateway(tmp_path, rate=4 << 20).start()
        loop = asyncio.get_running_loop()
        try:
            os.makedirs(os.path.join(pg.backend.root, "b"))
            with open(os.path.join(pg.backend.root, "b", "big"), "wb") as f:
                f.write(big)
            before = OBJ_REQUESTS.value("GET", "ok")
            sent0 = OBJ_BYTES.value("out")
            status = await loop.run_in_executor(
                None, _cut_after, pg.port, "/buckets/b/objects/big", 256 << 10)
            assert status == 200
            tid = jidgen.task_id_v1(pg.object_url("b", "big"), tag="b")
            await _until(lambda: pg.storage.find_completed_task(tid)
                         is not None)
            store = pg.storage.find_completed_task(tid)
            # The connection's thread ends once its write fails.
            await _until(lambda: not _connection_threads())
            await _until(lambda: not store.pinned)
            assert OBJ_REQUESTS.value("GET", "ok") == before
            assert OBJ_BYTES.value("out") - sent0 < len(big)
            # Served whole once complete (sendfile), and cut there too.
            got = await loop.run_in_executor(None, _request, pg.port, "GET",
                                             "/buckets/b/objects/big")
            assert got[0] == 200 and got[2] == big
            assert await loop.run_in_executor(
                None, _cut_after, pg.port, "/buckets/b/objects/big",
                64 << 10) == 200
            await _until(lambda: not store.pinned)
        finally:
            await pg.aclose()
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("df-gateway")]

    run_async(run(), timeout=120)


def test_a_prefetch_outlives_its_client(run_async, tmp_path):
    async def run():
        pg = await PortGateway(tmp_path, rate=1 << 20).start()
        loop = asyncio.get_running_loop()
        try:
            os.makedirs(os.path.join(pg.backend.root, "b"))
            with open(os.path.join(pg.backend.root, "b", "o"), "wb") as f:
                f.write(DATA)

            def hang_up() -> None:
                s = socket.create_connection(("127.0.0.1", pg.port))
                s.sendall(b"POST /buckets/b/prefetch/o?device=tpu HTTP/1.1"
                          b"\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
                s.close()

            await loop.run_in_executor(None, hang_up)
            tid = jidgen.task_id_v1(pg.object_url("b", "o"), tag="b")
            await _until(lambda: pg.storage.find_completed_task(tid)
                         is not None)
            await _until(lambda: pg.sinks.get(tid) is not None
                         and pg.sinks.get(tid).verified)
            assert bytes(pg.sinks.take(tid).as_bytes_array().numpy()) == DATA
        finally:
            await pg.aclose()

    run_async(run(), timeout=120)


def test_new_client_builds_fs_and_names_the_unported_backends(tmp_path):
    assert isinstance(new_client("fs", root=str(tmp_path)), FSObjectStorage)
    for name in ("s3", "gcs", "oss", "obs"):
        with pytest.raises(ObjectStorageError, match=f"'{name}' is not "
                           "ported yet"):
            new_client(name, endpoint="http://x")
    with pytest.raises(ObjectStorageError, match="unknown"):
        new_client("ftp")
