"""The port's object-gateway client against the JAX package's.

``dragonfly2_tpu_torch.client.dfstore.Dfstore`` speaks the gateway's HTTP
through the standard library; the JAX client rides ``aiohttp``. Both talk
to the same reference gateway (``start_gateway_fixture``: a real
``TaskManager`` behind ``ObjectStorageService``) and must give the same
bytes, ``ObjectInfo``, ranged-task attributes (cold, then reuse), digests
and ``DfstoreError`` statuses and texts. The subset the dataset plane and
``fetch_or_build_manifest`` use runs against ``chip_smoke.py``'s stand-in
gateway too, which must answer as the reference does. Then the transport's
own rules: worker threads named ``df-``, keep-alive, a request timeout,
over- and under-delivery, and a cancelled ranged read that leaves its
buffer untouched once it returns. Tolerance 0: bytes and texts are
compared for equality.
"""

from __future__ import annotations

import asyncio
import dataclasses
import socket
import threading
import time

import pytest

import chip_smoke
from dragonfly2_tpu.client import dfstore as jstore
from dragonfly2_tpu.pkg.testing import start_gateway_fixture
from dragonfly2_tpu_torch.client import dfstore as pstore
from dragonfly2_tpu_torch.pkg.bufpool import await_worker

DATA = bytes((i * 7 + 3) % 256 for i in range((2 << 20) + 12345))


def _err(e: Exception) -> tuple:
    return type(e).__name__, getattr(e, "status", None), str(e)


async def _outcome(coro):
    try:
        return "ok", await coro
    except Exception as e:   # compared between the two clients
        return "raised", _err(e)


async def _gather_stream(it) -> tuple[bytes, list[int]]:
    sizes, parts = [], []
    async for c in it:
        sizes.append(len(c))
        parts.append(c)
    return b"".join(parts), sizes


# -- every method against the JAX client on the reference gateway -----------

def test_every_method_matches_the_jax_client(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = jstore.Dfstore(fx.endpoint), pstore.Dfstore(fx.endpoint)
        try:
            await js.create_bucket("j")
            await ps.create_bucket("p")
            assert sorted(await ps.list_buckets()) == sorted(
                await js.list_buckets()) == ["j", "p"]
            for store, bucket in ((js, "j"), (ps, "p")):
                await store.create_bucket(bucket + "x")
                await store.delete_bucket(bucket + "x")
            # The same object put by each client: the same digest.
            dj = await js.put_object("j", "a/obj.bin", DATA,
                                     mode="write_back")
            dp = await ps.put_object("p", "a/obj.bin", DATA,
                                     mode="write_back")
            assert dj == dp and dj.startswith("sha256:")
            for bucket in ("j", "p"):
                ij = await js.stat_object(bucket, "a/obj.bin")
                ip = await ps.stat_object(bucket, "a/obj.bin")
                assert isinstance(ip, pstore.ObjectInfo)
                assert dataclasses.asdict(ip) == dataclasses.asdict(ij)
                assert ip.content_length == len(DATA) and ip.digest == dj
                assert await ps.is_object_exist(bucket, "a/obj.bin")
                for rng in ("", "bytes=3-99", "bytes=1048570-"):
                    assert await ps.get_object(bucket, "a/obj.bin", rng) \
                        == await js.get_object(bucket, "a/obj.bin", rng)
                for rng in ("", "5-1048580", "bytes=100-"):
                    got, sizes = await _gather_stream(
                        await ps.stream_object(bucket, "a/obj.bin", rng))
                    want, _ = await _gather_stream(
                        await js.stream_object(bucket, "a/obj.bin", rng))
                    assert got == want
                    assert all(n == pstore.STREAM_CHUNK for n in sizes[:-1])
                assert [dataclasses.asdict(o)
                        for o in await ps.list_objects(bucket, "a/")] == [
                    dataclasses.asdict(o)
                    for o in await js.list_objects(bucket, "a/")]

            # Ranged tasks: each client cold then reuse on its own span; the
            # other client's read of that span is a reuse of the same task.
            spans = {"j": (1000, 40000), "p": (50000, 90001)}
            attrs = {}
            for name, store in (("j", js), ("p", ps)):
                s, e = spans[name]
                a1, d1 = await store.read_object_range("j", "a/obj.bin", s, e)
                buf = bytearray(e - s + 5)
                a2, d2 = await store.read_object_range("j", "a/obj.bin", s, e,
                                                       buf=buf)
                assert d1 == DATA[s:e] and d2 is None
                assert bytes(buf[:e - s]) == DATA[s:e]
                assert (a1["from_reuse"], a2["from_reuse"]) == (False, True)
                assert a1["task_id"] == a2["task_id"] != ""
                attrs[name] = a1["task_id"]
            for name, other in (("j", ps), ("p", js)):
                a, _ = await other.read_object_range("j", "a/obj.bin",
                                                     *spans[name])
                assert a == {"from_reuse": True, "task_id": attrs[name]}
            # A plain ranged GET (no ranged task): same bytes, no task id.
            aj, dj_ = await js.read_object_range("j", "a/obj.bin", 7, 5000,
                                                 ranged_task=False)
            ap, dp_ = await ps.read_object_range("j", "a/obj.bin", 7, 5000,
                                                 ranged_task=False)
            assert dp_ == dj_ == DATA[7:5000] and ap == aj

            # Prefetch: the JAX client's cold task, then the port's reuse.
            pj = await js.prefetch_object("j", "a/obj.bin", range_header="0-99")
            pp = await ps.prefetch_object("j", "a/obj.bin", range_header="0-99")
            assert pp["task_id"] == pj["task_id"]
            assert (pj["from_reuse"], pp["from_reuse"]) == (False, True)
            assert {k: v for k, v in pp.items() if k != "from_reuse"} == \
                {k: v for k, v in pj.items() if k != "from_reuse"}
            # Streaming copies: the same digest and bytes.
            cj = await js.copy_object("j", "a/obj.bin", "a/copy-j")
            cp = await ps.copy_object("j", "a/obj.bin", "a/copy-p",
                                      mode="write_back")
            assert cp == cj == dj
            assert await ps.get_object("j", "a/copy-p") == DATA
            await ps.delete_object("j", "a/copy-p")
            assert not await ps.is_object_exist("j", "a/copy-p")
            assert await js.is_object_exist("j", "a/copy-j")
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run(), timeout=120)


ERROR_CASES = [
    ("stat missing", lambda s: s.stat_object("j", "nope")),
    ("get missing", lambda s: s.get_object("j", "nope")),
    ("get unsatisfiable", lambda s: s.get_object("j", "k", "bytes=900-999")),
    ("range missing", lambda s: s.read_object_range("j", "nope", 0, 10)),
    ("stream missing", lambda s: s.stream_object("j", "nope")),
    ("delete missing", lambda s: s.delete_object("nobucket", "nope")),
    ("delete bucket missing", lambda s: s.delete_bucket("nobucket")),
    ("empty range", lambda s: s.read_object_range("j", "k", 5, 5)),
    ("short buffer", lambda s: s.read_object_range("j", "k", 0, 10,
                                                   buf=bytearray(9))),
    ("copy missing", lambda s: s.copy_object("j", "nope", "x")),
]


@pytest.mark.parametrize("what,call", ERROR_CASES,
                         ids=[c[0] for c in ERROR_CASES])
def test_errors_match_the_jax_client(run_async, tmp_path, what, call):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        js, ps = jstore.Dfstore(fx.endpoint), pstore.Dfstore(fx.endpoint)
        try:
            await js.create_bucket("j")
            await js.put_object("j", "k", b"0123456789", mode="write_back")
            want = await _outcome(call(js))
            got = await _outcome(call(ps))
            if what in ("get missing", "range missing", "stream missing",
                        "copy missing"):
                # The daemon's text names a task of its own; equal up to it.
                assert want[0] == got[0] == "raised"
                assert got[1][:2] == want[1][:2]
                assert got[1][2].split(":")[0] == want[1][2].split(":")[0]
            else:
                assert got == want
            assert await ps.is_object_exist("j", "k")
            assert not await ps.is_object_exist("j", "nope")
        finally:
            await ps.close()
            await js.close()
            await fx.aclose()

    run_async(run())


# -- the stand-in gateway of chip_smoke.py against the reference ------------

async def _subset(store, bucket: str) -> dict:
    """What the dataset plane and fetch_or_build_manifest ask a gateway."""
    out = {"digest": await store.put_object(bucket, "s/obj.bin", DATA,
                                            mode="write_back")}
    info = await store.stat_object(bucket, "s/obj.bin")
    out["info"] = {**dataclasses.asdict(info), "etag": bool(info.etag)}
    for rng in ("", "bytes=3-99", "bytes=2097100-"):
        out[f"get {rng}"] = await store.get_object(bucket, "s/obj.bin", rng)
    for rng in ("", "5-1048580"):
        out[f"stream {rng}"] = await _gather_stream(
            await store.stream_object(bucket, "s/obj.bin", rng))
    reads = []
    for s, e, ranged in ((10, 40000, True), (10, 40000, True),
                         (40000, 70000, False)):
        buf = bytearray(e - s)
        a, _ = await store.read_object_range(bucket, "s/obj.bin", s, e,
                                             ranged_task=ranged, buf=buf)
        reads.append((a["from_reuse"], bool(a["task_id"]), bytes(buf)))
    out["reads"] = reads
    for what, coro in (
            ("stat missing", store.stat_object(bucket, "nope")),
            ("get missing", store.get_object(bucket, "nope")),
            ("range missing", store.read_object_range(bucket, "nope", 0, 9)),
            ("unsatisfiable", store.get_object(bucket, "s/obj.bin",
                                               f"bytes={len(DATA)}-"))):
        kind, (name, status, text) = await _outcome(coro)
        out[what] = (kind, name, status,
                     text if what == "stat missing" else text.split(":")[0])
    return out


def test_stand_in_gateway_answers_as_the_reference(run_async, tmp_path):
    async def run():
        fx = await start_gateway_fixture(tmp_path)
        gw = chip_smoke.StandInGateway()
        ref, standin = (pstore.Dfstore(fx.endpoint),
                        pstore.Dfstore(gw.start()))
        jax_on_standin = jstore.Dfstore(standin.endpoint)
        try:
            await ref.create_bucket("b")
            want = await _subset(ref, "b")
            got = await _subset(standin, "b")
            assert got == want
            assert want["reads"][0][0] is False and want["reads"][1][0]
            # The JAX client reads the stand-in as it reads the reference.
            assert dataclasses.asdict(
                await jax_on_standin.stat_object("b", "s/obj.bin")) == \
                dataclasses.asdict(await standin.stat_object("b", "s/obj.bin"))
            assert await jax_on_standin.get_object("b", "s/obj.bin") == DATA
            assert gw.object_bytes("b", "s/obj.bin") == DATA
        finally:
            await jax_on_standin.close()
            await standin.close()
            await ref.close()
            gw.close()
            await fx.aclose()

    run_async(run(), timeout=120)


def test_stand_in_in_a_process_of_its_own(run_async):
    """``StandInProcess`` (the stand-in in a spawned child, as the smoke
    script's webdataset phase runs it) serves the shards it made from the
    seed, byte for byte those ``wds_shards`` makes here."""
    shape = {"shards": 2, "per_shard": 3, "tokens": 64}
    shards, _ = chip_smoke.wds_shards(7, 1000, **shape)

    async def run():
        gw = chip_smoke.StandInProcess(chip_smoke.wds_objects, 7, 1000, shape)
        gw.start()
        store = pstore.Dfstore(gw.endpoint())
        bucket, key = chip_smoke.WDS_BUCKET, "00001.tar"
        data = bytes(shards[key])
        try:
            info = await store.stat_object(bucket, key)
            assert info.content_length == len(data)
            assert await store.get_object(bucket, key) == data
            a, d = await store.read_object_range(bucket, key, 5, 700)
            a2, _ = await store.read_object_range(bucket, key, 5, 700)
            assert d == data[5:700]
            assert (a["from_reuse"], a2["from_reuse"]) == (False, True)
            digest = await store.put_object(bucket, "new", b"abc")
            assert gw.object_bytes(bucket, "new") == b"abc"
            assert digest.startswith("sha256:")
            assert gw.requests() == {"head": (1, 0), "get": (1, len(data)),
                                     "put": (1, 0),
                                     "ranged_task": (2, 2 * 695)}
            assert gw.cpu_s() > 0
        finally:
            await store.close()
            gw.close()

    run_async(run(), timeout=120)


def test_keep_alive_one_connection_a_worker(run_async, monkeypatch):
    """Each worker thread opens one connection and keeps it: 250 requests
    open as many connections as there were worker threads, whichever
    threads the executor picked."""
    accepted = []
    orig = chip_smoke._GatewayServer.process_request

    def counting(self, request, client_address):
        accepted.append(client_address)
        return orig(self, request, client_address)

    monkeypatch.setattr(chip_smoke._GatewayServer, "process_request",
                        counting)
    threads = set()

    async def run():
        gw = chip_smoke.StandInGateway()
        gw.put("b", "k", DATA)
        store = pstore.Dfstore(gw.start())
        orig_read = store._read_range

        def recording(*args):
            threads.add(threading.get_ident())
            return orig_read(*args)

        monkeypatch.setattr(store, "_read_range", recording)
        try:
            for i in range(50):
                a, d = await store.read_object_range("b", "k", i, i + 100)
                assert d == DATA[i:i + 100]
            await asyncio.gather(*(store.read_object_range("b", "k", i,
                                                           i + 1000)
                                   for i in range(200)))
        finally:
            await store.close()
            gw.close()

    run_async(run())
    assert len(accepted) == len(threads) <= pstore.WORKERS


def test_worker_threads_are_named_df(run_async, monkeypatch):
    names = set()

    async def run():
        gw = chip_smoke.StandInGateway()
        gw.put("b", "k", DATA)
        store = pstore.Dfstore(gw.start())
        orig = store._read_range

        def recording(*args):
            names.add(threading.current_thread().name)
            return orig(*args)

        monkeypatch.setattr(store, "_read_range", recording)
        try:
            await asyncio.gather(*(store.read_object_range("b", "k", i,
                                                           i + 10)
                                   for i in range(40)))
        finally:
            await store.close()
            gw.close()

    run_async(run())
    assert names and all(n.startswith("df-dfstore") for n in names), names


# -- a raw server for the transport's edge cases ----------------------------

class _RawServer:
    """Answers every request with ``status`` and a ``Content-Length`` of
    ``declared``, then sends ``first`` bytes of body at once and the rest
    of ``body`` only after ``release`` is set (never, for a stall)."""

    def __init__(self, body: bytes, *, declared=None, first=None,
                 headers_after=0.0):
        self.body = body
        self.declared = len(body) if declared is None else declared
        self.first = len(body) if first is None else first
        self.headers_after = headers_after
        self.sent_first = threading.Event()
        self.release = threading.Event()
        self._sock = socket.create_server(("127.0.0.1", 0))
        self._sock.settimeout(0.2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="df-test-raw-server")
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._sock.getsockname()[1]}"

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                continue
            with conn:
                try:
                    conn.recv(65536)
                    time.sleep(self.headers_after)
                    if self._stop.is_set():
                        return
                    conn.sendall(b"HTTP/1.1 206 Partial Content\r\n"
                                 b"Content-Length: %d\r\n\r\n" % self.declared
                                 + self.body[:self.first])
                    self.sent_first.set()
                    while not self.release.wait(0.05):
                        if self._stop.is_set():
                            return
                    conn.sendall(self.body[self.first:])
                    time.sleep(0.05)
                except OSError:
                    pass

    def close(self):
        self._stop.set()
        self.release.set()
        self._thread.join(timeout=10)
        self._sock.close()


@pytest.mark.parametrize("sent,declared", [(105, 105), (97, 97)],
                         ids=["over-delivered", "returned-short"])
def test_over_and_under_delivery_match_the_jax_client(run_async, sent,
                                                      declared):
    async def read(cls):
        srv = _RawServer(bytes(range(sent)), declared=declared)
        store = cls.Dfstore(srv.endpoint)
        try:
            return await _outcome(store.read_object_range(
                "b", "k", 0, 100, buf=bytearray(100)))
        finally:
            await store.close()
            srv.close()

    async def run():
        return await read(jstore), await read(pstore)

    want, got = run_async(run())
    assert want[0] == "raised" and got == (
        "raised", ("DfstoreError", 0, want[1][2]))


def test_request_timeout_bounds_a_stalled_request(run_async):
    async def run():
        srv = _RawServer(b"x", headers_after=30)
        store = pstore.Dfstore(srv.endpoint, timeout=0.3)
        t0 = time.perf_counter()
        try:
            with pytest.raises(TimeoutError):
                await store.get_object("b", "k")
        finally:
            took = time.perf_counter() - t0
            await store.close()
            srv.close()
        return took

    assert run_async(run()) < 5


@pytest.mark.parametrize("cancel_at", ["mid-body", "before-start"])
def test_cancelled_range_read_leaves_its_buffer_untouched(run_async,
                                                          cancel_at):
    """The dataset plane releases a pooled span buffer as soon as a
    cancelled read returns: from then on nothing may write into it."""
    n = 1 << 20
    body = bytes([0xAB]) * n

    async def run():
        srv = _RawServer(body, first=4096)
        store = pstore.Dfstore(srv.endpoint, read_timeout=30)
        buf = bytearray(n)
        blockers = []
        try:
            if cancel_at == "before-start":
                # Every worker busy: the read is queued, never started.
                hold = threading.Event()
                pool = store._executor()
                blockers = [pool.submit(hold.wait, 10)
                            for _ in range(pstore.WORKERS)]
            task = asyncio.ensure_future(
                store.read_object_range("b", "k", 0, n, buf=buf))
            if cancel_at == "mid-body":
                while not srv.sent_first.is_set():
                    await asyncio.sleep(0.01)
                await asyncio.sleep(0.1)   # the worker has read the head
            else:
                await asyncio.sleep(0.1)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            snapshot = bytes(buf)
            srv.release.set()              # the rest of the body arrives
            await asyncio.sleep(0.3)
            assert bytes(buf) == snapshot
            if cancel_at == "before-start":
                assert snapshot == bytes(n)
                hold.set()
            else:
                assert snapshot[:4096] == body[:4096]
                assert snapshot[4096:] == bytes(n - 4096)
            for b in blockers:
                b.result(timeout=10)
        finally:
            await store.close()
            srv.close()

    run_async(run())


def test_a_connection_cut_by_a_cancel_is_not_used_again(run_async,
                                                        monkeypatch):
    """A cancel that lands after the worker's last read still cuts the
    worker's kept-alive socket; the worker's next request must go out on
    a fresh connection, not on the cut one (where it would need the
    stale-connection retry, here turned off)."""
    monkeypatch.setattr(pstore, "WORKERS", 1)
    monkeypatch.setattr(pstore, "_STALE", ())
    detach = pstore.WorkerCall.detach
    cut = []

    def cancel_after_the_read(self, conn):
        if not cut:
            cut.append(conn)
            self.abort()
        detach(self, conn)

    monkeypatch.setattr(pstore.WorkerCall, "detach", cancel_after_the_read)

    async def run():
        gw = chip_smoke.StandInGateway()
        gw.put("b", "k", DATA)
        store = pstore.Dfstore(gw.start())
        try:
            buf = bytearray(100)
            await store.read_object_range("b", "k", 0, 100, buf=buf)
            assert bytes(buf) == DATA[:100] and cut
            _, data = await store.read_object_range("b", "k", 7, 1007)
            assert data == DATA[7:1007]
            assert await store.get_object("b", "k") == DATA
        finally:
            await store.close()
            gw.close()

    run_async(run())


def test_a_kept_alive_connection_aborted_meanwhile_is_opened_again(
        run_async, monkeypatch):
    """ECONNABORTED on a kept-alive connection is a stale connection like
    EPIPE or ECONNRESET: the request goes out once more on a fresh one."""
    monkeypatch.setattr(pstore, "WORKERS", 1)
    raised = []

    async def run():
        gw = chip_smoke.StandInGateway()
        gw.put("b", "k", DATA)
        store = pstore.Dfstore(gw.start())
        try:
            assert (await store.stat_object("b", "k")).content_length == len(
                DATA)
            conn = await store._run(lambda call: store._thread_conn())
            request = conn.request

            def aborted_once(*args, **kw):
                if not raised:
                    raised.append(conn.sock is not None)
                    raise ConnectionAbortedError(103, "connection abort")
                return request(*args, **kw)

            monkeypatch.setattr(conn, "request", aborted_once)
            _, data = await store.read_object_range("b", "k", 5, 905)
            assert data == DATA[5:905]
        finally:
            await store.close()
            gw.close()

    run_async(run())
    assert raised == [True]


def test_await_worker_waits_out_a_thread_on_cancel(run_async):
    """The embedded daemon's span reads run in asyncio.to_thread: a cancel
    returns only after the thread is done."""
    done = threading.Event()

    def slow():
        time.sleep(0.3)
        done.set()

    async def run():
        task = asyncio.ensure_future(
            await_worker(asyncio.ensure_future(asyncio.to_thread(slow))))
        await asyncio.sleep(0.05)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return done.is_set()

    assert run_async(run())
