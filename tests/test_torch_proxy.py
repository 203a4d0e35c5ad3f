"""The port's proxy (``daemon/proxy.py``) against the JAX one.

Each scenario of ``tests/test_stream_proxy.py`` and
``tests/test_https_proxy.py`` runs through the JAX ``Proxy`` (on
``aiohttp``) and through the port's (on ``http.client``), each over its own
package's task manager, against one origin: an aiohttp registry with a
blob, a manifest and the odd answers (chunked, 204, 304, a redirect, a
gzip body), served in plaintext and over TLS with a leaf of a CA both
proxies intercept with. A raw HTTP/1.1 client reads every answer, so
the comparison covers the status, ``Content-Length``, ``Content-Range``,
``Transfer-Encoding`` (chunked framing), the body bytes, the origin's
requests and the ``proxy_requests_total{via}`` deltas (a 502's text is
the HTTP library's error message, so only its status and prefix):

- the registry mirror (manifest direct, blob by P2P, the blob again from
  the store with no origin request, two requests on one connection);
- the forward proxy: a ranged GET, an open range, a range past the end
  (416), a rule-excluded GET, HEAD, POST with a body, 204, 304, a
  redirect not followed, a gzip body not decoded, a chunked body, an
  unreachable origin (502), ``X-Dragonfly-No-P2P``;
- basic auth (407, then 200), the max-concurrency gate (503), CONNECT
  to a port off the white list (403), the blind CONNECT relay;
- the HTTPS hijack (a blob twice through a CONNECT tunnel, the second
  from the store; a Range inside the tunnel), the hijack host filter (a
  blind relay, the origin hit each time), a client that does not trust
  the CA (no answer), the SNI hijack, and ``parse_sni`` on the same real
  ClientHello bytes.

Tolerance 0.
"""

from __future__ import annotations

import asyncio
import base64
import gzip
import hashlib
import os
import random
import ssl

import pytest
from aiohttp import web

from dragonfly2_tpu.daemon import proxy as jproxy
from dragonfly2_tpu.daemon.peer.piece_manager import PieceManager as JPM
from dragonfly2_tpu.daemon.peer.piece_manager import (
    PieceManagerOption as JPMOption,
)
from dragonfly2_tpu.daemon.peer.task_manager import TaskManager as JTM
from dragonfly2_tpu.daemon.transport import P2PTransport as JTransport
from dragonfly2_tpu.daemon.transport import ProxyRule as JRule
from dragonfly2_tpu.pkg.certify import CertAuthority as JCA
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu_torch.daemon import proxy as pproxy
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManager,
    PieceManagerOption,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager
from dragonfly2_tpu_torch.daemon.transport import P2PTransport, ProxyRule
from dragonfly2_tpu_torch.pkg.certify import CertAuthority
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.source import default_registry
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption

BLOB = random.Random(17).randbytes((6 << 20) + 321)
BLOB_SHA = hashlib.sha256(BLOB).hexdigest()
BLOB_PATH = f"/v2/library/app/blobs/sha256:{BLOB_SHA}"
MANIFEST_PATH = "/v2/library/app/manifests/latest"
STREAM = random.Random(5).randbytes(300_001)
VIAS = ("p2p", "direct", "tunnel", "hijack", "sni")


@pytest.fixture(scope="module")
def ca():
    return CertAuthority.generate()


@pytest.fixture
def trust_ca(ca, tmp_path, monkeypatch):
    """The origin clients of both packages trust the test CA."""
    bundle = tmp_path / "ca-bundle.pem"
    bundle.write_bytes(ca.ca_cert_pem)
    monkeypatch.setenv("DRAGONFLY_SSL_CA_FILE", str(bundle))
    https = default_registry().get("https")
    https._ssl = None          # made again at the next https request
    yield
    https._ssl = None


async def start_origin(ca: CertAuthority):
    """The registry on one plaintext and one TLS port; requests counted by
    path."""
    hits: dict[str, int] = {}

    def count(request):
        hits[request.path] = hits.get(request.path, 0) + 1

    async def blob(request):
        count(request)
        rng = request.headers.get("Range")
        if rng:
            r = Range.parse_http(rng, len(BLOB))
            return web.Response(
                status=206, body=BLOB[r.start:r.start + r.length],
                headers={"Accept-Ranges": "bytes",
                         "Content-Range": f"bytes {r.start}-"
                         f"{r.start + r.length - 1}/{len(BLOB)}"})
        return web.Response(body=BLOB, headers={"Accept-Ranges": "bytes"})

    async def manifest(request):
        count(request)
        return web.json_response({
            "schemaVersion": 2,
            "layers": [{"digest": f"sha256:{BLOB_SHA}", "size": len(BLOB)}]},
            headers={"X-Registry": "r", "Set-Cookie": "a=1"})

    async def stream(request):
        count(request)
        resp = web.StreamResponse(headers={"X-Kind": "stream"})
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        for i in range(0, len(STREAM), 65536):
            await resp.write(STREAM[i:i + 65536])
        await resp.write_eof()
        return resp

    async def status(request):
        count(request)
        code = int(request.match_info["code"])
        if code in (301, 302):
            return web.Response(status=code, headers={"Location": "/elsewhere"},
                                text="moved")
        return web.Response(status=code)

    async def gz(request):
        count(request)
        return web.Response(body=gzip.compress(b"x" * 5000, mtime=0),
                            headers={"Content-Encoding": "gzip",
                                     "Content-Type": "text/plain"})

    async def echo(request):
        count(request)
        data = await request.read()
        return web.Response(status=201, body=hashlib.sha256(data).digest())

    app = web.Application()
    app.router.add_get(BLOB_PATH, blob)
    app.router.add_get(MANIFEST_PATH, manifest)
    app.router.add_get("/stream.bin", stream)
    app.router.add_get("/status/{code}", status)
    app.router.add_get("/gz", gz)
    app.router.add_post("/echo", echo)
    runner = web.AppRunner(app)
    await runner.setup()
    plain = web.TCPSite(runner, "127.0.0.1", 0)
    tls = web.TCPSite(runner, "127.0.0.1", 0,
                      ssl_context=ca.server_context("127.0.0.1"))
    await plain.start()
    await tls.start()
    return (runner, plain._server.sockets[0].getsockname()[1],
            tls._server.sockets[0].getsockname()[1], hits)


def _stack(side: str, data_dir: str, ca: CertAuthority, rules=(), **kw):
    """One package's proxy over its own task manager: (proxy, storage)."""
    if side == "jax":
        storage = JSM(JSMOption(data_dir=data_dir))
        tm = JTM(storage, JPM(JPMOption(concurrency=3)))
        jca = JCA(ca.ca_cert_pem, ca.ca_key_pem)
        return jproxy.Proxy(JTransport(tm, rules=[JRule(**r) for r in rules]),
                            cert_authority=jca if kw.pop("hijack", False)
                            else None, **kw), storage
    storage = StorageManager(StorageOption(data_dir=data_dir))
    tm = TaskManager(storage, PieceManager(PieceManagerOption(concurrency=3)))
    return pproxy.Proxy(P2PTransport(tm, rules=[ProxyRule(**r) for r in rules]),
                        cert_authority=ca if kw.pop("hijack", False) else None,
                        **kw), storage


def _vias(side: str) -> dict:
    if side == "jax":
        return {v: jproxy.PROXY_REQUESTS.labels(v)._value.get() for v in VIAS}
    return {v: pproxy.PROXY_REQUESTS.value(v) for v in VIAS}


async def _read_answer(reader: asyncio.StreamReader, method: str = "GET"):
    """One HTTP/1.1 answer: its status, the headers compared, whether it
    was chunked and its body (de-chunked)."""
    line = await reader.readline()
    if not line:
        return None
    status = int(line.split()[1])
    headers = {}
    while (h := await reader.readline()) not in (b"\r\n", b""):
        k, _, v = h.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    chunked = headers.get("transfer-encoding", "").lower() == "chunked"
    body = b""
    if method == "HEAD" or status in (204, 304):
        pass
    elif chunked:
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                break
            body += await reader.readexactly(size)
            await reader.readline()
    elif "content-length" in headers:
        body = await reader.readexactly(int(headers["content-length"]))
    else:
        body = await reader.read()
    if status == 502:
        # Its text is the HTTP library's error message: aiohttp's in the
        # JAX proxy, http.client's in the port's.
        return {"status": status, "text": body.startswith(b"upstream error")}
    keep = {k: headers[k] for k in ("content-length", "content-range",
                                    "transfer-encoding", "content-encoding",
                                    "location", "x-registry", "x-kind",
                                    "set-cookie", "proxy-authenticate",
                                    "connection") if k in headers}
    return {"status": status, "headers": keep, "chunked": chunked,
            "sha": hashlib.sha256(body).hexdigest(), "len": len(body)}


async def _request(reader, writer, method: str, target: str,
                   headers: dict | None = None, body: bytes = b""):
    head = f"{method} {target} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    if body:
        head += f"Content-Length: {len(body)}\r\n"
    writer.write(head.encode() + b"\r\n" + body)
    await writer.drain()
    return await asyncio.wait_for(_read_answer(reader, method), 60)


async def _one(port: int, method: str, target: str, headers=None,
               body: bytes = b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        return await _request(reader, writer, method, target,
                              {"Host": "registry", **(headers or {})}, body)
    finally:
        writer.close()


async def _run(side: str, tmp_path, ca, scenario, stack_kw: dict,
               rules=()) -> list:
    runner, plain, tls, hits = await start_origin(ca)
    proxy, storage = _stack(side, str(tmp_path / side), ca, rules,
                            **{k: v(plain) if callable(v) else v
                               for k, v in stack_kw.items()})
    port = await proxy.serve("127.0.0.1", 0)
    sni = 0
    if stack_kw.get("hijack"):
        sni = await proxy.serve_sni("127.0.0.1", 0, hijack=True)
    out = []
    try:
        async def step(what, coro):
            before, v0 = dict(hits), _vias(side)
            got = await coro
            # A proxy counts a request after its last write: let it.
            await asyncio.sleep(0.05)
            v1 = _vias(side)
            out.append((what, got,
                        {p: n - before.get(p, 0) for p, n in hits.items()
                         if n != before.get(p, 0)},
                        {v: v1[v] - v0[v] for v in VIAS if v1[v] != v0[v]}))

        await scenario(step, port, sni, plain, tls, ca)
    finally:
        await proxy.close()
        storage.close()
        await runner.cleanup()
    return out


def _compare(run_async, tmp_path, ca, scenario, rules=(), **stack_kw):
    want = run_async(_run("jax", tmp_path, ca, scenario, stack_kw, rules),
                     timeout=120)
    got = run_async(_run("port", tmp_path, ca, scenario, stack_kw, rules),
                    timeout=120)
    assert got == want
    return got


# -- the scenarios -------------------------------------------------------


async def _mirror(step, port, sni, plain, tls, ca):
    await step("manifest", _one(port, "GET", MANIFEST_PATH))
    await step("blob", _one(port, "GET", BLOB_PATH))
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        for i in range(2):
            await step(f"blob kept-alive {i}", _request(
                reader, writer, "GET", BLOB_PATH, {"Host": "registry"}))
        await step("range kept-alive", _request(
            reader, writer, "GET", BLOB_PATH,
            {"Host": "registry", "Range": "bytes=4194000-4194999"}))
    finally:
        writer.close()


def test_the_registry_mirror(run_async, tmp_path, ca):
    got = _compare(run_async, tmp_path, ca, _mirror,
                   registry_mirror=lambda p: f"http://127.0.0.1:{p}")
    steps = {what: (ans, origin, vias) for what, ans, origin, vias in got}
    assert steps["manifest"][2] == {"direct": 1}
    assert steps["blob"][0]["sha"] == BLOB_SHA
    assert steps["blob"][2] == {"p2p": 1}
    for i in range(2):
        ans, origin, vias = steps[f"blob kept-alive {i}"]
        assert ans["sha"] == BLOB_SHA and origin == {} and vias == {"p2p": 1}
    assert steps["range kept-alive"][0]["status"] == 206


def _forward(target_of):
    async def scenario(step, port, sni, plain, tls, ca):
        base = f"http://127.0.0.1:{plain}"
        for what, method, path, headers, body in target_of:
            await step(what, _one(port, method, base + path, headers, body))
    return scenario


FORWARD = [
    ("range", "GET", BLOB_PATH, {"Range": "bytes=100-299"}, b""),
    ("open range", "GET", BLOB_PATH, {"Range": "bytes=6000000-"}, b""),
    ("suffix across pieces", "GET", BLOB_PATH,
     {"Range": "bytes=4194300-4194400"}, b""),
    ("whole", "GET", BLOB_PATH, {}, b""),
    ("past the end", "GET", BLOB_PATH,
     {"Range": f"bytes={len(BLOB) + 10}-{len(BLOB) + 20}"}, b""),
    ("no p2p header", "GET", BLOB_PATH, {"X-Dragonfly-No-P2P": "true"}, b""),
    ("manifest", "GET", MANIFEST_PATH, {}, b""),
    ("head", "HEAD", MANIFEST_PATH, {}, b""),
    ("post", "POST", "/echo", {"Content-Type": "x/y"}, b"z" * 70000),
    ("204", "GET", "/status/204", {}, b""),
    ("304", "GET", "/status/304", {}, b""),
    ("302 not followed", "GET", "/status/302", {}, b""),
    ("404", "GET", "/status/404", {}, b""),
    ("gzip kept", "GET", "/gz", {"Accept-Encoding": "gzip"}, b""),
    ("chunked direct", "GET", "/stream.bin", {"X-Dragonfly-No-P2P": "1"},
     b""),
    ("chunked p2p", "GET", "/stream.bin", {}, b""),
    ("chunked p2p again", "GET", "/stream.bin", {}, b""),
]


@pytest.mark.parametrize("case", [c[0] for c in FORWARD])
def test_the_forward_proxy(run_async, tmp_path, ca, case):
    steps = [c for c in FORWARD if c[0] == case]
    if case == "chunked p2p again":
        steps = [c for c in FORWARD if c[0] == "chunked p2p"] + steps
    got = _compare(run_async, tmp_path, ca, _forward(steps),
                   rules=[{"regex": r"\.bin$"}])
    ans = got[-1][1]
    if case == "past the end":
        assert ans["status"] == 416
        assert ans["headers"]["content-range"] == f"bytes */{len(BLOB)}"
    if case == "range":
        assert ans["status"] == 206 and ans["len"] == 200
    if case.startswith("chunked"):
        assert ans["sha"] == hashlib.sha256(STREAM).hexdigest()
    if case == "302 not followed":
        assert ans["status"] == 302 and ans["headers"]["location"] == \
            "/elsewhere"


async def _unreachable(step, port, sni, plain, tls, ca):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    await step("502", _one(port, "GET", f"http://127.0.0.1:{dead}/index"))
    await step("502 p2p", _one(port, "GET",
                               f"http://127.0.0.1:{dead}{BLOB_PATH}"))


def test_an_unreachable_origin_answers_502(run_async, tmp_path, ca):
    got = _compare(run_async, tmp_path, ca, _unreachable)
    assert [a["status"] for _, a, _, _ in got] == [502, 502]


async def _gates(step, port, sni, plain, tls, ca):
    await step("no auth", _one(port, "GET", MANIFEST_PATH))
    cred = base64.b64encode(b"user:pw").decode()
    await step("wrong auth", _one(port, "GET", MANIFEST_PATH, {
        "Proxy-Authorization": "Basic " + base64.b64encode(b"u:x").decode()}))
    await step("auth", _one(port, "GET", MANIFEST_PATH,
                            {"Proxy-Authorization": f"Basic {cred}"}))


def test_basic_auth(run_async, tmp_path, ca):
    got = _compare(run_async, tmp_path, ca, _gates,
                   basic_auth=("user", "pw"),
                   registry_mirror=lambda p: f"http://127.0.0.1:{p}")
    assert [a["status"] for _, a, _, _ in got] == [407, 407, 200]


async def _busy(step, port, sni, plain, tls, ca):
    await step("503", _one(port, "GET", MANIFEST_PATH))


def test_the_max_concurrency_gate(run_async, tmp_path, ca):
    # The gate is read at each request: one request held in flight.
    orig = (jproxy.Proxy._request_loop, pproxy.Proxy._request_loop)

    def held(fn):
        async def loop(self, *a, **kw):
            self._inflight = self.max_concurrency
            return await fn(self, *a, **kw)
        return loop

    jproxy.Proxy._request_loop = held(orig[0])
    pproxy.Proxy._request_loop = held(orig[1])
    try:
        got = _compare(run_async, tmp_path, ca, _busy, max_concurrency=1,
                       registry_mirror=lambda p: f"http://127.0.0.1:{p}")
    finally:
        jproxy.Proxy._request_loop, pproxy.Proxy._request_loop = orig
    assert got[0][1]["status"] == 503
    assert got[0][1]["headers"]["connection"] == "close"


async def _connect(reader, writer, target: str) -> int:
    writer.write(f"CONNECT {target} HTTP/1.1\r\nHost: {target}\r\n\r\n"
                 .encode())
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return status


async def _tunnels(step, port, sni, plain, tls, ca):
    async def blind():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            status = await _connect(reader, writer, f"127.0.0.1:{plain}")
            ans = await _request(reader, writer, "GET", MANIFEST_PATH,
                                 {"Host": "registry"})
            return status, ans
        finally:
            writer.close()

    async def refused():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            writer.write(f"CONNECT 127.0.0.1:{tls} HTTP/1.1\r\n\r\n".encode())
            await writer.drain()
            return await asyncio.wait_for(_read_answer(reader), 30)
        finally:
            writer.close()

    await step("blind relay", blind())
    await step("port not white-listed", refused())


def test_connect_relay_and_the_white_list(run_async, tmp_path, ca):
    got = _compare(run_async, tmp_path, ca, _tunnels,
                   white_list_ports=lambda p: [p])
    assert got[0][1][0] == 200 and got[0][3] == {"tunnel": 1}
    assert got[1][1]["status"] == 403


async def _hijack(step, port, sni, plain, tls, ca):
    trust = ca.trust_context()

    async def pull(headers=None, trust=trust):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            status = await _connect(reader, writer, f"127.0.0.1:{tls}")
            try:
                await writer.start_tls(trust, server_hostname="127.0.0.1")
            except (ssl.SSLError, ConnectionError) as e:
                return status, type(e).__name__
            return status, await _request(
                reader, writer, "GET", BLOB_PATH,
                {"Host": f"127.0.0.1:{tls}", **(headers or {})})
        finally:
            writer.close()

    await step("cold", pull())
    await step("warm", pull())
    await step("range in the tunnel", pull({"Range": "bytes=10-4194400"}))
    untrusting = ssl.create_default_context()
    await step("client without the CA", pull(trust=untrusting))

    async def sni_pull():
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", sni, ssl=trust, server_hostname="localhost")
        try:
            return await _request(reader, writer, "GET", BLOB_PATH,
                                  {"Host": f"127.0.0.1:{tls}",
                                   "Connection": "close"})
        finally:
            writer.close()

    await step("sni", sni_pull())


def test_the_https_hijack_and_sni(run_async, tmp_path, ca, trust_ca):
    got = _compare(run_async, tmp_path, ca, _hijack,
                   rules=[{"regex": r"blobs/sha256.*"}], hijack=True,
                   white_list_ports=[])
    steps = {what: (ans, origin, vias) for what, ans, origin, vias in got}
    cold, warm = steps["cold"], steps["warm"]
    assert cold[0][0] == 200 and cold[0][1]["sha"] == BLOB_SHA
    assert cold[1] and cold[2] == {"hijack": 1, "p2p": 1}
    assert warm[0][1]["sha"] == BLOB_SHA and warm[1] == {}
    rng = steps["range in the tunnel"][0][1]
    assert rng["status"] == 206 and rng["len"] == 4194400 - 10 + 1
    assert steps["client without the CA"][0][1] == "SSLCertVerificationError"
    assert steps["sni"][0]["sha"] == BLOB_SHA and steps["sni"][1] == {}
    assert steps["sni"][2] == {"hijack": 1, "p2p": 1}


async def _filtered(step, port, sni, plain, tls, ca):
    trust = ca.trust_context()

    async def pull():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            status = await _connect(reader, writer, f"127.0.0.1:{tls}")
            await writer.start_tls(trust, server_hostname="127.0.0.1")
            return status, await _request(
                reader, writer, "GET", BLOB_PATH,
                {"Host": f"127.0.0.1:{tls}", "Connection": "close"})
        finally:
            writer.close()

    for i in range(2):
        await step(f"pull {i}", pull())


def test_the_hijack_host_filter(run_async, tmp_path, ca, trust_ca):
    got = _compare(run_async, tmp_path, ca, _filtered,
                   rules=[{"regex": r"blobs/sha256.*"}], hijack=True,
                   hijack_hosts=[r"registry\.internal"], white_list_ports=[])
    for _, ans, origin, vias in got:
        assert ans[1]["sha"] == BLOB_SHA
        assert origin == {BLOB_PATH: 1} and vias == {"tunnel": 1}


def _client_hellos() -> list[bytes]:
    out = []
    for name in ("registry.example.com", "a.b", ("x" * 60 + ".") * 3 + "io",
                 None):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        inbio, outbio = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = ctx.wrap_bio(inbio, outbio, server_hostname=name)
        try:
            obj.do_handshake()
        except ssl.SSLWantReadError:
            pass
        out.append(outbio.read())
    return out


HELLOS = _client_hellos()


@pytest.mark.parametrize("record", HELLOS + [
    HELLOS[0][:40], HELLOS[0][:-7], b"\x17\x03\x03\x00\x05hello", b"",
    b"\x16\x03\x01\x00\x10\x01" + b"\x00" * 20],
    ids=lambda r: f"{len(r)}B")
def test_parse_sni_matches_jax(record):
    assert pproxy.parse_sni(record) == jproxy.parse_sni(record)


def test_parse_sni_reads_the_name():
    assert pproxy.parse_sni(HELLOS[0]) == "registry.example.com"
    assert pproxy.parse_sni(HELLOS[3]) is None


@pytest.mark.parametrize("tls", [False, True])
def test_a_store_window_goes_out_whole(run_async, tmp_path, ca, tls,
                                       monkeypatch):
    """``_send_file``: the exact window of the data file, by ``sendfile``
    on a plaintext connection, and through a TLS connection in reads of
    ``TLS_SEND_CHUNK`` (one ``os.pread`` a MiB, not asyncio's 16 KiB
    fallback)."""
    path = tmp_path / "data"
    path.write_bytes(BLOB)
    offset, count = 12345, (3 << 20) + 77
    reads = []
    pread = os.pread

    def counted(fd, n, off):
        reads.append(n)
        return pread(fd, n, off)

    monkeypatch.setattr(os, "pread", counted)

    async def run():
        async def handle(reader, writer):
            await pproxy.Proxy._send_file(writer, str(path), offset, count)
            writer.close()

        server = await asyncio.start_server(
            handle, "127.0.0.1", 0,
            ssl=ca.server_context("127.0.0.1") if tls else None)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", port, ssl=ca.trust_context() if tls else None,
            server_hostname="127.0.0.1" if tls else None)
        got = await reader.read()
        writer.close()
        server.close()
        await server.wait_closed()
        return got

    assert run_async(run()) == BLOB[offset:offset + count]
    if tls:
        assert reads == [pproxy.TLS_SEND_CHUNK] * 3 + [77]
    else:
        assert reads == []


def test_close_cuts_an_idle_kept_alive_client(run_async, tmp_path, ca):
    """The port's close() returns with a client still connected (the
    server's wait_closed would otherwise wait for it)."""
    async def run():
        proxy, storage = _stack("port", str(tmp_path / "p"), ca)
        port = await proxy.serve("127.0.0.1", 0)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await asyncio.sleep(0.05)
        try:
            await asyncio.wait_for(proxy.close(), 10)
            assert await reader.read() == b""
        finally:
            writer.close()
            storage.close()

    run_async(run(), timeout=30)
