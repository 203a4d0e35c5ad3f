"""The port's origin clients against the JAX package's, on one origin.

The ``http`` client of the port speaks ``http.client`` on worker threads
where the JAX client rides ``aiohttp``; both talk to the same aiohttp
origin here (the JAX tests' kind of origin) and must agree on:

- ``probe``, ``get_content_length``, ``is_support_range`` and a
  download's status, length and range flag, for an origin with and
  without byte ranges;
- the bytes of whole and ranged downloads, and of a chunked body;
- 404, 401/403, 416, 408/429, 418, 5xx: each the same ``Code`` and the
  same ``temporary`` flag, on a download and on a probe;
- a body cut short: a temporary ``SourceError`` from the body;
- ``get_last_modified`` and ``list_metadata``.

And, the port's own transport: one kept-alive connection carries
sequential requests; a kept-alive connection found dead is replaced and
the request succeeds; worker threads carry ``df-`` names; an unknown
scheme is ``UnsupportedProtocol``. The ``file`` client is held to the JAX
one on whole, ranged and missing files and on a listing. Content is made
with numpy from a seed. Tolerance 0.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import pytest
from aiohttp import web

from dragonfly2_tpu.pkg.errors import SourceError as JSourceError
from dragonfly2_tpu.pkg.piece import Range
from dragonfly2_tpu.source import Request as JRequest
from dragonfly2_tpu.source.clients.file import FileSourceClient as JFile
from dragonfly2_tpu.source.clients.http import HTTPSourceClient as JHTTP
from dragonfly2_tpu_torch.pkg.errors import Code, SourceError
from dragonfly2_tpu_torch.source import Request as PRequest
from dragonfly2_tpu_torch.source import get_client
from dragonfly2_tpu_torch.source.clients.file import FileSourceClient as PFile
from dragonfly2_tpu_torch.source.clients.http import HTTPSourceClient as PHTTP

CONTENT = np.random.default_rng(11).integers(
    0, 256, (3 << 20) + 123, np.uint8).tobytes()
LAST_MODIFIED = "Wed, 21 Oct 2015 07:28:00 GMT"
INDEX = ('<html><a href="a.bin">a</a> <a href="sub/">sub</a> '
         '<a href="../up">up</a> <a href="?q">q</a></html>')


async def start_origin():
    """/blob with ranges (416 past the end), /plain without them,
    /chunked, /cut (a body cut short), /status/<n>, /dir/ (an index).
    ``stats["peers"]`` holds each request's client address."""
    stats = {"peers": [], "gets": 0}

    def note(request):
        stats["peers"].append(request.transport.get_extra_info("peername"))

    async def blob(request):
        note(request)
        stats["gets"] += request.method == "GET"
        headers = {"Accept-Ranges": "bytes", "Last-Modified": LAST_MODIFIED}
        hdr = request.headers.get("Range")
        if hdr:
            r = Range.parse_http(hdr, len(CONTENT))
            if r.start >= len(CONTENT):
                return web.Response(status=416, headers={
                    "Content-Range": f"bytes */{len(CONTENT)}"})
            data = CONTENT[r.start:r.start + r.length]
            return web.Response(status=206, body=data, headers={
                **headers, "Content-Range":
                f"bytes {r.start}-{r.start + len(data) - 1}/{len(CONTENT)}"})
        return web.Response(body=CONTENT, headers=headers)

    async def plain(request):
        note(request)
        return web.Response(body=CONTENT)

    async def chunked(request):
        note(request)
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        for i in range(0, len(CONTENT), 1 << 20):
            await resp.write(CONTENT[i:i + (1 << 20)])
        await resp.write_eof()
        return resp

    async def cut(request):
        note(request)
        resp = web.StreamResponse(headers={
            "Content-Length": str(len(CONTENT))})
        await resp.prepare(request)
        await resp.write(CONTENT[:1 << 20])
        request.transport.close()
        return resp

    async def status(request):
        note(request)
        return web.Response(status=int(request.match_info["code"]),
                            body=b"no")

    async def index(request):
        note(request)
        return web.Response(text=INDEX, content_type="text/html")

    async def gzipped(request):
        note(request)
        import gzip

        return web.Response(body=gzip.compress(CONTENT[:1000]),
                            headers={"Content-Encoding": "gzip"})

    app = web.Application()
    app.router.add_route("*", "/blob", blob)
    app.router.add_get("/plain", plain)
    app.router.add_get("/chunked", chunked)
    app.router.add_get("/cut", cut)
    app.router.add_route("*", "/status/{code}", status)
    app.router.add_get("/dir/", index)
    app.router.add_get("/gzip", gzipped)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}", stats


def _idle(client) -> int:
    """Kept-alive connections waiting for their next request."""
    return sum(len(c) for c in client._idle.values())


def _pair():
    return (JHTTP(), JRequest), (PHTTP(), PRequest)


async def _both(fn):
    """fn(client, Request) on the JAX client and the port's:
    [jax_result, port_result]."""
    out = []
    for client, req in _pair():
        try:
            out.append(await fn(client, req))
        finally:
            await client.close()
    return out


def _outcome_of(e: BaseException):
    assert isinstance(e, (JSourceError, SourceError)), repr(e)
    return ("error", int(e.code), bool(e.temporary))


async def _catch(coro):
    try:
        return await coro
    except (JSourceError, SourceError) as e:
        return _outcome_of(e)


@pytest.mark.parametrize("path", ["/blob", "/plain", "/chunked"])
def test_probe_and_length_equal_jax(run_async, path):
    async def body():
        runner, base, _ = await start_origin()
        try:
            async def probe(c, R):
                r = R(base + path)
                return (await c.probe(r), await c.get_content_length(r),
                        await c.is_support_range(r))

            jax, port = await _both(probe)
            assert port == jax
        finally:
            await runner.cleanup()

    run_async(body())


@pytest.mark.parametrize("rng", ["", "bytes=0-0", "bytes=5-1048580",
                                 f"bytes={len(CONTENT) - 9}-",
                                 "bytes=-100"])
@pytest.mark.parametrize("path", ["/blob", "/plain", "/chunked"])
def test_download_bytes_equal_jax(run_async, path, rng):
    async def body():
        runner, base, _ = await start_origin()
        try:
            async def get(c, R):
                r = R(base + path, {"Range": rng} if rng else {})
                resp = await c.download(r)
                data = await resp.read_all()
                return (resp.status, resp.content_length,
                        resp.support_range, resp.last_modified, data)

            jax, port = await _both(get)
            assert port == jax
            if path == "/blob" and rng:
                r = Range.parse_http(rng, len(CONTENT))
                assert port[4] == CONTENT[r.start:r.start + r.length]
            else:
                assert port[4] == CONTENT
        finally:
            await runner.cleanup()

    run_async(body())


@pytest.mark.parametrize("target", [
    "/status/404", "/status/401", "/status/403", "/status/408",
    "/status/418", "/status/429", "/status/500", "/status/503",
    "/blob?past=1"])
def test_status_codes_map_to_the_same_error(run_async, target):
    async def body():
        runner, base, _ = await start_origin()
        try:
            hdr = ({"Range": f"bytes={len(CONTENT) + 5}-"}
                   if "past" in target else {})

            async def get(c, R):
                return await _catch(c.download(R(base + target, hdr)))

            async def probe(c, R):
                if "past" in target:
                    return None        # a probe asks for byte 0
                return await _catch(c.probe(R(base + target)))

            jax, port = await _both(get)
            assert port == jax and port[0] == "error"
            code = int(target.split("/")[-1]) if "past" not in target \
                else 416
            want = {404: Code.SourceNotFound, 401: Code.SourceForbidden,
                    403: Code.SourceForbidden,
                    416: Code.SourceRangeUnsupported}.get(
                        code, Code.BackToSourceAborted)
            assert port[1] == want
            assert port[2] == (code in (408, 429) or code >= 500)
            jax, port = await _both(probe)
            assert port == jax
        finally:
            await runner.cleanup()

    run_async(body())


def test_a_cut_body_is_a_temporary_error(run_async):
    async def body():
        runner, base, _ = await start_origin()
        try:
            async def get(c, R):
                resp = await c.download(R(base + "/cut"))
                got = 0
                try:
                    async for chunk in resp.body:
                        got += len(chunk)
                except (JSourceError, SourceError) as e:
                    return _outcome_of(e), got <= len(CONTENT)
                finally:
                    await resp.close()
                return "no error", got

            jax, port = await _both(get)
            assert port == jax == (
                ("error", int(Code.BackToSourceAborted), True), True)
        finally:
            await runner.cleanup()

    run_async(body())


def test_unreachable_origin_is_a_temporary_error(run_async):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port_no = s.getsockname()[1]
    s.close()                                   # nothing listens there

    async def body():
        url = f"http://127.0.0.1:{port_no}/x"

        async def get(c, R):
            return await _catch(c.download(R(url)))

        async def probe(c, R):
            return await _catch(c.probe(R(url)))

        assert (await _both(get)) == [("error", 9000, True)] * 2
        assert (await _both(probe)) == [("error", 9000, True)] * 2

    run_async(body())


def test_last_modified_and_listing_equal_jax(run_async):
    async def body():
        runner, base, _ = await start_origin()
        try:
            async def meta(c, R):
                return (await c.get_last_modified(R(base + "/blob")),
                        await c.get_last_modified(R(base + "/status/404")),
                        [(e.url, e.name, e.is_dir) for e in
                         await c.list_metadata(R(base + "/dir/"))],
                        await _catch(c.list_metadata(
                            R(base + "/status/404"))))

            jax, port = await _both(meta)
            assert port == jax
            assert port[0] == LAST_MODIFIED and len(port[2]) == 2
        finally:
            await runner.cleanup()

    run_async(body())


def test_a_compressed_body_is_refused_where_jax_decompresses(run_async):
    """Intended divergence: the port asks for and accepts identity bodies
    only (a compressed one has no piece geometry before it is read); the
    JAX client's aiohttp decompresses."""
    async def body():
        runner, base, _ = await start_origin()
        try:
            async def get(c, R):
                try:
                    resp = await c.download(R(base + "/gzip"))
                except (JSourceError, SourceError) as e:
                    return _outcome_of(e)
                return await resp.read_all()

            jax, port = await _both(get)
            assert jax == CONTENT[:1000]
            assert port == ("error", int(Code.UnsupportedProtocol), False)
        finally:
            await runner.cleanup()

    run_async(body())


def test_sequential_requests_share_one_kept_alive_connection(run_async):
    async def body():
        runner, base, stats = await start_origin()
        client = PHTTP()
        try:
            r = PRequest(base + "/blob")
            assert await client.probe(r) == (len(CONTENT), True)
            for hdr in ({}, {"Range": "bytes=7-70"}):
                resp = await client.download(PRequest(r.url, hdr))
                await resp.read_all()
            assert await client.get_last_modified(r) == LAST_MODIFIED
            assert len(stats["peers"]) == 4
            assert len(set(stats["peers"])) == 1
            assert _idle(client) == 1
            names = [t.name for t in client._pool._threads]
            assert names and all(n.startswith("df-source-http")
                                 for n in names)
        finally:
            await client.close()
            await runner.cleanup()

    run_async(body())


def test_a_dead_kept_alive_connection_is_replaced(run_async):
    """A kept-alive connection cut meanwhile (the origin closed it, or a
    network stack reports a cut socket as aborted) raises a
    ConnectionError at its next use: the request goes out again on a
    fresh connection and succeeds."""
    async def body():
        runner, base, stats = await start_origin()
        client = PHTTP()
        try:
            r = PRequest(base + "/blob")
            assert await client.probe(r) == (len(CONTENT), True)
            idle = [c for conns in client._idle.values() for c in conns]
            assert len(idle) == 1
            idle[0].sock.shutdown(socket.SHUT_RDWR)
            resp = await client.download(r)
            assert await resp.read_all() == CONTENT
            assert len(set(stats["peers"])) == 2
            assert _idle(client) == 1
        finally:
            await client.close()
            await runner.cleanup()

    run_async(body())


def test_an_abandoned_body_closes_its_connection(run_async):
    async def body():
        runner, base, stats = await start_origin()
        client = PHTTP()
        try:
            resp = await client.download(PRequest(base + "/blob"))
            async for _ in resp.body:
                break
            await resp.close()
            assert _idle(client) == 0
            resp = await client.download(PRequest(base + "/blob"))
            assert await resp.read_all() == CONTENT
            assert len(set(stats["peers"])) == 2
        finally:
            await client.close()
            await runner.cleanup()

    run_async(body())


def test_registry_serves_file_and_http_only(run_async):
    assert isinstance(get_client("http://o/x"), PHTTP)
    assert get_client("https://o/x") is get_client("http://o/x")
    assert isinstance(get_client("file:///x"), PFile)
    with pytest.raises(SourceError) as e:
        get_client("s3://bucket/key")
    assert e.value.code == Code.UnsupportedProtocol


@pytest.mark.parametrize("rng", ["", "bytes=3-9", "bytes=1048570-",
                                 "bytes=-5"])
def test_file_client_equals_jax(run_async, tmp_path, rng):
    path = tmp_path / "f.bin"
    path.write_bytes(CONTENT)
    (tmp_path / "sub").mkdir()
    url = "file://" + str(path)

    async def body():
        out = []
        for client, R in ((JFile(), JRequest), (PFile(), PRequest)):
            resp = await client.download(R(url, {"Range": rng} if rng
                                           else {}))
            data = await resp.read_all()
            listing = [(e.name, e.is_dir, e.content_length) for e in
                       await client.list_metadata(R("file://" +
                                                    str(tmp_path)))]
            out.append((resp.status, resp.content_length,
                        resp.support_range, data,
                        await client.get_content_length(R(url)),
                        await client.is_support_range(R(url)), listing,
                        await _catch(client.download(
                            R(url + ".missing"))),
                        await _catch(client.get_content_length(
                            R(url + ".missing")))))
        assert out[1] == out[0]
        assert out[1][7] == ("error", int(Code.SourceNotFound), False)

    run_async(body())
    assert os.path.getsize(path) == len(CONTENT)
