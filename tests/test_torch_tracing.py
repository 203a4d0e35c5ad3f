"""The port's tracing (``dragonfly2_tpu_torch/pkg/tracing.py``) against the
JAX one (``dragonfly2_tpu/pkg/tracing.py``), and its wiring.

- ``traceparent``: each package parses the other's, garbage is refused
  alike.
- ``otlp_payload`` of the same spans (fixed ids, instants and attributes)
  is the JAX payload but for the instrumentation scope's name, the one
  intended difference.
- The metadata on drpc: inside the same span context a port ``Client``
  and a JAX ``Client`` send byte-identical CALL and SOPEN frames (the
  ``md`` map included), and a port client on a JAX server and a JAX
  client on a port server run the handler inside the caller's trace.
- The port's OTLP exporter lands spans in a collector on the standard
  library (``http.server``), and its thread is ``df-otlp-export``.
- The wiring: the ``rpc.<method>`` span around unary and stream
  handlers, ``dfget.download`` over ``Daemon.Download``, the piece
  downloader's ``traceparent`` header (read on the loop, sent from its
  worker thread), the upload server's ``upload.serve`` span and the
  gateway's ``gateway.get_object`` span joining the caller's trace.

The cases of ``tests/test_tracing.py`` run on both packages.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dragonfly2_tpu.pkg import tracing as jtr
from dragonfly2_tpu.pkg.types import NetAddr as JAddr
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu.rpc import Server as JServer
from dragonfly2_tpu_torch.pkg import tracing as ptr
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client, Server

PKGS = {"jax": jtr, "port": ptr}
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN = "00f067aa0ba902b7"


def test_constants_and_traceparent_cross_parse():
    assert jtr.TRACEPARENT == ptr.TRACEPARENT == "traceparent"
    for a, b in ((jtr, ptr), (ptr, jtr)):
        ctx = a.SpanContext(trace_id=TRACE, span_id=SPAN)
        tp = ctx.to_traceparent()
        assert tp == f"00-{TRACE}-{SPAN}-01"
        back = b.SpanContext.from_traceparent(tp)
        assert (back.trace_id, back.span_id) == (TRACE, SPAN)
    for bad in ("garbage", "00-abc-def-01", f"00-{TRACE}-{SPAN}",
                f"00-{TRACE}-{SPAN}0-01"):
        assert jtr.SpanContext.from_traceparent(bad) is None
        assert ptr.SpanContext.from_traceparent(bad) is None


def _spans(mod):
    out = []
    for i, (status, attrs) in enumerate((
            ("ok", {"peers": 3, "rate": 0.5, "seed": True, "name": "x"}),
            ("error", {}), ("ok", {"n": 1 << 40}))):
        sp = mod.Span(name=f"s{i}", context=mod.SpanContext(
            TRACE, f"{i:016x}"), parent_id=SPAN if i else "",
            start=1700000000.25 + i, attrs=attrs, status=status)
        sp.end = sp.start + 0.125
        sp.duration_s = 0.125
        out.append(sp)
    return out


def test_otlp_payload_matches_but_for_the_scope():
    j = jtr.otlp_payload(_spans(jtr), "svc")
    p = ptr.otlp_payload(_spans(ptr), "svc")
    scope = p["resourceSpans"][0]["scopeSpans"][0].pop("scope")
    assert scope == {"name": "dragonfly2_tpu_torch.pkg.tracing"}
    assert j["resourceSpans"][0]["scopeSpans"][0].pop("scope") == {
        "name": "dragonfly2_tpu.pkg.tracing"}
    assert j == p
    assert [s.to_json() for s in _spans(jtr)] == [
        s.to_json() for s in _spans(ptr)]


async def _capture_frames(n: int) -> tuple:
    """A raw TCP listener that records the payloads of the first ``n``
    frames of one connection and answers none of them."""
    got: list = []
    done = asyncio.Event()

    async def handle(reader, writer):
        try:
            while len(got) < n:
                (size,) = struct.unpack(">I", await reader.readexactly(4))
                got.append(await reader.readexactly(size))
            done.set()
            await reader.read()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], got, done


def test_md_bytes_on_drpc_are_the_jax_clients(run_async):
    """The same context, set in each package: a unary call and a stream
    open from each client produce the same frame bytes."""
    async def one(mod, client_cls, addr_cls):
        server, port, got, done = await _capture_frames(2)
        cli = client_cls(addr_cls.tcp("127.0.0.1", port))
        token = mod._current.set(mod.SpanContext(TRACE, SPAN))
        try:
            call = asyncio.ensure_future(cli.call("T.Echo", {"a": 1},
                                                  timeout=5.0))
            await asyncio.sleep(0.05)
            await cli.open_stream("T.Stream", {"b": [1, 2]})
            await asyncio.wait_for(done.wait(), 10)
        finally:
            mod._current.reset(token)
            call.cancel()
            await cli.close()
            server.close()
        # Untraced: no md at all.
        server, port, bare, done = await _capture_frames(1)
        cli = client_cls(addr_cls.tcp("127.0.0.1", port))
        call = asyncio.ensure_future(cli.call("T.Echo", {}, timeout=5.0))
        await asyncio.wait_for(done.wait(), 10)
        call.cancel()
        await cli.close()
        server.close()
        return got, bare

    async def run():
        j = await one(jtr, JClient, JAddr)
        p = await one(ptr, Client, NetAddr)
        return j, p

    (jgot, jbare), (pgot, pbare) = run_async(run(), timeout=60)
    assert jgot == pgot and jbare == pbare
    from dragonfly2_tpu_torch.rpc import codec

    frames = [codec.unpackb(b) for b in pgot]
    assert [f["md"] for f in frames] == [
        {"traceparent": f"00-{TRACE}-{SPAN}-01"}] * 2
    assert "md" not in codec.unpackb(pbare[0])


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_a_jax_and_a_port_peer_share_one_trace(run_async, client_pkg):
    """A client of one package calls (unary and a stream) a server of the
    other inside a span: the handler runs inside the caller's trace, and
    the server's ``rpc.<method>`` spans carry it with the caller's span
    as parent."""
    cmod, smod = (jtr, ptr) if client_pkg == "jax" else (ptr, jtr)
    ccls, caddr = (JClient, JAddr) if client_pkg == "jax" else (
        Client, NetAddr)
    scls, saddr = (Server, NetAddr) if client_pkg == "jax" else (
        JServer, JAddr)

    async def run():
        smod.exporter().clear()
        server = scls("traced")

        async def unary(body, ctx):
            cur = smod.current()
            return {"trace_id": cur.trace_id if cur else ""}

        async def stream(s, ctx):
            cur = smod.current()
            await s.send({"trace_id": cur.trace_id if cur else ""})

        server.register_unary("T.Echo", unary)
        server.register_stream("T.Stream", stream)
        await server.serve(saddr.tcp("127.0.0.1", 0))
        cli = ccls(caddr.tcp("127.0.0.1", server.port()))
        try:
            with cmod.span("client.op") as sp:
                resp = await cli.call("T.Echo", {})
                st = await cli.open_stream("T.Stream", {})
                msg = await st.recv(timeout=10)
            untraced = await cli.call("T.Echo", {})
        finally:
            await cli.close()
            await server.close()
        for _ in range(100):
            if smod.exporter().find(name="rpc.T.Stream"):
                break
            await asyncio.sleep(0.02)
        return sp, resp, msg, untraced

    sp, resp, msg, untraced = run_async(run(), timeout=60)
    trace = sp.context.trace_id
    assert resp["trace_id"] == msg["trace_id"] == trace
    assert untraced["trace_id"] and untraced["trace_id"] != trace
    for name in ("rpc.T.Echo", "rpc.T.Stream"):
        spans = smod.exporter().find(name=name, trace_id=trace)
        assert len(spans) == 1, name
        assert spans[0].parent_id == sp.context.span_id
        assert spans[0].attrs["peer"].startswith("(")


# --------------------------------------------------------------------- #
# OTLP export to a collector on the standard library
# --------------------------------------------------------------------- #

class _Collector(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _CollectorHandler)
        self.payloads: list = []
        self.thread = threading.Thread(target=self.serve_forever,
                                       name="df-ut-collector", daemon=True)
        self.thread.start()

    def spans(self) -> list:
        return [s for p in self.payloads for rs in p["resourceSpans"]
                for ss in rs["scopeSpans"] for s in ss["spans"]]

    def close(self):
        self.shutdown()
        self.server_close()


class _CollectorHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):
        assert self.path == "/v1/traces"
        assert self.headers["Content-Type"] == "application/json"
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.payloads.append(json.loads(body))
        out = b'{"partialSuccess": {}}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


def test_otlp_export_lands_in_a_collector():
    col = _Collector()
    exp = ptr.exporter()
    otlp = exp.set_otlp(f"http://127.0.0.1:{col.server_address[1]}",
                        service_name="df-test", flush_interval=0.05)
    try:
        assert otlp._thread.name == "df-otlp-export"
        with ptr.span("parent", peers=3, rate=0.5, seed=True):
            with ptr.span("child"):
                pass
        try:
            with ptr.span("broken"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        otlp.flush(timeout=10)
        assert otlp.sent_spans == 3 and otlp.dropped_spans == 0
        by_name = {s["name"]: s for s in col.spans()}
        parent, child = by_name["parent"], by_name["child"]
        assert child["traceId"] == parent["traceId"]
        assert child["parentSpanId"] == parent["spanId"]
        attrs = {a["key"]: a["value"] for a in parent["attributes"]}
        assert attrs == {"peers": {"intValue": "3"},
                         "rate": {"doubleValue": 0.5},
                         "seed": {"boolValue": True}}
        assert by_name["broken"]["status"] == {"code": 2,
                                               "message": "error"}
        svc = col.payloads[0]["resourceSpans"][0]["resource"]["attributes"]
        assert svc == [{"key": "service.name",
                        "value": {"stringValue": "df-test"}}]
    finally:
        exp.set_otlp("")
        col.close()
    assert exp.otlp is None


def test_an_unreachable_collector_drops_and_counts():
    from dragonfly2_tpu_torch.pkg import metrics

    before = ptr.OTLP_SPANS.value("dropped")
    exp = ptr.exporter()
    otlp = exp.set_otlp("http://127.0.0.1:9", flush_interval=0.05,
                        timeout=1.0)
    try:
        with ptr.span("lost"):
            pass
        otlp.flush(timeout=10)
        assert otlp.dropped_spans == 1 and otlp.sent_spans == 0
    finally:
        exp.set_otlp("")
    assert ptr.OTLP_SPANS.value("dropped") - before == 1
    assert b"tracing_otlp_spans_total" in metrics.render()[0]


# The cases of tests/test_tracing.py, on both packages.

@pytest.mark.parametrize("pkg", PKGS)
def test_span_nesting_attrs_and_error_status(pkg):
    mod = PKGS[pkg]
    mod.exporter().clear()
    with mod.span("outer", kind="test") as outer:
        trace_id = mod.current().trace_id
        with mod.span("inner") as inner:
            assert mod.current().trace_id == trace_id
            assert inner.parent_id == outer.context.span_id
            assert mod.inject() == {
                "traceparent": inner.context.to_traceparent()}
    assert mod.current() is None and mod.inject() == {}
    assert {s.name for s in mod.exporter().find(trace_id=trace_id)} == {
        "outer", "inner"}
    with pytest.raises(ValueError):
        with mod.span("boom"):
            raise ValueError("x")
    assert mod.exporter().find(name="boom")[0].status == "error"


@pytest.mark.parametrize("pkg", PKGS)
def test_jsonl_export(pkg, tmp_path):
    mod = PKGS[pkg]
    path = tmp_path / "spans.jsonl"
    exp = mod.exporter()
    exp.set_file(str(path))
    try:
        with mod.span("filed", n=1):
            pass
    finally:
        exp.set_file("")
    row = json.loads(path.read_text().splitlines()[-1])
    assert row["name"] == "filed" and row["attrs"] == {"n": 1}
    assert set(row) == {"name", "trace_id", "span_id", "parent_id",
                        "start", "end", "duration_ms", "attrs", "status"}


@pytest.mark.parametrize("pkg", PKGS)
def test_extract_adopts_metadata(pkg):
    mod = PKGS[pkg]
    with mod.extract({"traceparent": f"00-{TRACE}-{SPAN}-01"}, "srv",
                     a=1) as sp:
        assert sp.context.trace_id == TRACE and sp.parent_id == SPAN
    assert mod.current() is None
    with mod.extract(None, "root") as sp:
        assert sp.parent_id == "" and len(sp.context.trace_id) == 32
    with mod.extract({"traceparent": "junk"}, "root2") as sp:
        assert sp.parent_id == ""


# --------------------------------------------------------------------- #
# The wiring
# --------------------------------------------------------------------- #

def test_dfget_download_span_rides_daemon_download(run_async, tmp_path):
    """``dfget.download`` opens ``Daemon.Download`` inside its span: the
    daemon's ``rpc.Daemon.Download`` span is its child and the span
    carries the task id the final frame named."""
    from dragonfly2_tpu_torch.client import dfget as pdfget

    sock = str(tmp_path / "d.sock")

    async def run():
        ptr.exporter().clear()
        server = Server("daemon")

        async def download(stream, ctx):
            await stream.send({"state": "done", "task_id": "t" * 64,
                               "completed_length": 1})

        server.register_stream("Daemon.Download", download)
        await server.serve(NetAddr.unix(sock))
        try:
            return await pdfget.download(pdfget.DfgetConfig(
                url="http://o/x", output=str(tmp_path / "o"),
                daemon_sock=sock))
        finally:
            await server.close()

    result = run_async(run(), timeout=30)
    assert result["task_id"] == "t" * 64
    (top,) = ptr.exporter().find(name="dfget.download")
    assert top.attrs == {"url": "http://o/x", "task_id": "t" * 64}
    (srv,) = ptr.exporter().find(name="rpc.Daemon.Download")
    assert srv.context.trace_id == top.context.trace_id
    assert srv.parent_id == top.context.span_id


class _HeaderRecorder(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _RecordHandler)
        self.seen: list = []
        threading.Thread(target=self.serve_forever, name="df-ut-headers",
                         daemon=True).start()


class _RecordHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_GET(self):
        self.server.seen.append((self.path, self.headers.get("traceparent"),
                                 self.headers.get("Range")))
        body = b"x" * 8
        self.send_response(206)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Content-Range", "bytes 0-7/8")
        self.end_headers()
        self.wfile.write(body)


def test_the_piece_downloader_sends_the_loops_trace_context(run_async):
    """The piece GET leaves from a ``df-piece-http`` thread with the
    ``traceparent`` of the span that was current on the loop; with no
    span, no header."""
    from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
        PieceDownloader,
    )

    rec = _HeaderRecorder()

    async def run():
        dl = PieceDownloader()
        try:
            with ptr.span("conductor") as sp:
                await dl.download_piece("127.0.0.1", rec.server_address[1],
                                        "a" * 64, 0, expected_size=8)
            await dl.download_piece("127.0.0.1", rec.server_address[1],
                                    "a" * 64, 1, expected_size=8)
            return sp
        finally:
            await dl.close()

    sp = run_async(run(), timeout=30)
    rec.shutdown()
    rec.server_close()
    assert [tp for _, tp, _ in rec.seen] == [sp.context.to_traceparent(),
                                            None]


def test_the_upload_server_joins_the_requesters_trace(tmp_path):
    """A download request with a ``traceparent`` is served inside an
    ``upload.serve`` span of that trace (its task attribute set), also
    when the answer is an error; ``/healthy`` opens no span."""
    from dragonfly2_tpu_torch.daemon.upload import UploadManager

    class NoStores:
        def try_get(self, task_id):
            return None

    up = UploadManager(NoStores())
    port = up.serve("127.0.0.1", 0)
    ptr.exporter().clear()
    ctx = ptr.SpanContext(TRACE, SPAN)
    try:
        for path, status in ((f"/download/abc/{'b' * 64}?pieceNum=0", 404),
                             ("/healthy", 200)):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("GET", path,
                      headers={"traceparent": ctx.to_traceparent()})
            r = c.getresponse()
            r.read()
            c.close()
            assert r.status == status
    finally:
        up.close()
    (sp,) = ptr.exporter().find(name="upload.serve")
    assert sp.context.trace_id == TRACE and sp.parent_id == SPAN
    assert sp.attrs == {"task": "b" * 16} and sp.status == "error"


def test_the_gateway_get_joins_the_callers_trace(run_async, tmp_path):
    """A GET with a ``traceparent`` runs its fetch inside a
    ``gateway.get_object`` span of that trace."""
    from dragonfly2_tpu_torch.daemon.objectstorage import (
        ObjectStorageService,
    )
    from dragonfly2_tpu_torch.pkg.objectstorage.fs import FSObjectStorage

    def get(port):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/buckets/bk/objects/absent", headers={
            "traceparent": f"00-{TRACE}-{SPAN}-01"})
        r = c.getresponse()
        r.read()
        c.close()
        return r.status

    seen = []

    class Transport:
        async def fetch(self, url, headers):
            seen.append(ptr.current().trace_id)
            raise ValueError("no fabric here")

    async def run():
        (tmp_path / "bk").mkdir()
        gw = ObjectStorageService(FSObjectStorage(str(tmp_path)),
                                  Transport())
        port = await gw.serve("127.0.0.1", 0)
        ptr.exporter().clear()
        try:
            return await asyncio.to_thread(get, port)
        finally:
            await gw.close()

    assert run_async(run(), timeout=30) == 502
    assert seen == [TRACE]      # the fetch ran inside the caller's trace
    (sp,) = ptr.exporter().find(name="gateway.get_object")
    assert sp.context.trace_id == TRACE and sp.parent_id == SPAN
    assert sp.attrs == {"bucket": "bk"}
