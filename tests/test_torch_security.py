"""TLS on the port's drpc and upload server, against the JAX package's.

- drpc over TLS and mTLS, crossed both ways: the port's client against
  the JAX server and the JAX client against the port's server (and each
  against its own); a client with no certificate is refused by an mTLS
  server; a unix socket stays plaintext; TLS over vsock is refused, never
  downgraded. Certificates come from the ``openssl`` command, as in
  ``tests/test_security.py``.
- The upload server over TLS answers every request of the plaintext
  comparison (``tests/test_torch_p2p.py``'s cases) as the JAX upload
  server over TLS does, the payloads the store's exact bytes; the
  plaintext path sends its bodies by ``os.sendfile``, the TLS path never.

Tolerance 0.
"""

from __future__ import annotations

import asyncio
import http.client
import os
import socket
import ssl
import subprocess
import threading

import pytest

from dragonfly2_tpu.daemon.upload import UploadManager as JUpload
from dragonfly2_tpu.pkg import security as jsecurity
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu.rpc import Server as JServer
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu.storage import TaskStoreMetadata as JMetadata
from dragonfly2_tpu_torch.daemon import upload as pupload
from dragonfly2_tpu_torch.pkg import security as psecurity
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client, Server
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption
from dragonfly2_tpu_torch.storage.local_store import TaskStoreMetadata
from tests.test_torch_p2p import _UPLOAD, UPLOAD_CASES, _fill_stores

SIDES = {"port": (Server, Client, NetAddr, psecurity),
         "jax": (JServer, JClient, JNetAddr, jsecurity)}


def _openssl(*args) -> None:
    subprocess.run(["openssl", *args], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(d / "ca.key"), "-out", str(d / "ca.crt"),
             "-days", "1", "-subj", "/CN=df-test-ca")
    for name in ("server", "client"):
        _openssl("req", "-newkey", "rsa:2048", "-nodes",
                 "-keyout", str(d / f"{name}.key"),
                 "-out", str(d / f"{name}.csr"), "-subj", f"/CN=df-{name}")
        _openssl("x509", "-req", "-in", str(d / f"{name}.csr"),
                 "-CA", str(d / "ca.crt"), "-CAkey", str(d / "ca.key"),
                 "-CAcreateserial", "-days", "1",
                 "-out", str(d / f"{name}.crt"))
    return d


def test_the_security_contexts_are_the_jax_ones(certs):
    for kw in ({}, {"ca_file": str(certs / "ca.crt")},
               {"ca_file": str(certs / "ca.crt"),
                "require_client_cert": True}):
        got = psecurity.server_ssl_context(
            str(certs / "server.crt"), str(certs / "server.key"), **kw)
        want = jsecurity.server_ssl_context(
            str(certs / "server.crt"), str(certs / "server.key"), **kw)
        assert (got.protocol, got.verify_mode, got.check_hostname) == (
            want.protocol, want.verify_mode, want.check_hostname)
    for kw in ({}, {"verify": False}, {"ca_file": str(certs / "ca.crt")},
               {"ca_file": str(certs / "ca.crt"),
                "cert_file": str(certs / "client.crt"),
                "key_file": str(certs / "client.key")}):
        got, want = (psecurity.client_ssl_context(**kw),
                     jsecurity.client_ssl_context(**kw))
        assert (got.protocol, got.verify_mode, got.check_hostname) == (
            want.protocol, want.verify_mode, want.check_hostname)


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("mtls", [False, True])
def test_drpc_over_tls_crossed(run_async, certs, server, client, mtls):
    srv_cls, _, srv_addr, srv_sec = SIDES[server]
    _, cli_cls, cli_addr, cli_sec = SIDES[client]

    async def run():
        srv = srv_cls("tls")

        async def echo(body, ctx):
            return {"echo": body}

        srv.register_unary("T.Echo", echo)
        await srv.serve(srv_addr.tcp("127.0.0.1", 0),
                        ssl_context=srv_sec.server_ssl_context(
                            str(certs / "server.crt"),
                            str(certs / "server.key"),
                            ca_file=str(certs / "ca.crt") if mtls else "",
                            require_client_cert=mtls))
        port = srv.port()
        out = []
        try:
            if mtls:
                bare = cli_cls(cli_addr.tcp("127.0.0.1", port),
                               ssl_context=cli_sec.client_ssl_context(
                                   ca_file=str(certs / "ca.crt")))
                try:
                    with pytest.raises(DfError if client == "port"
                                       else Exception):
                        await bare.call("T.Echo", {}, timeout=5.0)
                finally:
                    await bare.close()
            plain = cli_cls(cli_addr.tcp("127.0.0.1", port))
            try:
                # A plaintext client gets no answer from a TLS listener.
                with pytest.raises(Exception):
                    await plain.call("T.Echo", {}, timeout=2.0)
            finally:
                await plain.close()
            cert = {"cert_file": str(certs / "client.crt"),
                    "key_file": str(certs / "client.key")} if mtls else {}
            cli = cli_cls(cli_addr.tcp("127.0.0.1", port),
                          ssl_context=cli_sec.client_ssl_context(
                              ca_file=str(certs / "ca.crt"), **cert))
            try:
                for body in ({"x": 1}, {"b": b"\x00" * 70000, "s": "é"}):
                    out.append((await cli.call("T.Echo", body))["echo"])
            finally:
                await cli.close()
        finally:
            await srv.close()
        return out

    assert run_async(run(), timeout=60) == [
        {"x": 1}, {"b": b"\x00" * 70000, "s": "é"}]


def test_a_unix_socket_stays_plaintext_and_vsock_refuses_tls(run_async,
                                                            tmp_path, certs):
    async def run():
        srv = Server("unix")

        async def echo(body, ctx):
            return {"ok": True}

        srv.register_unary("T.Echo", echo)
        path = str(tmp_path / "s.sock")
        ctx = psecurity.server_ssl_context(str(certs / "server.crt"),
                                           str(certs / "server.key"))
        await srv.serve(NetAddr.unix(path), ssl_context=ctx)
        cli = Client(NetAddr.unix(path), ssl_context=psecurity
                     .client_ssl_context(ca_file=str(certs / "ca.crt")))
        try:
            assert await cli.call("T.Echo", {}) == {"ok": True}
        finally:
            await cli.close()
            await srv.close()
        v = Client(NetAddr.vsock(3, 1), ssl_context=ctx)
        try:
            with pytest.raises(DfError, match="vsock"):
                await v.call("T.Echo", {}, timeout=2.0)
        finally:
            await v.close()

    run_async(run(), timeout=30)


def _get_tls(port: int, path: str, headers: dict, ca: str):
    ctx = ssl.create_default_context(cafile=ca)
    ctx.check_hostname = False
    conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=10,
                                       context=ctx)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        return (resp.status, body if resp.status < 300 else None,
                resp.getheader("Content-Range"))
    finally:
        conn.close()


@pytest.fixture
def sendfile_threads(monkeypatch):
    """The names of the threads that called ``os.sendfile``."""
    names = []
    real = os.sendfile

    def counted(*args):
        names.append(threading.current_thread().name)
        return real(*args)

    monkeypatch.setattr(os, "sendfile", counted)
    return names


@pytest.mark.parametrize("case", UPLOAD_CASES)
def test_the_upload_server_over_tls_answers_as_the_jax_one(
        run_async, tmp_path, certs, case, sendfile_threads):
    path, headers = UPLOAD_CASES[case]
    crt, key, ca = (str(certs / "server.crt"), str(certs / "server.key"),
                    str(certs / "ca.crt"))

    async def body():
        jax = JUpload(_fill_stores(lambda: JSM(JSMOption(
            data_dir=str(tmp_path / "j"))), JMetadata),
            ssl_context=jsecurity.server_ssl_context(crt, key))
        port = pupload.UploadManager(_fill_stores(lambda: StorageManager(
            StorageOption(data_dir=str(tmp_path / "p"))), TaskStoreMetadata),
            ssl_context=psecurity.server_ssl_context(crt, key))
        jport = await jax.serve("127.0.0.1")
        pport = port.serve("127.0.0.1")
        if case == "over the limit":
            for m in (jax, port):
                m.concurrent_limit, m.concurrent = 1, 1
        try:
            return (await asyncio.to_thread(_get_tls, jport, path, headers,
                                            ca),
                    await asyncio.to_thread(_get_tls, pport, path, headers,
                                            ca))
        finally:
            await jax.close()
            port.close()

    want, got = run_async(body(), timeout=30)
    assert got == want
    if want[0] == 206:
        rng = want[2].split()[1].split("/")[0]
        start, end = (int(x) for x in rng.split("-"))
        assert got[1] == _UPLOAD[start:end + 1]
    assert [n for n in sendfile_threads if n.startswith("df-upload")] == []


def test_the_plaintext_upload_path_keeps_sendfile(tmp_path, certs,
                                                  sendfile_threads):
    """The same store served plaintext and over TLS: equal bytes, and
    only the plaintext server called ``os.sendfile``; a plaintext client
    at the TLS server gets no answer."""
    storage = _fill_stores(lambda: StorageManager(
        StorageOption(data_dir=str(tmp_path / "p"))), TaskStoreMetadata)
    plain = pupload.UploadManager(storage)
    tls = pupload.UploadManager(storage, ssl_context=psecurity
                                .server_ssl_context(
                                    str(certs / "server.crt"),
                                    str(certs / "server.key")))
    pport, tport = plain.serve("127.0.0.1"), tls.serve("127.0.0.1")
    path = "/download/don/done?pieceNum=3"
    try:
        conn = http.client.HTTPConnection("127.0.0.1", pport, timeout=10)
        conn.request("GET", path)
        got_plain = conn.getresponse().read()
        conn.close()
        assert len(sendfile_threads) >= 1
        assert all(n == "df-upload" for n in sendfile_threads)
        del sendfile_threads[:]
        got_tls = _get_tls(tport, path, {}, str(certs / "ca.crt"))[1]
        assert got_plain == got_tls == _UPLOAD[3 * 4096:4 * 4096]
        assert sendfile_threads == []
        with socket.create_connection(("127.0.0.1", tport), timeout=10) as s:
            s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            try:
                answer = s.recv(4096)
            except (ConnectionError, socket.timeout):
                answer = b""
            assert not answer.startswith(b"HTTP/")
    finally:
        plain.close()
        tls.close()
        storage.close()
