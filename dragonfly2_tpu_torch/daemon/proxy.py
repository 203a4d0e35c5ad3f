"""HTTP(S) forward proxy and registry mirror over the P2P fabric: the
port's copy of ``dragonfly2_tpu/daemon/proxy.py``.

Reference: ``client/daemon/proxy/proxy.go``: ServeHTTP, CONNECT with TLS
hijack (handleHTTPS), the SNI proxy (``proxy_sni.go``), mirrorRegistry,
the shouldUseDragonfly rules, basic auth, the max-concurrency gate and
the white-listed ports.

``Proxy`` is a raw asyncio stream server, as in JAX: a keep-alive request
loop; basic auth on the outer hop (407); past ``max_concurrency`` a 503
that closes the connection; CONNECT to a port outside
``white_list_ports`` (when the list is set) a 403. A GET the transport's
rules send to P2P is served from a stream task (``_serve_p2p``): 200 or
206, 416 for a range at or past the end, the body by ``loop.sendfile``
when the store holds the window (through a TLS tunnel, reads of
``TLS_SEND_CHUNK`` written through the TLS layer, where the JAX proxy's
``fallback=True`` copy reads 16 KiB at a time, each read a trip to a
worker thread), else streamed with a known length or chunked. A stream task that
fails before its first byte goes direct, as the JAX proxy does.

HTTPS interception: with a ``CertAuthority`` (``pkg/certify``), a CONNECT
to a host matching ``hijack_hosts`` (any host when the list is empty) is
answered 200 and the client's side upgraded by ``writer.start_tls`` with
a leaf forged for the host; its decrypted requests run through the same
rules against ``https://<host>``. Other hosts get a blind relay. The SNI
listener (``serve_sni``) takes direct TLS connections and routes them by
the ClientHello's server name: terminated with a forged leaf when
hijacking, else peeked (``parse_sni``) and spliced to ``<sni>:443``.

The pass-through (``_serve_direct``; the JAX proxy's runs on ``aiohttp``,
which the card machine does not have) is the origin client's
``http.client`` machinery (``source/clients/http.py``) on
``df-proxy-http`` worker threads: connections kept alive per origin (a
kept-alive one found stale is replaced once), no redirect followed, no
decompression, the body handed to the loop chunk by chunk, and a cancel
cuts the call's connection (``pkg/bufpool.WorkerCall``). Its TLS trust is
the origin client's: ``DRAGONFLY_SSL_CA_FILE`` adds a CA,
``DRAGONFLY_SSL_INSECURE=1`` checks nothing. HEAD, 204, 304 and 1xx relay
the upstream ``Content-Length`` and send no body; an upstream failure
before the answer's head answers 502.

``close`` also cancels the connections still open (an idle kept-alive
client would otherwise hold the server's ``wait_closed``), and with them
their pass-through calls. Metric families: ``proxy_requests_total{via}``
and ``proxy_bytes_total{via}``.
"""

from __future__ import annotations

import asyncio
import base64
import http.client
import os
import re
import ssl as ssl_mod
import time
from urllib.parse import urljoin, urlsplit

from dragonfly2_tpu_torch.daemon.transport import P2PTransport
from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.bufpool import WorkerCall
from dragonfly2_tpu_torch.pkg.errors import DfError
from dragonfly2_tpu_torch.source.clients.http import (
    HTTPSourceClient,
    _Exchange,
)

log = dflog.get("daemon.proxy")

PROXY_REQUESTS = metrics.counter("proxy_requests_total", "Proxy requests",
                                 ("via",))
PROXY_BYTES = metrics.counter("proxy_bytes_total", "Proxy bytes served",
                              ("via",))

_HOP_HEADERS = {"connection", "proxy-connection", "keep-alive", "te", "trailer",
                "transfer-encoding", "upgrade", "proxy-authorization"}

# A TLS tunnel's sendfile window goes out in reads of this size.
TLS_SEND_CHUNK = 1 << 20
# The pass-through's body reads, and its time for a request and its body.
DIRECT_CHUNK = 256 << 10
DIRECT_TIMEOUT = 300.0


def parse_sni(record: bytes) -> str | None:
    """The server_name of a raw TLS ClientHello record (RFC 8446 §4.1.2,
    RFC 6066 §3); None for anything malformed (no SNI)."""
    try:
        if record[0] != 0x16 or record[5] != 0x01:  # handshake / ClientHello
            return None
        i = 9                      # record(5) + handshake type/len(4)
        i += 2 + 32                # client version + random
        i += 1 + record[i]         # session id
        cs_len = int.from_bytes(record[i:i + 2], "big")
        i += 2 + cs_len            # cipher suites
        i += 1 + record[i]         # compression methods
        ext_end = i + 2 + int.from_bytes(record[i:i + 2], "big")
        i += 2
        while i + 4 <= ext_end:
            ext_type = int.from_bytes(record[i:i + 2], "big")
            ext_len = int.from_bytes(record[i + 2:i + 4], "big")
            i += 4
            if ext_type == 0:      # server_name
                # list len(2) + type(1) + name len(2) + name
                name_len = int.from_bytes(record[i + 3:i + 5], "big")
                return record[i + 5:i + 5 + name_len].decode("idna")
            i += ext_len
    except (IndexError, UnicodeError):
        pass
    return None


def _hget(headers: dict[str, str], name: str, default: str = "") -> str:
    """Case-insensitive header lookup (HTTP/2 hops lowercase names)."""
    lname = name.lower()
    for k, v in headers.items():
        if k.lower() == lname:
            return v
    return default


class _Direct(HTTPSourceClient):
    """The pass-through's upstream client: the origin client's kept-alive
    connections, trust and cancellable worker calls, on ``df-proxy-http``
    threads. The request goes as it came (any method, its body, no
    redirect followed) and every status comes back; a request and its
    body have ``DIRECT_TIMEOUT`` in all, as aiohttp's default gives."""

    THREADS = "proxy-http"

    def exchange(self, call: WorkerCall, method: str, url: str,
                 headers: dict, body: bytes) -> _Exchange:
        """Send the request and read the answer's head. Raises OSError,
        HTTPException or ValueError."""
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"unsupported url {url!r}")
        key = (parts.scheme, parts.hostname,
               parts.port or (443 if parts.scheme == "https" else 80))
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query
                                      else "")
        deadline = time.monotonic() + DIRECT_TIMEOUT
        while True:
            conn, reused = self._checkout(key)
            try:
                call.attach(conn)
                if reused:
                    conn.sock.settimeout(self._wait_budget(deadline))
                conn.request(method, path, body=body or None, headers=headers)
                conn.sock.settimeout(self._wait_budget(deadline))
                return _Exchange(key, conn, conn.getresponse(), url, deadline)
            except ConnectionError:
                # A kept-alive connection the origin closed: once more on
                # a fresh one.
                conn.close()
                if not reused or call.stopped:
                    raise
            except BaseException:
                conn.close()
                raise
            finally:
                call.detach(conn)


class Proxy:
    def __init__(self, transport: P2PTransport, *, registry_mirror: str = "",
                 basic_auth: tuple[str, str] | None = None,
                 max_concurrency: int = 0,
                 white_list_ports: list[int] | None = None,
                 cert_authority=None,
                 hijack_hosts: list[str] | None = None):
        self.transport = transport
        self.registry_mirror = registry_mirror.rstrip("/")
        self.basic_auth = basic_auth
        self.max_concurrency = max_concurrency
        self.white_list_ports = white_list_ports or []
        # A pkg.certify.CertAuthority; None: a blind relay for every
        # CONNECT.
        self.ca = cert_authority
        self.hijack_hosts = [re.compile(p) for p in hijack_hosts or []]
        self._inflight = 0
        self._server: asyncio.AbstractServer | None = None
        self._sni_server: asyncio.AbstractServer | None = None
        self._direct = _Direct()
        self._conns: set[asyncio.Task] = set()
        self._port = 0
        self._sni_port = 0

    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle_conn, host, port)
        self._port = self._server.sockets[0].getsockname()[1]
        log.info("proxy up", port=self._port,
                 mirror=self.registry_mirror or None)
        return self._port

    @property
    def port(self) -> int:
        return self._port

    async def serve_sni(self, host: str = "127.0.0.1", port: int = 0,
                        *, hijack: bool = False) -> int:
        """The SNI listener (reference proxy_sni.go): raw TLS connections
        routed by the ClientHello's server name. ``hijack`` terminates TLS
        with a forged leaf and serves through the rules; otherwise the
        ClientHello is peeked and spliced to <sni-host>:443."""
        if hijack and self.ca is None:
            raise ValueError("SNI hijack requires a cert_authority")

        async def handle(reader, writer):
            await self._handle_sni_conn(reader, writer, hijack)

        self._sni_server = await asyncio.start_server(handle, host, port)
        self._sni_port = self._sni_server.sockets[0].getsockname()[1]
        log.info("sni proxy up", port=self._sni_port, hijack=hijack)
        return self._sni_port

    async def close(self) -> None:
        for server in (self._server, self._sni_server):
            if server is not None:
                server.close()
        # Connections still open (an idle kept-alive client would hold
        # wait_closed), and their pass-through calls, are cut.
        conns = list(self._conns)
        for task in conns:
            task.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._direct.close()
        for server in (self._server, self._sni_server):
            if server is not None:
                await server.wait_closed()
        self._server = self._sni_server = None

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns.add(asyncio.current_task())
        try:
            await self._request_loop(reader, writer, scheme="http",
                                     tunnel_host="")
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            log.error("proxy connection error", exc_info=True)
        finally:
            self._conns.discard(asyncio.current_task())
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _request_loop(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter, *,
                            scheme: str, tunnel_host: str) -> None:
        """Keep-alive request loop. Inside a hijacked tunnel the client
        speaks origin-form requests against https://tunnel_host."""
        while True:
            request = await self._read_request(reader)
            if request is None:
                break
            method, target, version, headers = request
            if (self.basic_auth and scheme == "http"
                    and not self._check_auth(headers)):
                # Proxy auth rides the outer hop only: inside a hijacked
                # tunnel the client believes it talks to the origin.
                await self._respond(writer, 407, b"proxy auth required",
                                    extra="Proxy-Authenticate: Basic realm=\"dragonfly\"\r\n")
                break
            if self.max_concurrency and self._inflight >= self.max_concurrency:
                # An unread request body would desync the keep-alive
                # stream: shed load by closing the connection.
                await self._respond(writer, 503, b"proxy at max concurrency",
                                    extra="Connection: close\r\n")
                break
            self._inflight += 1
            try:
                if method == "CONNECT" and scheme == "http":
                    await self._handle_connect(target, reader, writer)
                    return  # the tunnel consumed the connection
                keep_alive = await self._handle_http(
                    method, target, headers, reader, writer,
                    scheme=scheme, tunnel_host=tunnel_host)
                if not keep_alive:
                    break
                if _hget(headers, "Connection").lower() == "close":
                    break
            finally:
                self._inflight -= 1

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        try:
            line = await reader.readline()
        except (ConnectionError, asyncio.LimitOverrunError):
            return None
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, target, version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if not hline or hline in (b"\r\n", b"\n"):
                break
            k, _, v = hline.decode("latin1").partition(":")
            headers[k.strip()] = v.strip()
        return method.upper(), target, version, headers

    def _check_auth(self, headers: dict[str, str]) -> bool:
        cred = _hget(headers, "Proxy-Authorization")
        if not cred.startswith("Basic "):
            return False
        try:
            user, _, pw = base64.b64decode(cred[6:]).decode().partition(":")
        except Exception:
            return False
        return (user, pw) == self.basic_auth

    # -- CONNECT tunnel ----------------------------------------------------

    def _should_hijack(self, host: str) -> bool:
        if self.ca is None:
            return False
        if not self.hijack_hosts:
            return True
        return any(p.search(host) for p in self.hijack_hosts)

    @staticmethod
    async def _relay(src: asyncio.StreamReader,
                     dst: asyncio.StreamWriter) -> None:
        try:
            while True:
                data = await src.read(64 << 10)
                if not data:
                    break
                dst.write(data)
                await dst.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                dst.close()
            except Exception:
                pass

    async def _handle_connect(self, target: str, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        host, _, port_s = target.partition(":")
        port = int(port_s or 443)
        if self.white_list_ports and port not in self.white_list_ports:
            await self._respond(writer, 403, b"port not allowed")
            return
        if self._should_hijack(host):
            await self._handle_connect_hijack(host, reader, writer)
            return
        try:
            up_reader, up_writer = await asyncio.open_connection(host, port)
        except OSError as e:
            await self._respond(writer, 502, f"connect failed: {e}".encode())
            return
        writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
        await writer.drain()
        PROXY_REQUESTS.labels("tunnel").inc()
        await asyncio.gather(self._relay(reader, up_writer),
                             self._relay(up_reader, writer))

    async def _handle_connect_hijack(self, host: str,
                                     reader: asyncio.StreamReader,
                                     writer: asyncio.StreamWriter) -> None:
        """Answer the CONNECT, upgrade the client's side to TLS with a
        leaf forged for ``host``, then serve the decrypted requests
        through the rules: registry blob GETs ride P2P."""
        writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
        await writer.drain()
        try:
            await writer.start_tls(self.ca.server_context(host))
        except (ssl_mod.SSLError, ConnectionError, OSError) as e:
            # The client refused the leaf (the CA is not installed) or
            # the handshake failed: the tunnel is gone.
            log.warning("tls hijack handshake failed", host=host,
                        error=str(e))
            return
        PROXY_REQUESTS.labels("hijack").inc()
        await self._request_loop(reader, writer, scheme="https",
                                 tunnel_host=host)

    # -- SNI proxy ---------------------------------------------------------

    async def _handle_sni_conn(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               hijack: bool) -> None:
        self._conns.add(asyncio.current_task())
        try:
            if hijack:
                # Terminate TLS here; the SNI callback picks the leaf
                # during the handshake.
                holder: dict[str, str] = {}
                await writer.start_tls(self._sni_hijack_context(holder))
                host = holder.get("host", "")
                if not host:
                    return
                PROXY_REQUESTS.labels("hijack").inc()
                await self._request_loop(reader, writer, scheme="https",
                                         tunnel_host=host)
                return
            # Passthrough: peek the ClientHello's server name, then splice
            # the bytes to <sni>:443 untouched.
            hello = await self._read_tls_record(reader)
            host = parse_sni(hello) if hello else None
            if not host:
                return
            try:
                up_reader, up_writer = await asyncio.open_connection(host, 443)
            except OSError as e:
                log.warning("sni upstream connect failed", host=host,
                            error=str(e))
                return
            up_writer.write(hello)
            await up_writer.drain()
            PROXY_REQUESTS.labels("sni").inc()
            await asyncio.gather(self._relay(reader, up_writer),
                                 self._relay(up_reader, writer))
        except (ConnectionError, asyncio.IncompleteReadError,
                ssl_mod.SSLError):
            pass
        except Exception:
            log.error("sni connection error", exc_info=True)
        finally:
            self._conns.discard(asyncio.current_task())
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    def _sni_hijack_context(self, holder: dict[str, str]):
        """A server context whose leaf is chosen in the handshake from the
        ClientHello's SNI: fresh for each connection, since its callback
        writes this connection's ``holder``. A client with no SNI gets the
        localhost leaf (and fails its hostname check)."""
        base = self.ca.fresh_server_context("localhost")

        def on_sni(sock, server_name, _ctx):
            if server_name:
                holder["host"] = server_name
                sock.context = self.ca.server_context(server_name)
            return None

        base.sni_callback = on_sni
        return base

    @staticmethod
    async def _read_tls_record(reader: asyncio.StreamReader) -> bytes | None:
        """Exactly one TLS record (the ClientHello) off the wire."""
        try:
            header = await reader.readexactly(5)
        except asyncio.IncompleteReadError:
            return None
        if header[0] != 0x16:  # not a TLS handshake record
            return None
        length = int.from_bytes(header[3:5], "big")
        if length > 1 << 16:
            return None
        try:
            body = await reader.readexactly(length)
        except asyncio.IncompleteReadError:
            return None
        return header + body

    # -- plain HTTP --------------------------------------------------------

    def _resolve_url(self, target: str, headers: dict[str, str],
                     scheme: str = "http", tunnel_host: str = "") -> str:
        if target.startswith("http://") or target.startswith("https://"):
            return target                      # classic forward proxy
        if tunnel_host:
            # Inside a hijacked tunnel: against the tunnelled host (the
            # Host header should match the CONNECT target).
            host = _hget(headers, "Host", tunnel_host)
            return f"{scheme}://{host}{target}"
        if self.registry_mirror:
            # Mirror mode: this is the registry host; rebase the
            # origin-form path onto the remote.
            return urljoin(self.registry_mirror + "/", target.lstrip("/"))
        host = _hget(headers, "Host")
        return f"{scheme}://{host}{target}"

    async def _handle_http(self, method: str, target: str,
                           headers: dict[str, str],
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter, *,
                           scheme: str = "http",
                           tunnel_host: str = "") -> bool:
        url = self._resolve_url(target, headers, scheme, tunnel_host)
        fwd_headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_HEADERS and k.lower() != "host"}
        body = b""
        length = int(_hget(headers, "Content-Length", "0") or 0)
        if length:
            body = await reader.readexactly(length)

        if self.transport.should_use_p2p(method, url, fwd_headers):
            fetched = None
            try:
                # A failure before the stream starts (a bad range, the
                # task's setup) goes direct; once the head is written a
                # mid-stream error cuts the connection instead.
                fetched = await self.transport.fetch(url, fwd_headers)
                attrs, body_iter = fetched
                if attrs.get("range") is not None and attrs["content_length"] < 0:
                    # A range of an origin of unknown length: a correct
                    # 206 needs the total, so go direct.
                    await body_iter.aclose()
                    fetched = None
            except (DfError, ValueError) as e:
                log.warning("p2p fetch failed, falling back to direct",
                            url=url, error=str(e))
            if fetched is not None:
                return await self._serve_p2p(fetched, writer)
        return await self._serve_direct(method, url, fwd_headers, body, writer)

    async def _serve_p2p(self, fetched, writer: asyncio.StreamWriter) -> bool:
        attrs, body_iter = fetched
        rng = attrs.get("range")      # an open range arrives resolved
        total = attrs.get("content_length", -1)
        if rng is not None:
            status = 206
            resp_len = min(rng.length, max(total - rng.start, 0))
            if resp_len <= 0:
                # A range at or past the end: 416 with the unsatisfied
                # form (RFC 9110 §15.5.17).
                await body_iter.aclose()
                await Proxy._respond(
                    writer, 416, b"range not satisfiable",
                    extra=f"Content-Range: bytes */{total}\r\n")
                PROXY_REQUESTS.labels("p2p").inc()
                return True
            extra = (f"Content-Range: bytes {rng.start}-"
                     f"{rng.start + resp_len - 1}/{total}\r\n")
        else:
            status = 200
            resp_len = total
            extra = ""
        # The store holds the window: loop.sendfile straight off the data
        # file (fallback=True copies through a TLS tunnel).
        window = P2PTransport.sendfile_window(attrs, rng, total)
        if window is not None:
            store, offset, count = window
            # Pinned before any await, so the storage GC cannot take the
            # store in the aclose's suspension.
            store.pin()
            await body_iter.aclose()  # an unstarted generator holds no pin
            try:
                writer.write(
                    (f"HTTP/1.1 {status} OK\r\n{extra}"
                     f"Content-Length: {count}\r\n\r\n").encode())
                await writer.drain()
                await self._send_file(writer, store.data_path, offset, count)
            finally:
                store.unpin()
            PROXY_REQUESTS.labels("p2p").inc()
            PROXY_BYTES.labels("p2p").inc(count)
            return True
        sent = await self._write_body(writer, status, resp_len, extra, body_iter)
        PROXY_REQUESTS.labels("p2p").inc()
        PROXY_BYTES.labels("p2p").inc(sent)
        return True

    @staticmethod
    async def _send_file(writer: asyncio.StreamWriter, path: str,
                         offset: int, count: int) -> None:
        """``count`` bytes of ``path`` from ``offset``: by ``sendfile`` on
        a plaintext connection; through a TLS tunnel's TLS layer in reads
        of ``TLS_SEND_CHUNK`` (asyncio's own fallback reads 16 KiB at a
        time, each read a trip to a worker thread)."""
        loop = asyncio.get_running_loop()
        with open(path, "rb") as f:
            if writer.get_extra_info("ssl_object") is None:
                await loop.sendfile(writer.transport, f, offset, count,
                                    fallback=True)
                return
            sent = 0
            while sent < count:
                data = await loop.run_in_executor(
                    None, os.pread, f.fileno(),
                    min(TLS_SEND_CHUNK, count - sent), offset + sent)
                if not data:
                    raise ConnectionResetError("the data file ended early")
                writer.write(data)
                await writer.drain()
                sent += len(data)

    async def _serve_direct(self, method: str, url: str, headers: dict[str, str],
                            body: bytes, writer: asyncio.StreamWriter) -> bool:
        """The pass-through (non-GET and rule-excluded traffic)."""
        direct = self._direct
        try:
            ex = await direct._run(direct.exchange, method, url, headers,
                                   body)
        except (OSError, http.client.HTTPException, ValueError) as e:
            await self._respond(writer, 502, f"upstream error: {e}".encode())
            return False
        resp = ex.resp
        done = False
        try:
            hdrs = "".join(
                f"{k}: {v}\r\n" for k, v in resp.getheaders()
                if k.lower() not in _HOP_HEADERS
                and k.lower() != "content-length")
            cl = resp.getheader("Content-Length")
            length = int(cl) if cl is not None and cl.isdigit() else None
            if (method == "HEAD" or resp.status in (204, 304)
                    or 100 <= resp.status < 200):
                # The upstream length relayed (HEAD semantics), no body.
                head = f"HTTP/1.1 {resp.status} X\r\n{hdrs}"
                if length is not None:
                    head += f"Content-Length: {length}\r\n"
                writer.write(head.encode() + b"\r\n")
                await writer.drain()
                resp.read()   # no body: ends the answer, keeps the conn
                done = True
                PROXY_REQUESTS.labels("direct").inc()
                return True

            async def chunks():
                nonlocal done
                while chunk := await direct._run(direct._read, ex,
                                                 DIRECT_CHUNK):
                    yield chunk
                done = True

            sent = await self._write_body(
                writer, resp.status, length if length is not None else -1,
                hdrs, chunks())
            PROXY_REQUESTS.labels("direct").inc()
            PROXY_BYTES.labels("direct").inc(sent)
            return True
        except (OSError, http.client.HTTPException):
            # The head is out: a failed body cuts the connection.
            return False
        finally:
            if done:
                direct._checkin(ex)
            else:
                ex.conn.close()

    # -- response writing --------------------------------------------------

    @staticmethod
    async def _respond(writer: asyncio.StreamWriter, status: int, body: bytes,
                       extra: str = "") -> None:
        writer.write((f"HTTP/1.1 {status} X\r\n{extra}"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()

    @staticmethod
    async def _write_body(writer: asyncio.StreamWriter, status: int,
                          content_length: int, extra_headers: str,
                          body_iter) -> int:
        """A known length goes raw; an unknown one chunked."""
        chunked = content_length < 0
        head = f"HTTP/1.1 {status} OK\r\n{extra_headers}"
        if chunked:
            head += "Transfer-Encoding: chunked\r\n\r\n"
        else:
            head += f"Content-Length: {content_length}\r\n\r\n"
        writer.write(head.encode())
        sent = 0
        async for chunk in body_iter:
            if not chunk:
                continue
            if chunked:
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            else:
                writer.write(chunk)
            sent += len(chunk)
            await writer.drain()
        if chunked:
            writer.write(b"0\r\n\r\n")
        await writer.drain()
        return sent
