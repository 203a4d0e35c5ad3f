"""drpc client: the port's copy of ``dragonfly2_tpu/rpc/client.py``.

One multiplexed connection per target carrying unary calls and bidi
streams: a lazy connect, a reconnect on the next use after a capped,
jittered backoff (a flapping scheduler is not redialled by every caller),
and coded errors translated from the wire.

``ssl_context`` (``pkg/security.client_ssl_context``) puts TLS under a
TCP connection, mTLS when it presents a client certificate; a unix socket
stays plaintext, and TLS over vsock is refused at connect. A call and a
stream open carry the caller's trace context in the frame's metadata
(``md``, ``pkg/tracing.inject``), as the JAX client sends it. Not
ported: the chaos hooks.
"""

from __future__ import annotations

import asyncio
import itertools
import socket
from typing import Any

from dragonfly2_tpu_torch.pkg import dflog, retry, tracing
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc.framing import (
    CALL,
    CLOSE,
    ERR,
    MSG,
    PING,
    PONG,
    RESULT,
    SOPEN,
    Frame,
    FrameReader,
    FrameWriter,
    stream_recv,
)

log = dflog.get("rpc.client")


class RpcError(DfError):
    pass


class ClientStream:
    """The client side of a bidi stream."""

    def __init__(self, call_id: int, writer: FrameWriter):
        self.call_id = call_id
        self._w = writer
        self._inbox: asyncio.Queue[Any] = asyncio.Queue()
        self._closed = asyncio.Event()
        self._error: DfError | None = None

    async def send(self, body: Any) -> None:
        if self._closed.is_set():
            raise self._error or RpcError(Code.ClientConnectionError,
                                          "stream closed")
        try:
            await self._w.write(Frame(MSG, self.call_id, body=body))
        except (OSError, ConnectionError) as e:
            raise RpcError(Code.ClientConnectionError, f"stream write: {e}")

    async def recv(self, timeout: float | None = None) -> Any | None:
        """The next server message; None when the server closed cleanly;
        raises the server's coded error if it ended with one."""
        try:
            msg, ok = await stream_recv(self._inbox, self._closed, timeout)
        except asyncio.TimeoutError:
            raise RpcError(Code.RequestTimeout, "stream recv timeout")
        if ok:
            return msg
        if self._error:
            raise self._error
        return None

    async def close(self) -> None:
        """Half-close: no more sends from this side."""
        if not self._closed.is_set():
            try:
                await self._w.write(Frame(CLOSE, self.call_id))
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def _on_msg(self, body: Any) -> None:
        self._inbox.put_nowait(body)

    def _on_close(self, error: DfError | None) -> None:
        self._error = error
        self._closed.set()


class Client:
    # Consecutive connect failures push the next dial out by a capped,
    # jittered exponential delay instead of redialling on every use.
    BACKOFF = retry.RECONNECT

    def __init__(self, addr: NetAddr, connect_timeout: float = 5.0,
                 *, ssl_context=None):
        self.addr = addr
        self._connect_timeout = connect_timeout
        self._ssl = ssl_context
        self._ids = itertools.count(1)
        self._fw: FrameWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, ClientStream] = {}
        self._conn_lock = asyncio.Lock()
        self._connect_failures = 0
        self._next_connect_at = 0.0

    def _note_connect_failure(self) -> None:
        delay = self.BACKOFF.delay(self._connect_failures)
        self._connect_failures += 1
        self._next_connect_at = asyncio.get_running_loop().time() + delay

    async def _open(self):
        if self.addr.type == "tcp":
            host, port = self.addr.host_port()
            return await asyncio.wait_for(
                asyncio.open_connection(host, port, ssl=self._ssl),
                self._connect_timeout)
        if self.addr.type == "vsock":
            if not hasattr(socket, "AF_VSOCK"):
                raise OSError("AF_VSOCK unsupported on this platform")
            if self._ssl is not None:
                # A configured TLS transport is never downgraded.
                raise OSError("TLS over vsock is not supported")
            cid, port = self.addr.cid_port()
            sock = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                await asyncio.wait_for(
                    asyncio.get_running_loop().sock_connect(sock, (cid, port)),
                    self._connect_timeout)
                return await asyncio.open_connection(sock=sock)
            except BaseException:
                sock.close()   # a reconnect loop must not leak fds
                raise
        return await asyncio.wait_for(
            asyncio.open_unix_connection(self.addr.addr),
            self._connect_timeout)

    async def _ensure_conn(self) -> FrameWriter:
        async with self._conn_lock:
            if (self._fw is not None and self._reader_task is not None
                    and not self._reader_task.done()):
                return self._fw
            # Backoff after failed dials, under the lock: every caller of a
            # flapping endpoint waits behind one delayed dial.
            wait = self._next_connect_at - asyncio.get_running_loop().time()
            if wait > 0:
                await asyncio.sleep(wait)
            try:
                reader, writer = await self._open()
            except (OSError, asyncio.TimeoutError) as e:
                self._note_connect_failure()
                raise RpcError(Code.ClientConnectionError,
                               f"connect {self.addr}: {e}")
            self._connect_failures = 0
            self._next_connect_at = 0.0
            self._fw = FrameWriter(writer)
            self._reader_task = asyncio.ensure_future(
                self._read_loop(FrameReader(reader)))
            return self._fw

    async def _read_loop(self, fr: FrameReader) -> None:
        try:
            while True:
                frame = await fr.read()
                if frame is None:
                    break
                if frame.type in (RESULT, PONG):
                    fut = self._pending.pop(frame.call_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame.body)
                elif frame.type == ERR:
                    err = DfError.from_wire(frame.error or {})
                    fut = self._pending.pop(frame.call_id, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(err)
                    else:
                        s = self._streams.pop(frame.call_id, None)
                        if s is not None:
                            s._on_close(err)
                elif frame.type == MSG:
                    s = self._streams.get(frame.call_id)
                    if s is not None:
                        s._on_msg(frame.body)
                elif frame.type == CLOSE:
                    s = self._streams.pop(frame.call_id, None)
                    if s is not None:
                        s._on_close(None)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("client read loop error", addr=str(self.addr),
                        error=str(e))
        finally:
            self._fail_all(RpcError(Code.ClientConnectionError,
                                    f"connection to {self.addr} lost"))

    def _fail_all(self, err: DfError) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        for s in self._streams.values():
            s._on_close(err)
        self._streams.clear()
        self._fw = None

    async def _write(self, frame: Frame, fw: FrameWriter) -> None:
        """Write, with transport errors as coded RpcErrors."""
        try:
            await fw.write(frame)
        except (OSError, ConnectionError) as e:
            self._pending.pop(frame.call_id, None)
            self._streams.pop(frame.call_id, None)
            raise RpcError(Code.ClientConnectionError,
                           f"write to {self.addr}: {e}")

    async def call(self, method: str, body: Any = None,
                   timeout: float = 30.0) -> Any:
        fw = await self._ensure_conn()
        call_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[call_id] = fut
        await self._write(Frame(CALL, call_id, method=method, body=body,
                                md=tracing.inject() or None), fw)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(call_id, None)
            raise RpcError(Code.RequestTimeout,
                           f"{method} timed out after {timeout}s")
        finally:
            fut.cancel()  # no orphaned 'exception never retrieved'

    async def open_stream(self, method: str, body: Any = None) -> ClientStream:
        fw = await self._ensure_conn()
        call_id = next(self._ids)
        stream = ClientStream(call_id, fw)
        self._streams[call_id] = stream
        await self._write(Frame(SOPEN, call_id, method=method, body=body,
                                md=tracing.inject() or None), fw)
        return stream

    async def ping(self, timeout: float = 3.0) -> bool:
        call_id = None
        try:
            fw = await self._ensure_conn()
            call_id = next(self._ids)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[call_id] = fut
            await fw.write(Frame(PING, call_id))
            await asyncio.wait_for(fut, timeout)
            return True
        except Exception:
            return False
        finally:
            if call_id is not None:
                self._pending.pop(call_id, None)

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        if self._fw is not None:
            await self._fw.close()
        self._fail_all(RpcError(Code.ClientConnectionError, "client closed"))
