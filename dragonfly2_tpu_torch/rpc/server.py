"""drpc server: the port's copy of ``dragonfly2_tpu/rpc/server.py``.

Unary and bidi-stream handlers keyed by "Service.Method", served on TCP,
a unix socket or vsock. Request bodies of the methods in
``proto/wire.py`` are checked at this boundary. Not ported: TLS (it comes
with the daemon's config), the trace spans around handlers, and the
stream-message schemas (the port serves no method that has one).
"""

from __future__ import annotations

import asyncio
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto import wire
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

log = dflog.get("rpc.server")

UnaryHandler = Callable[[Any, "RpcContext"], Awaitable[Any]]
StreamHandler = Callable[["ServerStream", "RpcContext"], Awaitable[None]]


@dataclass
class RpcContext:
    """Per-call context: the remote address and a per-connection bag."""

    peer_addr: str
    conn_state: dict[str, Any] = field(default_factory=dict)


class ServerStream:
    """The server side of a bidi stream."""

    def __init__(self, call_id: int, writer: FrameWriter, open_body: Any):
        self.call_id = call_id
        self.open_body = open_body
        self.md: dict | None = None      # the open frame's metadata
        self.method = ""
        self._w = writer
        self._inbox: asyncio.Queue[Any] = asyncio.Queue()
        self._closed_by_peer = asyncio.Event()
        self._error: DfError | None = None

    async def send(self, body: Any) -> None:
        await self._w.write(Frame(MSG, self.call_id, body=body))

    async def recv(self, timeout: float | None = None) -> Any | None:
        """The next client message; None when the client half-closed."""
        msg, ok = await stream_recv(self._inbox, self._closed_by_peer,
                                    timeout)
        if ok:
            return msg
        if self._error:
            raise self._error
        return None

    async def close(self, error: DfError | None = None) -> None:
        if error is not None:
            await self._w.write(Frame(ERR, self.call_id,
                                      error=error.to_wire()))
        else:
            await self._w.write(Frame(CLOSE, self.call_id))

    def _on_msg(self, body: Any) -> None:
        self._inbox.put_nowait(body)

    def _on_close(self, error: DfError | None) -> None:
        # The first close wins: a later plain CLOSE must not clear a
        # recorded failure.
        if self._error is None:
            self._error = error
        self._closed_by_peer.set()


def _err_frame(call_id: int, code: Code, message: str) -> Frame:
    return Frame(ERR, call_id, error=DfError(code, message).to_wire())


class Server:
    def __init__(self, name: str = "drpc"):
        self._name = name
        self._unary: dict[str, UnaryHandler] = {}
        self._stream: dict[str, StreamHandler] = {}
        self._servers: list[asyncio.base_events.Server] = []
        self._conn_tasks: set[asyncio.Task] = set()

    def register_unary(self, method: str, handler: UnaryHandler) -> None:
        self._unary[method] = handler

    def register_stream(self, method: str, handler: StreamHandler) -> None:
        self._stream[method] = handler

    async def serve(self, addr: NetAddr) -> None:
        if addr.type == "tcp":
            host, port = addr.host_port()
            srv = await asyncio.start_server(self._on_conn, host, port)
        elif addr.type == "unix":
            sock_dir = os.path.dirname(addr.addr)
            if sock_dir:
                os.makedirs(sock_dir, exist_ok=True)
            if os.path.exists(addr.addr):
                os.unlink(addr.addr)
            srv = await asyncio.start_unix_server(self._on_conn, addr.addr)
        elif addr.type == "vsock":
            if not hasattr(socket, "AF_VSOCK"):
                raise ValueError("AF_VSOCK unsupported on this platform")
            cid, port = addr.cid_port()
            sock = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
            sock.bind((cid, port))
            sock.setblocking(False)
            srv = await asyncio.start_server(self._on_conn, sock=sock)
        else:
            raise ValueError(f"unsupported addr type {addr.type}")
        self._servers.append(srv)
        log.info("serving", name=self._name, addr=str(addr))

    def port(self, index: int = 0) -> int:
        """The bound TCP port (for a ':0' address)."""
        return self._servers[index].sockets[0].getsockname()[1]

    async def close(self) -> None:
        for srv in self._servers:
            srv.close()
        # Cancel live connection handlers first: since Python 3.12
        # wait_closed() waits until every handler returns.
        for t in list(self._conn_tasks):
            t.cancel()
        for srv in self._servers:
            await srv.wait_closed()
        self._servers.clear()

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        peername = writer.get_extra_info("peername")
        peer_addr = str(peername) if peername else "unix"
        fr = FrameReader(reader)
        fw = FrameWriter(writer)
        conn_state: dict[str, Any] = {}
        streams: dict[int, ServerStream] = {}
        handler_tasks: set[asyncio.Task] = set()

        def spawn(coro) -> None:
            t = asyncio.ensure_future(coro)
            handler_tasks.add(t)
            t.add_done_callback(handler_tasks.discard)

        try:
            while True:
                frame = await fr.read()
                if frame is None:
                    break
                if frame.type == PING:
                    await fw.write(Frame(PONG, frame.call_id))
                elif frame.type == CALL:
                    spawn(self._run_unary(frame, fw,
                                          RpcContext(peer_addr, conn_state)))
                elif frame.type == SOPEN:
                    handler = self._stream.get(frame.method)
                    if handler is None:
                        await fw.write(_err_frame(
                            frame.call_id, Code.BadRequest,
                            f"unknown stream {frame.method}"))
                        continue
                    try:
                        wire.validate_stream_open(frame.method, frame.body)
                    except wire.SchemaError as e:
                        await fw.write(_err_frame(frame.call_id,
                                                  Code.BadRequest, str(e)))
                        continue
                    stream = ServerStream(frame.call_id, fw, frame.body)
                    stream.md = frame.md
                    stream.method = frame.method
                    streams[frame.call_id] = stream
                    spawn(self._run_stream(handler, stream,
                                           RpcContext(peer_addr, conn_state),
                                           streams))
                elif frame.type == MSG:
                    s = streams.get(frame.call_id)
                    if s is not None:
                        s._on_msg(frame.body)
                elif frame.type in (CLOSE, ERR):
                    s = streams.get(frame.call_id)
                    if s is not None:
                        s._on_close(DfError.from_wire(frame.error)
                                    if frame.error else None)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("connection error", name=self._name, peer=peer_addr,
                        error=str(e))
        finally:
            for s in streams.values():
                s._on_close(DfError(Code.ClientConnectionError,
                                    "connection closed"))
            for t in handler_tasks:
                t.cancel()
            await fw.close()

    async def _run_unary(self, frame: Frame, fw: FrameWriter,
                         ctx: RpcContext) -> None:
        handler = self._unary.get(frame.method)
        if handler is None:
            await fw.write(_err_frame(frame.call_id, Code.BadRequest,
                                      f"unknown method {frame.method}"))
            return
        try:
            wire.validate_unary(frame.method, frame.body)
            result = await handler(frame.body, ctx)
            await fw.write(Frame(RESULT, frame.call_id, body=result))
        except wire.SchemaError as e:
            await fw.write(_err_frame(frame.call_id, Code.BadRequest, str(e)))
        except DfError as e:
            await fw.write(Frame(ERR, frame.call_id, error=e.to_wire()))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.error(f"unary handler {frame.method} crashed", exc_info=True)
            await fw.write(_err_frame(frame.call_id, Code.UnknownError,
                                      str(e)))

    async def _run_stream(self, handler: StreamHandler, stream: ServerStream,
                          ctx: RpcContext,
                          streams: dict[int, ServerStream]) -> None:
        try:
            await handler(stream, ctx)
            await stream.close()
        except DfError as e:
            try:
                await stream.close(e)
            except Exception:
                pass
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.error("stream handler crashed", exc_info=True)
            try:
                await stream.close(DfError(Code.UnknownError, str(e)))
            except Exception:
                pass
        finally:
            streams.pop(stream.call_id, None)
