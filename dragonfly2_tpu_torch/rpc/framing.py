"""Wire framing for drpc: the port's copy of
``dragonfly2_tpu/rpc/framing.py``, over the port's own MessagePack codec
(``rpc/codec.py``) instead of the ``msgpack`` package.

Frame = 4-byte big-endian length || a MessagePack map:
  {"t": type, "id": call_id, "m": method?, "b": body?, "e": error?,
   "md": metadata?}

Types:
  CALL         client → server, unary request
  RESULT       server → client, unary success
  SOPEN        client → server, open a bidi stream (body = open metadata)
  MSG          either direction, one stream message
  CLOSE        either direction, half-close (no more MSG from the sender)
  ERR          either direction, end a call or stream with a coded error
  PING / PONG  liveness

Errors carry the ``DfError`` wire form, so codes survive the boundary.
The bytes are the JAX package's: a port client talks to a JAX server and
a JAX client to a port server.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import Any

from dragonfly2_tpu_torch.rpc import codec

MAX_FRAME = 64 * 1024 * 1024  # hard cap; piece payloads don't ride drpc

CALL = 1
RESULT = 2
SOPEN = 3
MSG = 4
CLOSE = 5
ERR = 6
PING = 7
PONG = 8


@dataclass
class Frame:
    type: int
    call_id: int
    method: str = ""
    body: Any = None
    error: dict | None = None
    # Call metadata (trace context, auth).
    md: dict | None = None

    def pack_parts(self) -> tuple[bytes, bytes]:
        """(header, payload): writers push both without joining them."""
        m: dict[str, Any] = {"t": self.type, "id": self.call_id}
        if self.method:
            m["m"] = self.method
        if self.body is not None:
            m["b"] = self.body
        if self.error is not None:
            m["e"] = self.error
        if self.md:
            m["md"] = self.md
        payload = codec.packb(m)
        return struct.pack(">I", len(payload)), payload

    def pack(self) -> bytes:
        header, payload = self.pack_parts()
        return header + payload

    @classmethod
    def unpack(cls, payload: bytes) -> "Frame":
        m = codec.unpackb(payload)
        return cls(
            type=m["t"],
            call_id=m["id"],
            method=m.get("m", ""),
            body=m.get("b"),
            error=m.get("e"),
            md=m.get("md"),
        )


async def stream_recv(inbox: asyncio.Queue, closed: asyncio.Event,
                      timeout: float | None = None):
    """The receive of both stream halves: the next inbox message or the
    close, whichever comes first. ``(msg, True)`` for a message, ``(None,
    False)`` on close; raises TimeoutError on timeout. Cancel-safe, and a
    message that raced into the inbox during a close is still delivered.
    """
    if closed.is_set() and inbox.empty():
        return None, False
    getter = asyncio.ensure_future(inbox.get())
    closer = asyncio.ensure_future(closed.wait())
    try:
        done, _ = await asyncio.wait({getter, closer},
                                     return_when=asyncio.FIRST_COMPLETED,
                                     timeout=timeout)
    except asyncio.CancelledError:
        getter.cancel()
        closer.cancel()
        raise
    if getter in done:
        closer.cancel()
        return getter.result(), True
    getter.cancel()
    closer.cancel()
    if not done:
        raise asyncio.TimeoutError("stream recv timeout")
    if not inbox.empty():
        return inbox.get_nowait(), True
    return None, False


class FrameReader:
    def __init__(self, reader: asyncio.StreamReader):
        self._r = reader

    async def read(self) -> Frame | None:
        """One frame; None on a clean EOF."""
        try:
            header = await self._r.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME:
            raise ValueError(f"frame too large: {length}")
        try:
            payload = await self._r.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        return Frame.unpack(payload)


class FrameWriter:
    def __init__(self, writer: asyncio.StreamWriter):
        self._w = writer
        self._lock = asyncio.Lock()

    async def write(self, frame: Frame) -> None:
        header, payload = frame.pack_parts()
        async with self._lock:
            # Two writes, no join: the stream writer buffers both before
            # the drain, so the wire sees one contiguous frame.
            self._w.write(header)
            self._w.write(payload)
            await self._w.drain()

    async def close(self) -> None:
        async with self._lock:
            try:
                self._w.close()
                await self._w.wait_closed()
            except Exception:
                pass
