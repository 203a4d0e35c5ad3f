"""drpc: asyncio RPC over MessagePack frames, with unary calls and bidi
streams. The port's copy of ``dragonfly2_tpu/rpc/``, on the standard
library only: its MessagePack codec is its own (``codec.py``), byte for
byte the ``msgpack`` package's, so port and JAX clients and servers talk
to each other. Piece payloads do not ride drpc: they are HTTP GETs
against a parent's upload server (``daemon/upload.py``).
"""

from dragonfly2_tpu_torch.rpc.client import Client, ClientStream, RpcError
from dragonfly2_tpu_torch.rpc.framing import Frame, FrameReader, FrameWriter
from dragonfly2_tpu_torch.rpc.server import RpcContext, Server, ServerStream

__all__ = [
    "Frame",
    "FrameReader",
    "FrameWriter",
    "Server",
    "ServerStream",
    "RpcContext",
    "Client",
    "ClientStream",
    "RpcError",
]
