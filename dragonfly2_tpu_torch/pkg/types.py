"""``NetAddr``: the port's copy of the network address type in
``dragonfly2_tpu/pkg/types.py`` (the rest of that module is not needed
yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NetAddr:
    """A tcp, unix or vsock network address."""

    type: str  # "tcp" | "unix" | "vsock"
    addr: str  # "host:port", a socket path, or "cid:port"

    @classmethod
    def tcp(cls, host: str, port: int) -> "NetAddr":
        return cls("tcp", f"{host}:{port}")

    @classmethod
    def unix(cls, path: str) -> "NetAddr":
        return cls("unix", path)

    @classmethod
    def vsock(cls, cid: int, port: int) -> "NetAddr":
        return cls("vsock", f"{cid}:{port}")

    def host_port(self) -> tuple[str, int]:
        if self.type != "tcp":
            raise ValueError(f"{self} is not tcp")
        host, _, port = self.addr.rpartition(":")
        return host, int(port)

    def cid_port(self) -> tuple[int, int]:
        if self.type != "vsock":
            raise ValueError(f"{self} is not vsock")
        cid, _, port = self.addr.partition(":")
        return int(cid), int(port)

    def __str__(self) -> str:
        return f"{self.type}://{self.addr}"
