"""Common small types: the port's copy of the parts of
``dragonfly2_tpu/pkg/types.py`` it needs: ``NetAddr``, ``HostType``,
``Priority``, ``parse_size`` and ``AFFINITY_SEPARATOR``."""

from __future__ import annotations

import enum
from dataclasses import dataclass

# Separator of the elements of a host's location path ("zone|pod|slice").
AFFINITY_SEPARATOR = "|"


class HostType(enum.IntEnum):
    """Host roles. The seed tiers express upload-capacity classes; the
    scheduler's evaluator scores them above normal peers."""

    NORMAL = 0
    SUPER_SEED = 1
    STRONG_SEED = 2
    WEAK_SEED = 3

    @property
    def name_str(self) -> str:
        return _HOST_TYPE_NAMES[self]

    @classmethod
    def parse(cls, name: str) -> "HostType":
        return _HOST_TYPE_BY_NAME[name.lower()]

    def is_seed(self) -> bool:
        return self != HostType.NORMAL


_HOST_TYPE_NAMES = {
    HostType.NORMAL: "normal",
    HostType.SUPER_SEED: "super",
    HostType.STRONG_SEED: "strong",
    HostType.WEAK_SEED: "weak",
}
_HOST_TYPE_BY_NAME = {v: k for k, v in _HOST_TYPE_NAMES.items()}


class Priority(enum.IntEnum):
    """Task priority levels (reference commonv2.Priority)."""

    LEVEL0 = 0  # forbidden
    LEVEL1 = 1  # background
    LEVEL2 = 2
    LEVEL3 = 3  # normal (default)
    LEVEL4 = 4
    LEVEL5 = 5
    LEVEL6 = 6  # critical (e.g. pod-wide weight broadcast)


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


KB = 1024
MB = 1024 * KB
GB = 1024 * MB
TB = 1024 * GB


def parse_size(s: str | int | float) -> int:
    """Parse '4MiB' / '100M' / '1.5GB' / a plain number (binary units)."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.strip()
    units = [("TIB", TB), ("GIB", GB), ("MIB", MB), ("KIB", KB),
             ("TB", TB), ("GB", GB), ("MB", MB), ("KB", KB),
             ("T", TB), ("G", GB), ("M", MB), ("K", KB), ("B", 1)]
    upper = s.upper()
    for suffix, mult in units:
        if upper.endswith(suffix):
            return int(float(upper[: -len(suffix)]) * mult)
    return int(float(s))


def format_size(n: int) -> str:
    for suffix, mult in (("TiB", TB), ("GiB", GB), ("MiB", MB), ("KiB", KB)):
        if n >= mult:
            return f"{n / mult:.2f}{suffix}"
    return f"{n}B"
