"""The manager's configuration: the port's copy of
``dragonfly2_tpu/manager/config.py``, with every field, default and the
``from_dict`` rules (a nested block builds its dataclass from its keys;
an unknown key there raises ``TypeError``).

``prof`` is ``pkg/prof.ProfConfig``: the runtime observatory, on by
default (``manager/server.py``). ``cluster`` (the control tower's bounds)
is accepted and installs nothing: the port builds no cluster tower.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg.prof import ProfConfig


@dataclass
class RestConfig:
    host: str = "127.0.0.1"
    port: int = 0              # 0: an ephemeral port


@dataclass
class GrpcConfig:
    host: str = "127.0.0.1"
    port: int = 0


@dataclass
class DatabaseConfig:
    # ":memory:" or a path of a sqlite file.
    path: str = ":memory:"


@dataclass
class ClusterConfig:
    """The JAX cluster tower's bounds, kept so one config file serves
    both packages."""

    spool_max_bytes: int = 2 * 1024 * 1024
    event_cap: int = 1024
    frames_per_scheduler: int = 240


@dataclass
class ManagerConfig:
    server: RestConfig = field(default_factory=RestConfig)
    grpc: GrpcConfig = field(default_factory=GrpcConfig)
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    prof: ProfConfig = field(default_factory=ProfConfig)
    keepalive_gc_interval: float = 30.0
    # The liveness window before expire_stale flips a silent instance
    # inactive.
    keepalive_timeout: float = 60.0
    # /metrics and /healthy; 0: an ephemeral port, negative: none.
    metrics_port: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ManagerConfig":
        cfg = cls()
        if "server" in d:
            cfg.server = RestConfig(**d["server"])
        if "grpc" in d:
            cfg.grpc = GrpcConfig(**d["grpc"])
        if "database" in d:
            cfg.database = DatabaseConfig(**d["database"])
        if "cluster" in d:
            cfg.cluster = ClusterConfig(**d["cluster"])
        if "prof" in d:
            cfg.prof = ProfConfig(**d["prof"])
        for key in ("keepalive_gc_interval", "keepalive_timeout",
                    "metrics_port"):
            setattr(cfg, key, d.get(key, getattr(cfg, key)))
        return cfg
