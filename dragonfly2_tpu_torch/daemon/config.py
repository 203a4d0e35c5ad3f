"""The daemon's configuration tree: the port's copy of
``dragonfly2_tpu/daemon/config.py``, with the same keys and defaults, so
one file configures either daemon.

``DaemonConfig.from_dict`` builds the tree from a dict: a nested block
fills its option dataclass, an int field takes a size string such as
``100MiB`` (``pkg/types.parse_size``), and a key that names no field is
ignored. A field's default is made only when the dict leaves it out, so a
config that names ``host.ip`` never looks up the local address.
``DaemonConfig.load`` reads a ``.json`` file with the standard library
and any other file as YAML, importing ``yaml`` only then; without it the
load raises ``ImportError`` naming PyYAML.

The ``prof`` block keeps the JAX keys in a dataclass of the port's own;
the daemon accepts it and installs no runtime observatory (not ported).
``tpu_sink`` keeps its name: the wire value for a device landing is still
``"tpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg.dfpath import Dfpath
from dragonfly2_tpu_torch.pkg.types import HostType, parse_size


def _local_ip() -> str:
    # A UDP connect picks the outbound address; no packet is sent.
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


@dataclass
class HostOption:
    hostname: str = field(default_factory=socket.gethostname)
    ip: str = field(default_factory=_local_ip)
    idc: str = ""               # the pod or cluster identifier
    location: str = ""          # "zone|pod|slice|host" affinity path
    tpu_slice: str = ""         # slice name within the pod (the ICI domain)
    tpu_worker_index: int = -1  # worker index within the slice


@dataclass
class SchedulerOption:
    addrs: list[str] = field(default_factory=list)  # "host:port" drpc
    schedule_timeout: float = 30.0
    disable_auto_back_source: bool = False
    max_schedule_attempts: int = 5


@dataclass
class DownloadOption:
    rate_limit: int = 0             # bytes/s, 0 = unlimited
    traffic_shaper: str = "plain"   # plain | sampling
    piece_concurrency: int = 4      # origin range-group concurrency
    parent_concurrency: int = 4     # concurrent parent piece workers
    unix_sock: str = ""             # the download service's socket
    peer_port: int = 0              # the peer service's TCP port; -1: none
    calculate_digest: bool = True
    prefetch: bool = False          # a ranged miss starts the whole task
    concurrent_min_length: int = 32 << 20
    # The most piece reports one pieces_finished message carries.
    report_batch: int = 32


@dataclass
class UploadOption:
    port: int = 0                   # the piece upload server, 0 = ephemeral
    rate_limit: int = 0


@dataclass
class StorageOpt:
    task_ttl: float = 3 * 3600.0
    disk_gc_threshold: int = 0
    keep_storage: bool = True
    write_buffer_size: int = 4 << 20
    # Idle seconds before an un-expired store drops its data-file fd
    # (reopened lazily). 0 = follow gc_interval.
    fd_idle_close: float = 0.0


@dataclass
class ProxyOption:
    enabled: bool = False
    port: int = 0
    registry_mirror: str = ""
    rules: list[dict] = field(default_factory=list)  # {regex, use_dragonfly, direct}
    white_list_ports: list[int] = field(default_factory=lambda: [443, 80])
    max_concurrency: int = 0
    hijack_https: bool = False
    ca_cert: str = ""
    ca_key: str = ""
    hijack_hosts: list[str] = field(default_factory=list)
    sni_enabled: bool = False
    sni_port: int = 0
    sni_hijack: bool = False


@dataclass
class ObjectStorageOption:
    enabled: bool = False
    port: int = 0
    max_replicas: int = 3
    backend: str = "fs"             # fs | s3 | gcs | oss | obs
    # The backend's constructor arguments: fs {root}.
    backend_options: dict = field(default_factory=dict)


@dataclass
class PexOption:
    """Gossip peer exchange (``daemon/pex.py``)."""

    enabled: bool = False
    port: int = 0                   # UDP gossip port, 0 = ephemeral
    seeds: list[str] = field(default_factory=list)  # "host:port"
    # The shared secret every gossip datagram is sealed with ("": none).
    secret: str = ""


@dataclass
class QoSOption:
    """The tenant QoS plane's settings (not ported: enabling it is refused
    by the daemon)."""

    enabled: bool = False
    dispatch_capacity: int = 0
    upload_min_share_fraction: float = 0.1


@dataclass
class TPUSinkOption:
    """The device sink (``daemon/peer/device_sink.DeviceSinkManager``):
    requests opt in per task with ``device="tpu"``."""

    enabled: bool = False
    mesh_shape: list[int] = field(default_factory=list)
    batch_pieces: int = 8       # pieces staged per device dispatch
    max_tasks: int = 4          # concurrent device-resident tasks


@dataclass
class ProfConfig:
    """The JAX daemon's runtime-observatory keys (``prof:``). The port's
    daemon accepts them and installs no observatory."""

    enabled: bool = True
    hz: float = 19.0
    max_nodes: int = 8192
    max_depth: int = 48
    lag_interval_s: float = 0.25
    lag_slow_s: float = 0.25
    gc_slow_s: float = 0.05
    lag_ring: int = 4096


@dataclass
class DaemonConfig:
    host: HostOption = field(default_factory=HostOption)
    scheduler: SchedulerOption = field(default_factory=SchedulerOption)
    download: DownloadOption = field(default_factory=DownloadOption)
    upload: UploadOption = field(default_factory=UploadOption)
    storage: StorageOpt = field(default_factory=StorageOpt)
    proxy: ProxyOption = field(default_factory=ProxyOption)
    object_storage: ObjectStorageOption = field(
        default_factory=ObjectStorageOption)
    pex: PexOption = field(default_factory=PexOption)
    tpu_sink: TPUSinkOption = field(default_factory=TPUSinkOption)
    qos: QoSOption = field(default_factory=QoSOption)
    prof: ProfConfig = field(default_factory=ProfConfig)
    work_home: str = ""
    host_type: str = "normal"       # normal | super | strong | weak
    alive_time: float = 0.0         # 0 = forever
    gc_interval: float = 60.0
    metrics_port: int = 0           # -1: no /metrics server
    manager_addr: str = ""
    seed_peer: bool = False
    # Flight-recorder post-mortem bundles kept on disk.
    flight_keep_bundles: int = 32
    # Skews every wall stamp this daemon reports (flight start_wall,
    # announce clock samples) by this many seconds.
    clock_offset_s: float = 0.0

    def __post_init__(self):
        if not self.work_home:
            self.work_home = Dfpath().root

    @property
    def dfpath(self) -> Dfpath:
        return Dfpath(self.work_home)

    @property
    def unix_sock(self) -> str:
        """Resolved lazily, so a later change of work_home moves it."""
        return self.download.unix_sock or self.dfpath.daemon_sock

    @property
    def host_type_enum(self) -> HostType:
        if self.seed_peer and self.host_type == "normal":
            return HostType.SUPER_SEED
        return HostType.parse(self.host_type)

    @classmethod
    def from_dict(cls, d: dict) -> "DaemonConfig":
        return _merge_dataclass(cls, d)

    @classmethod
    def load(cls, path: str) -> "DaemonConfig":
        """A ``.json`` file, or YAML (which needs PyYAML)."""
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            data = json.loads(text)
        else:
            try:
                import yaml
            except ImportError as e:
                raise ImportError(
                    f"reading {path} as YAML needs PyYAML (the 'yaml' "
                    f"module); give the config as a .json file instead"
                ) from e
            data = yaml.safe_load(text)
        return cls.from_dict(data or {})


def _merge_dataclass(kind, d: dict):
    """An instance of the dataclass ``kind`` with ``d`` merged over its
    defaults: a dict for a nested dataclass field merges into it, a string
    for an int field is a size; keys that name no field are ignored."""
    kwargs = {}
    for f in dataclasses.fields(kind):
        if f.name not in d:
            continue
        value = d[f.name]
        nested = f.default_factory
        if dataclasses.is_dataclass(nested) and isinstance(value, dict):
            value = _merge_dataclass(nested, value)
        elif (isinstance(f.default, int) and not isinstance(f.default, bool)
              and isinstance(value, str)):
            value = parse_size(value)
        kwargs[f.name] = value
    return kind(**kwargs)
