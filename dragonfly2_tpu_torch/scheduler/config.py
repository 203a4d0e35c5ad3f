"""The scheduler's configuration and tuning constants: the port's copy of
``dragonfly2_tpu/scheduler/config.py``, with every field and default.

``SchedulerConfig.from_dict`` merges a dict over the defaults with the
port's own merge (``daemon/config._merge_dataclass``: a nested block
fills its dataclass, keys that name no field are ignored).
``SchedulerConfig.load`` reads a ``.json`` file with the standard library
and any other file as YAML, importing ``yaml`` only then. ``prof`` is
``pkg/prof.ProfConfig``, the runtime observatory's knobs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.daemon.config import _merge_dataclass
from dragonfly2_tpu_torch.pkg.prof import ProfConfig

SEED_PEER_CONCURRENT_UPLOAD_LIMIT = 2000
PEER_CONCURRENT_UPLOAD_LIMIT = 200
CANDIDATE_PARENT_LIMIT = 4
FILTER_PARENT_LIMIT = 15
TASK_BACK_TO_SOURCE_PEER_COUNT = 200
RETRY_LIMIT = 5
RETRY_BACK_TO_SOURCE_LIMIT = 4
RETRY_INTERVAL = 0.5
PIECE_DOWNLOAD_TIMEOUT = 30 * 60.0
PEER_TTL = 24 * 3600.0
HOST_TTL = 3600.0
TASK_TTL = 24 * 3600.0


@dataclass
class SchedulerServerConfig:
    host: str = "127.0.0.1"
    port: int = 8002
    advertise_ip: str = ""


@dataclass
class SchedulingConfig:
    # "default" is the built-in weighted evaluator; the port refuses any
    # other name (the JAX scheduler resolves it through a plugin
    # registry).
    algorithm: str = "default"
    candidate_parent_limit: int = CANDIDATE_PARENT_LIMIT
    filter_parent_limit: int = FILTER_PARENT_LIMIT
    retry_limit: int = RETRY_LIMIT
    retry_back_to_source_limit: int = RETRY_BACK_TO_SOURCE_LIMIT
    retry_interval: float = RETRY_INTERVAL
    back_to_source_count: int = TASK_BACK_TO_SOURCE_PEER_COUNT
    # How long a peer that refuses back-to-source waits in the schedule
    # loop for a parent to appear.
    no_source_patience: float = 30.0
    # Striped slice broadcast (scheduling/stripe.py): pod_broadcast peers
    # stripe once >= 2 same-slice broadcast peers share the task; a value
    # >= 2 here also stripes any task with that many same-slice peers.
    stripe_min_slice_peers: int = 0
    # The evaluator's weights; the topology term replaces the IDC and
    # location terms when both hosts carry TPU coordinates.
    weight_finished_pieces: float = 0.2
    weight_upload_success: float = 0.2
    weight_free_upload: float = 0.15
    weight_host_type: float = 0.15
    weight_idc_affinity: float = 0.15
    weight_location_affinity: float = 0.15


@dataclass
class FleetConfig:
    """The fleet observatory's bounds (``pkg/fleet.py``): the bounded
    scheduler-side time-series, host scorecards and decision log;
    ``straggler_filter`` wires the scorecards' advisory filter into the
    scheduling core. ``frame_max_bytes`` caps the JAX cluster fleet frame,
    which the port does not build (no cluster tower)."""

    enabled: bool = True
    bucket_s: float = 5.0
    buckets: int = 720
    decision_cap: int = 1024
    scorecard_hosts: int = 1024
    straggler_z: float = 3.0
    min_serve_samples: int = 8
    min_population: int = 8
    straggler_filter: bool = True
    frame_max_bytes: int = 8192


@dataclass
class PodLensConfig:
    """Pod lens (``pkg/podlens``) and SLO engine (``pkg/slo``) bounds:
    the merged cross-host timeline and the burn-rate engine. On by
    default; ``enabled=False`` removes the digest-ingest hooks."""

    enabled: bool = True
    slo_enabled: bool = True
    max_tasks: int = 256
    clock_hosts: int = 4096
    pull_missing: int = 16
    max_completions: int = 4096


@dataclass
class HAConfig:
    """Crash recovery: a bounded, periodically flushed snapshot of live
    task, peer and host state in sqlite (``resource/snapshot.py``), so a
    restarted scheduler serves correct stripe plans and parent sets
    before every host has re-announced."""

    enabled: bool = True
    # "" reuses ``persistent_cache_db``; ":memory:" keeps the machinery
    # with no durability.
    snapshot_db: str = ""
    snapshot_interval: float = 5.0
    max_tasks: int = 1024
    max_peers: int = 65536


@dataclass
class GCConfig:
    peer_ttl: float = PEER_TTL
    host_ttl: float = HOST_TTL
    task_ttl: float = TASK_TTL
    interval: float = 60.0


@dataclass
class SchedulerConfig:
    server: SchedulerServerConfig = field(default_factory=SchedulerServerConfig)
    scheduling: SchedulingConfig = field(default_factory=SchedulingConfig)
    gc: GCConfig = field(default_factory=GCConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    podlens: PodLensConfig = field(default_factory=PodLensConfig)
    ha: HAConfig = field(default_factory=HAConfig)
    prof: ProfConfig = field(default_factory=ProfConfig)
    manager_addr: str = ""
    hostname: str = ""
    manager_keepalive_interval: float = 5.0
    cluster_id: int = 1
    # Durable persistent-cache state in sqlite; ":memory:" for tests.
    persistent_cache_db: str = ":memory:"
    metrics_port: int = 0
    seed_peer_enabled: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerConfig":
        return _merge_dataclass(cls, d)

    @classmethod
    def load(cls, path: str) -> "SchedulerConfig":
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
