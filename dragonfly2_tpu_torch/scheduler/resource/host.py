"""Host: one daemon instance and its telemetry. The port's copy of
``dragonfly2_tpu/scheduler/resource/host.py``.

Identity, network location (IDC and a ``|``-separated location path),
upload concurrency accounting, announced telemetry and the TTL for GC,
plus the slice and worker coordinates the topology-aware evaluator reads
(ICI against DCN distance).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg.quarantine import DecayingPenalty, penalize_entry
from dragonfly2_tpu_torch.pkg.types import HostType
from dragonfly2_tpu_torch.scheduler.config import (
    PEER_CONCURRENT_UPLOAD_LIMIT,
    SEED_PEER_CONCURRENT_UPLOAD_LIMIT,
)


@dataclass
class HostTelemetry:
    """Announced host stats (reference host.go CPU/Memory/Network/Disk/Build;
    filled by the daemon announcer from psutil)."""

    cpu_percent: float = 0.0
    mem_percent: float = 0.0
    disk_free: int = 0
    net_rx_rate: int = 0
    net_tx_rate: int = 0
    os: str = ""
    platform: str = ""
    version: str = ""


class Host:
    def __init__(
        self,
        host_id: str,
        *,
        hostname: str = "",
        ip: str = "",
        port: int = 0,            # drpc peer port
        upload_port: int = 0,     # HTTP piece upload port
        host_type: HostType = HostType.NORMAL,
        idc: str = "",
        location: str = "",
        tpu_slice: str = "",
        tpu_worker_index: int = -1,
        concurrent_upload_limit: int = 0,
    ):
        self.id = host_id
        self.hostname = hostname or host_id
        self.ip = ip
        self.port = port
        self.upload_port = upload_port
        self.type = host_type
        self.idc = idc
        self.location = location
        self.tpu_slice = tpu_slice
        self.tpu_worker_index = tpu_worker_index
        if concurrent_upload_limit <= 0:
            concurrent_upload_limit = (
                SEED_PEER_CONCURRENT_UPLOAD_LIMIT if host_type.is_seed()
                else PEER_CONCURRENT_UPLOAD_LIMIT
            )
        self.concurrent_upload_limit = concurrent_upload_limit
        self.concurrent_upload_count = 0
        self.upload_count = 0
        self.upload_failed_count = 0
        self.telemetry = HostTelemetry()
        self.created_at = time.time()
        self.updated_at = time.time()
        # peer ids on this host (peer GC on LeaveHost)
        self.peer_ids: set[str] = set()
        # Bad-serve quarantine (pkg/quarantine discipline, same constants
        # as the daemon side): children's typed piece_failed reports add
        # reason-weighted, half-life-decaying penalty; while quarantined
        # the host is filtered from EVERY peer's candidate set — one
        # child's crc mismatch protects the whole pod.
        self._penalty = DecayingPenalty()

    # -- bad-serve quarantine ----------------------------------------------

    def note_served_bad(self, reason: str) -> bool:
        """Record a typed serving failure. Returns True when the host just
        ENTERED quarantine (callers report that edge)."""
        return penalize_entry(self._penalty, reason, time.monotonic())

    def quarantined(self) -> bool:
        return time.monotonic() < self._penalty.quarantined_until

    # -- upload accounting (evaluator free-upload term) --------------------

    def free_upload_count(self) -> int:
        return max(0, self.concurrent_upload_limit - self.concurrent_upload_count)

    def upload_success_rate(self) -> float:
        if self.upload_count == 0:
            return 1.0 if self.type.is_seed() else 0.6  # optimistic prior
        return 1.0 - (self.upload_failed_count / self.upload_count)

    def touch(self) -> None:
        self.updated_at = time.time()

    def is_seed(self) -> bool:
        return self.type.is_seed()

    def to_wire(self) -> dict:
        return {
            "id": self.id,
            "hostname": self.hostname,
            "ip": self.ip,
            "port": self.port,
            "upload_port": self.upload_port,
            "type": int(self.type),
            "idc": self.idc,
            "location": self.location,
            "tpu_slice": self.tpu_slice,
            "tpu_worker_index": self.tpu_worker_index,
        }


class HostManager:
    """In-memory host registry with TTL GC (reference host_manager.go)."""

    def __init__(self, ttl: float = 3600.0):
        self._hosts: dict[str, Host] = {}
        self._ttl = ttl

    def load(self, host_id: str) -> Host | None:
        return self._hosts.get(host_id)

    def store(self, host: Host) -> Host:
        self._hosts[host.id] = host
        return host

    def load_or_store(self, host: Host) -> Host:
        existing = self._hosts.get(host.id)
        if existing is not None:
            existing.touch()
            return existing
        return self.store(host)

    def delete(self, host_id: str) -> None:
        self._hosts.pop(host_id, None)

    def all(self) -> list[Host]:
        return list(self._hosts.values())

    def counts(self) -> dict:
        """Fleet-gauge summary (pkg/fleet sampler): hosts by state. One
        O(hosts) scan, called at bucket-rotation cadence, not per event."""
        total = seed = quarantined = 0
        for h in self._hosts.values():
            total += 1
            if h.is_seed():
                seed += 1
            if h.quarantined():
                quarantined += 1
        return {"total": total, "seed": seed, "quarantined": quarantined}

    def gc(self) -> list[str]:
        now = time.time()
        dead = [h.id for h in self._hosts.values()
                if not h.peer_ids and (now - h.updated_at) > self._ttl]
        for hid in dead:
            del self._hosts[hid]
        return dead
