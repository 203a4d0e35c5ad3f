"""The scheduler's announcer, its registration with the manager: the
port's copy of ``dragonfly2_tpu/scheduler/announcer.py``.

``start`` calls ``Manager.UpdateScheduler`` and starts the keepalive
stream, which carries ``qos_payload()`` (the scheduler's
``manager_payload``: its tenant burn snapshot) on every message.
"""

from __future__ import annotations

import socket

from dragonfly2_tpu_torch.manager.client import ManagerClient
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.types import NetAddr

log = dflog.get("scheduler.announcer")


class SchedulerAnnouncer:
    def __init__(self, manager_addr: str, *, cluster_id: int, port: int,
                 ip: str = "", hostname: str = "", idc: str = "",
                 location: str = "", keepalive_interval: float = 5.0,
                 qos_payload=None):
        host, _, mport = manager_addr.rpartition(":")
        self.client = ManagerClient(NetAddr.tcp(host, int(mport)))
        self.cluster_id = cluster_id
        self.port = port
        self.hostname = hostname or socket.gethostname()
        self.ip = ip or "127.0.0.1"
        self.idc = idc
        self.location = location
        self.keepalive_interval = keepalive_interval
        # A zero-arg callable returning {"tenant_burn": {...}} (or any
        # dict) merged into every keepalive message: the manager's job
        # admission sees fresh burn.
        self.qos_payload = qos_payload
        self.registered: dict | None = None

    async def start(self) -> dict:
        self.registered = await self.client.update_scheduler(
            hostname=self.hostname, ip=self.ip, port=self.port,
            idc=self.idc, location=self.location,
            scheduler_cluster_id=self.cluster_id)
        self.client.start_keepalive(
            source_type="scheduler", hostname=self.hostname, ip=self.ip,
            cluster_id=self.registered["scheduler_cluster_id"],
            interval=self.keepalive_interval, payload=self.qos_payload)
        log.info("registered with manager", id=self.registered["id"],
                 cluster=self.registered["scheduler_cluster_id"])
        return self.registered

    async def stop(self) -> None:
        await self.client.close()
