"""The daemon's dynconfig: the port's copy of
``dragonfly2_tpu/daemon/dynconfig.py``.

``source == "local"``: the static scheduler list of the config.
``source == "manager"``: the manager's searcher-ranked schedulers for
this host (``Manager.ListSchedulers``) and the seed peers of their
clusters (``Manager.ListSeedPeers``), pulled through
``manager/client.ManagerClient`` and kept fresh by ``pkg/dynconfig``
(refresh loop, observers on change, a cache file that survives a manager
outage). The daemon resolves its scheduler client from the first and
replicates the object gateway's PUTs to the second.
"""

from __future__ import annotations

from typing import Any

from dragonfly2_tpu_torch.manager.client import ManagerClient
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.dynconfig import Dynconfig
from dragonfly2_tpu_torch.pkg.types import NetAddr

log = dflog.get("daemon.dynconfig")


def active_scheduler_addrs(data: dict) -> list[str]:
    """``ip:port`` of every active scheduler in a dynconfig pull."""
    return [f"{s['ip']}:{s['port']}" for s in data.get("schedulers", [])
            if s.get("state") == "active"]


class DaemonDynconfig:
    def __init__(self, *, local_addrs: list[str] | None = None,
                 manager_addr: str = "", host_info: dict[str, Any] | None = None,
                 refresh_interval: float = 10.0, cache_dir: str = ""):
        self.local_addrs = list(local_addrs or [])
        self.manager_addr = manager_addr
        self.host_info = host_info or {}
        self.client: ManagerClient | None = None
        self.dc: Dynconfig | None = None
        if manager_addr:
            host, _, port = manager_addr.rpartition(":")
            self.client = ManagerClient(NetAddr.tcp(host, int(port)))
            self.dc = Dynconfig("daemon", self._fetch,
                                refresh_interval=refresh_interval,
                                cache_dir=cache_dir)

    @property
    def source(self) -> str:
        return "manager" if self.client else "local"

    async def _fetch(self) -> dict[str, Any]:
        schedulers = await self.client.list_schedulers(
            hostname=self.host_info.get("hostname", ""),
            ip=self.host_info.get("ip", ""),
            idc=self.host_info.get("idc", ""),
            location=self.host_info.get("location", ""),
            pod=self.host_info.get("pod", ""))
        # The seed peers of our schedulers' clusters ride along, for the
        # object gateway's replication.
        seed_peers: list[dict[str, Any]] = []
        cluster_ids = {s.get("scheduler_cluster_id") for s in schedulers
                       if s.get("scheduler_cluster_id")}
        for cid in sorted(cluster_ids):
            try:
                seed_peers.extend(await self.client.list_seed_peers(cid))
            except Exception as e:
                log.warning("seed peers unavailable", cluster=cid,
                            error=str(e))
        return {"schedulers": schedulers, "seed_peers": seed_peers}

    def cached_seed_peers(self) -> list[dict[str, Any]]:
        """The last-fetched seed peers, without blocking."""
        if self.dc is None:
            return []
        return list(self.dc.cached().get("seed_peers") or [])

    async def scheduler_addrs(self) -> list[str]:
        if self.dc is None:
            return self.local_addrs
        return active_scheduler_addrs(await self.dc.get()) or self.local_addrs

    def register(self, observer) -> None:
        if self.dc is not None:
            self.dc.register(observer)

    def serve(self) -> None:
        if self.dc is not None:
            self.dc.serve()

    async def stop(self) -> None:
        if self.dc is not None:
            self.dc.stop()
        if self.client is not None:
            await self.client.close()
