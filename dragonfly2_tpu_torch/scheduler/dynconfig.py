"""The scheduler's dynconfig: the port's copy of
``dragonfly2_tpu/scheduler/dynconfig.py``.

It pulls the scheduler cluster's config, client config and scopes and the
seed peers of its linked seed-peer clusters from the manager
(``pkg/dynconfig.Dynconfig``); ``seed_peer_host_wire`` turns a seed-peer
row into the host the resource layer registers before the seed
announces itself.
"""

from __future__ import annotations

from typing import Any

from dragonfly2_tpu_torch.manager.client import ManagerClient
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.dynconfig import Dynconfig
from dragonfly2_tpu_torch.pkg.types import HostType

log = dflog.get("scheduler.dynconfig")


class SchedulerDynconfig:
    def __init__(self, manager_client: ManagerClient, cluster_id: int, *,
                 refresh_interval: float = 10.0, cache_dir: str = ""):
        self.client = manager_client
        self.cluster_id = cluster_id
        self.dc = Dynconfig(f"scheduler-c{cluster_id}", self._fetch,
                            refresh_interval=refresh_interval,
                            cache_dir=cache_dir)

    async def _fetch(self) -> dict[str, Any]:
        cluster = await self.client.get_scheduler_cluster_config(self.cluster_id)
        seed_peers = await self.client.list_seed_peers(self.cluster_id)
        return {
            "config": cluster.get("config", {}),
            "client_config": cluster.get("client_config", {}),
            "scopes": cluster.get("scopes", {}),
            "seed_peers": seed_peers,
        }

    async def get(self) -> dict[str, Any]:
        return await self.dc.get()

    async def seed_peers(self) -> list[dict]:
        return (await self.get()).get("seed_peers", [])

    def register(self, observer) -> None:
        self.dc.register(observer)

    def serve(self) -> None:
        self.dc.serve()

    def stop(self) -> None:
        self.dc.stop()


def seed_peer_host_wire(sp: dict) -> dict:
    """A manager seed-peer row as an AnnounceHost-shaped dict, so the
    resource layer can register the seed before it announces itself."""
    type_map = {"super": HostType.SUPER_SEED, "strong": HostType.STRONG_SEED,
                "weak": HostType.WEAK_SEED}
    return {
        "id": f"{sp['hostname']}-{sp['ip']}-seed",
        "hostname": sp["hostname"],
        "ip": sp["ip"],
        "port": sp["port"],
        "upload_port": sp.get("download_port", 0),
        "type": int(type_map.get(sp.get("type", "super"), HostType.SUPER_SEED)),
        "idc": sp.get("idc", ""),
        "location": sp.get("location", ""),
    }
