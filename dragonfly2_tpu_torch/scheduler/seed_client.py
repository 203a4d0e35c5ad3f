"""The seed-peer client pool, the scheduler's calls to daemons: the port's
copy of ``dragonfly2_tpu/scheduler/seed_client.py`` on the port's
``rpc.Client``.

``Peer.TriggerDownloadTask`` asks a seed daemon to fetch a task from the
origin for the cluster; ``Peer.DeleteTask``, ``Peer.StatTask`` and
``Daemon.FlightReport`` reach any daemon's peer service.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client

log = dflog.get("scheduler.seed_client")


class SeedPeerClientPool:
    def __init__(self):
        self._clients: dict[str, Client] = {}

    def _client(self, ip: str, port: int) -> Client:
        key = f"{ip}:{port}"
        cli = self._clients.get(key)
        if cli is None:
            cli = Client(NetAddr.tcp(ip, port))
            self._clients[key] = cli
        return cli

    async def trigger_download_task(self, host, task_spec: dict) -> bool:
        """Fire-and-forget trigger; the seed reports progress through its own
        AnnouncePeer stream. Returns False if the seed is unreachable."""
        cli = self._client(host.ip, host.port)
        try:
            resp = await cli.call("Peer.TriggerDownloadTask", task_spec, timeout=10.0)
            return bool(resp and resp.get("ok"))
        except Exception as e:
            log.warning("seed trigger failed", seed=host.id, error=str(e))
            return False

    async def delete_task(self, host, task_id: str) -> bool:
        """Remove a task's local store on a daemon (delete_task job fan-out —
        reference scheduler/job/job.go deleteTask → dfdaemon client)."""
        cli = self._client(host.ip, host.port)
        try:
            resp = await cli.call("Peer.DeleteTask", {"task_id": task_id}, timeout=10.0)
            return bool(resp and resp.get("ok"))
        except Exception as e:
            log.warning("peer delete_task failed", host=host.id, error=str(e))
            return False

    async def stat_task(self, host, task_id: str) -> dict | None:
        """Remote task stat on a daemon (get_task job / sync probes)."""
        cli = self._client(host.ip, host.port)
        try:
            return await cli.call("Peer.StatTask", {"task_id": task_id}, timeout=10.0)
        except Exception:
            return None

    async def flight_digest(self, host, task_id: str) -> dict | None:
        """On-demand pod-lens pull: the compact flight digest for a task
        a daemon ran but whose shipped digest never arrived (crashed
        stream, still running). Best-effort — None on any failure."""
        cli = self._client(host.ip, host.port)
        try:
            resp = await cli.call("Daemon.FlightReport",
                                  {"task_id": task_id}, timeout=5.0)
            return resp.get("digest") if isinstance(resp, dict) else None
        except Exception:
            return None

    async def close(self) -> None:
        for cli in self._clients.values():
            await cli.close()
        self._clients.clear()
