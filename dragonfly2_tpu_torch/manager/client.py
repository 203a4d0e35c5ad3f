"""The manager's drpc client, for schedulers and daemons: the port's
copy of ``dragonfly2_tpu/manager/client.py`` on the port's
``rpc.Client``.

Typed calls of every ``Manager.*`` method the port's manager serves, and
``start_keepalive``: a task that opens the ``Manager.KeepAlive`` stream,
sends a message every ``interval`` (with the payload provider's dict
merged in) and opens it again after a loss. ``poll_job`` waits 10 s past
the poll's own timeout, so a long poll is answered before the call's
deadline.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc.client import Client

log = dflog.get("manager.client")

PAYLOAD_COUNT = metrics.counter(
    "manager_keepalive_payload_total",
    "Keepalive payload provider outcomes on the client side, by result "
    "(ok = dict merged, absent = no provider or non-dict, error = "
    "provider raised — the warn log for errors is rate-limited, this "
    "counter is the continuous signal)", ("result",))

# A broken payload provider raises every tick forever; warn at most once
# per this many seconds and let the counter carry the rate.
_PAYLOAD_WARN_INTERVAL = 60.0


class ManagerClient:
    def __init__(self, addr: NetAddr):
        self.addr = addr
        self._client = Client(addr)
        self._keepalive_task: asyncio.Task | None = None

    async def close(self) -> None:
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
            try:
                await self._keepalive_task
            except (asyncio.CancelledError, Exception):
                pass
            self._keepalive_task = None
        await self._client.close()

    # -- registry ----------------------------------------------------------

    async def update_scheduler(self, **req: Any) -> dict:
        return await self._client.call("Manager.UpdateScheduler", req)

    async def update_seed_peer(self, **req: Any) -> dict:
        return await self._client.call("Manager.UpdateSeedPeer", req)

    async def get_scheduler_cluster_config(self, cluster_id: int) -> dict:
        return await self._client.call("Manager.GetSchedulerClusterConfig",
                                       {"scheduler_cluster_id": cluster_id})

    async def list_schedulers(self, **req: Any) -> list[dict]:
        resp = await self._client.call("Manager.ListSchedulers", req)
        return resp["schedulers"]

    async def list_seed_peers(self, scheduler_cluster_id: int) -> list[dict]:
        resp = await self._client.call("Manager.ListSeedPeers",
                                       {"scheduler_cluster_id": scheduler_cluster_id})
        return resp["seed_peers"]

    async def list_applications(self) -> list[dict]:
        resp = await self._client.call("Manager.ListApplications", {})
        return resp["applications"]

    async def upsert_peer(self, **req: Any) -> dict:
        return await self._client.call("Manager.UpsertPeer", req)

    # -- jobs --------------------------------------------------------------

    async def poll_job(self, queue: str, timeout: float = 30.0) -> dict | None:
        resp = await self._client.call("Manager.PollJob",
                                       {"queue": queue, "timeout": timeout},
                                       timeout=timeout + 10.0)
        return resp.get("item")

    async def take_job_tokens(self, cluster_ids: list, tokens: int = 1) -> dict:
        """Draw from the manager's per-cluster job buckets, which every
        scheduler instance and the REST face debit. Returns {granted,
        retry_after_s}."""
        return await self._client.call(
            "Manager.TakeJobTokens",
            {"cluster_ids": cluster_ids, "tokens": tokens}, timeout=10.0)

    async def complete_job(self, group_id: str, task_uuid: str, state: str,
                           result: dict[str, Any]) -> None:
        await self._client.call("Manager.CompleteJob", {
            "group_id": group_id, "task_uuid": task_uuid,
            "state": state, "result": result})

    # -- keepalive ---------------------------------------------------------

    def start_keepalive(self, *, source_type: str, hostname: str, ip: str,
                        cluster_id: int, interval: float = 5.0,
                        payload=None) -> None:
        """``payload`` is an optional zero-arg callable whose dict return is
        merged into every keepalive message: how a scheduler carries its
        tenant burn snapshot (``qos/admission.py``)."""
        if self._keepalive_task is None or self._keepalive_task.done():
            self._keepalive_task = asyncio.create_task(self._keepalive_loop(
                source_type=source_type, hostname=hostname, ip=ip,
                cluster_id=cluster_id, interval=interval, payload=payload))

    async def _keepalive_loop(self, *, source_type: str, hostname: str, ip: str,
                              cluster_id: int, interval: float,
                              payload=None) -> None:
        children = {r: PAYLOAD_COUNT.labels(r)
                    for r in ("ok", "error", "absent")}
        last_warn = 0.0
        while True:
            try:
                stream = await self._client.open_stream("Manager.KeepAlive", {
                    "source_type": source_type, "hostname": hostname,
                    "ip": ip, "cluster_id": cluster_id})
                try:
                    while True:
                        await asyncio.sleep(interval)
                        msg = {"ts": asyncio.get_event_loop().time()}
                        if payload is not None:
                            try:
                                extra = payload()
                                if isinstance(extra, dict):
                                    msg.update(extra)
                                    children["ok"].inc()
                                else:
                                    children["absent"].inc()
                            except Exception as e:
                                children["error"].inc()
                                now = time.monotonic()
                                if now - last_warn >= _PAYLOAD_WARN_INTERVAL:
                                    last_warn = now
                                    log.warning(
                                        "keepalive payload provider failed "
                                        "(warn rate-limited; see manager_"
                                        "keepalive_payload_total)",
                                        error=str(e))
                        else:
                            children["absent"].inc()
                        await stream.send(msg)
                finally:
                    await stream.close()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("keepalive stream lost, retrying", error=str(e))
                await asyncio.sleep(interval)
