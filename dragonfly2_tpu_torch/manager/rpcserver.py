"""The manager's drpc surface, which schedulers and daemons speak: the
port's copy of ``dragonfly2_tpu/manager/rpcserver.py`` on the port's
``rpc.Server``.

Unary: ``Manager.GetScheduler``, ``ListSchedulers``, ``UpdateScheduler``,
``GetSchedulerClusterConfig``, ``ListSeedPeers``, ``UpdateSeedPeer``,
``DeleteSeedPeer``, ``ListApplications``, ``ListBuckets``, ``UpsertPeer``,
``PollJob`` (a long poll of the cluster's job queue), ``CompleteJob`` and
``TakeJobTokens``; the ``Manager.KeepAlive`` client stream. The JAX
server's ``Manager.ClusterView`` (the cluster tower's view, ROADMAP A7.4
item 6) is not registered.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.manager import jobqueue
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.rpc.server import RpcContext, Server, ServerStream

log = dflog.get("manager.rpc")


class ManagerRpcServer:
    def __init__(self, service: ManagerService):
        self.service = service

    def register(self, server: Server) -> None:
        server.register_unary("Manager.GetScheduler", self._get_scheduler)
        server.register_unary("Manager.ListSchedulers", self._list_schedulers)
        server.register_unary("Manager.UpdateScheduler", self._update_scheduler)
        server.register_unary("Manager.GetSchedulerClusterConfig", self._get_cluster_config)
        server.register_unary("Manager.ListSeedPeers", self._list_seed_peers)
        server.register_unary("Manager.UpdateSeedPeer", self._update_seed_peer)
        server.register_unary("Manager.DeleteSeedPeer", self._delete_seed_peer)
        server.register_unary("Manager.ListApplications", self._list_applications)
        server.register_unary("Manager.ListBuckets", self._list_buckets)
        server.register_unary("Manager.UpsertPeer", self._upsert_peer)
        server.register_unary("Manager.PollJob", self._poll_job)
        server.register_unary("Manager.CompleteJob", self._complete_job)
        server.register_unary("Manager.TakeJobTokens", self._take_job_tokens)
        server.register_stream("Manager.KeepAlive", self._keep_alive)

    async def _get_scheduler(self, body: dict, ctx: RpcContext) -> dict:
        row = self.service.db.find(
            "schedulers", hostname=body["hostname"], ip=body["ip"],
            scheduler_cluster_id=int(body["scheduler_cluster_id"]))
        if not row:
            raise DfError(Code.NotFound, "scheduler not found")
        return row

    async def _list_schedulers(self, body: dict, ctx: RpcContext) -> dict:
        return {"schedulers": self.service.list_schedulers(body or {})}

    async def _update_scheduler(self, body: dict, ctx: RpcContext) -> dict:
        return self.service.update_scheduler(body)

    async def _get_cluster_config(self, body: dict, ctx: RpcContext) -> dict:
        return self.service.get_scheduler_cluster_config(
            int(body["scheduler_cluster_id"]))

    async def _list_seed_peers(self, body: dict, ctx: RpcContext) -> dict:
        return {"seed_peers": self.service.list_seed_peers_for_cluster(
            int(body["scheduler_cluster_id"]))}

    async def _update_seed_peer(self, body: dict, ctx: RpcContext) -> dict:
        return self.service.update_seed_peer(body)

    async def _delete_seed_peer(self, body: dict, ctx: RpcContext) -> dict:
        row = self.service.db.find(
            "seed_peers", hostname=body["hostname"], ip=body["ip"],
            seed_peer_cluster_id=int(body["seed_peer_cluster_id"]))
        if row:
            self.service.db.delete("seed_peers", row["id"])
        return {}

    async def _list_applications(self, body: dict, ctx: RpcContext) -> dict:
        return {"applications": self.service.list_applications()}

    async def _list_buckets(self, body: dict, ctx: RpcContext) -> dict:
        return {"buckets": self.service.db.list("buckets")}

    async def _upsert_peer(self, body: dict, ctx: RpcContext) -> dict:
        return self.service.upsert_peer(body)

    async def _poll_job(self, body: dict, ctx: RpcContext) -> dict:
        item = await self.service.jobs.poll(
            body["queue"], timeout=float(body.get("timeout", 30.0)))
        return {"item": item.to_wire() if item else None}

    async def _complete_job(self, body: dict, ctx: RpcContext) -> dict:
        self.service.jobs.complete(
            body["group_id"], body["task_uuid"],
            body.get("state", jobqueue.SUCCESS), body.get("result", {}))
        return {}

    async def _take_job_tokens(self, body: dict, ctx: RpcContext) -> dict:
        """Every scheduler instance draws from the same per-cluster
        buckets the REST face debits."""
        granted, retry_after = self.service.take_job_tokens(
            body.get("cluster_ids") or [], int(body.get("tokens", 1)))
        return {"granted": granted, "retry_after_s": retry_after}

    async def _keep_alive(self, stream: ServerStream, ctx: RpcContext) -> None:
        """Open body: {source_type, hostname, ip, cluster_id}. Each further
        message refreshes liveness and may carry ``tenant_burn`` (job
        admission); the stream's end marks the instance inactive. A
        ``fleet_frame`` is dropped: the port has no cluster tower."""
        open_body = stream.open_body or {}
        source_type = open_body.get("source_type", "scheduler")
        hostname = open_body.get("hostname", "")
        ip = open_body.get("ip", "")
        cluster_id = int(open_body.get("cluster_id", 0))
        gen = self.service.keepalive_open(source_type, hostname, ip, cluster_id)
        try:
            while True:
                msg = await stream.recv()
                if msg is None:
                    break
                self.service.keepalive(source_type, hostname, ip, cluster_id)
                if isinstance(msg, dict) and msg.get("tenant_burn"):
                    self.service.ingest_tenant_burn(msg["tenant_burn"])
        finally:
            self.service.mark_inactive(source_type, hostname, ip, cluster_id,
                                       gen=gen)
            log.info("keepalive lost", type=source_type, host=hostname, ip=ip)
