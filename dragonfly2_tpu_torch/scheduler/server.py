"""The scheduler server: the port's copy of
``dragonfly2_tpu/scheduler/server.py``.

``SchedulerServer`` registers every ``Scheduler.*`` handler of the JAX
server on the port's drpc, runs the resource GC and the HA snapshot
flush on their intervals (``pkg/cache.GC``), flushes the snapshot once
more at stop. With ``prof.enabled`` (the default) it installs the
runtime observatory (``pkg/prof``) and probes its loop, whose lag joins
the SLO engine's ``loop_lag`` spec. With ``metrics_port >= 0`` it serves
``pkg/metrics_server.py`` on loopback: ``/metrics``, ``/healthy``, the
stacks, tasks, profile and heap routes, ``/debug/pod/<task>`` (the pod
aggregator), ``/debug/pod/<task>/timeline`` (the pod lens), ``/debug/slo``,
``/debug/prof*`` and, with the fleet observatory on, ``/debug/fleet*``.
With ``manager_addr`` it registers
with the manager (``scheduler/announcer.py``, the keepalive carrying
``service.manager_payload``), keeps the cluster's config and seed peers
fresh (``scheduler/dynconfig.py``; each seed peer registered as a host)
and consumes the cluster's job queue (``scheduler/job.py``). A manager
that cannot be reached at start is retried every 10 s in the background
while the scheduler serves.

From Python::

    cfg = SchedulerConfig.from_dict({"server": {"port": 0}})
    server = SchedulerServer(cfg)
    await server.start()      # server.port() is the bound drpc port
    ...
    await server.stop()
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg import prof as proflib
from dragonfly2_tpu_torch.pkg.cache import GC, GCTask
from dragonfly2_tpu_torch.pkg.metrics_server import MetricsServer
from dragonfly2_tpu_torch.pkg.types import HostType, NetAddr
from dragonfly2_tpu_torch.rpc import Server
from dragonfly2_tpu_torch.scheduler.announcer import SchedulerAnnouncer
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.dynconfig import (
    SchedulerDynconfig,
    seed_peer_host_wire,
)
from dragonfly2_tpu_torch.scheduler.job import JobWorker
from dragonfly2_tpu_torch.scheduler.resource import Host
from dragonfly2_tpu_torch.scheduler.service import SchedulerService

log = dflog.get("scheduler.server")


class SchedulerServer:
    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        self.service = SchedulerService(self.config)
        self.rpc = Server("scheduler")
        self._register()
        self.gc = GC(log)
        self.gc.add(GCTask("resource", self.config.gc.interval, 30.0, self._gc))
        if self.service.snapshot is not None:
            # HA: a periodic durable snapshot flush, so a crash loses at
            # most one interval of state.
            self.gc.add(GCTask("snapshot", self.config.ha.snapshot_interval,
                               15.0, self._snapshot_flush))
        self.metrics: MetricsServer | None = None
        self.announcer: SchedulerAnnouncer | None = None
        self.dynconfig: SchedulerDynconfig | None = None
        self.job_worker: JobWorker | None = None
        self.prof_obs = None    # the runtime observatory (pkg/prof)
        self._prof_probe = None
        self._manager_retry: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    def _register(self) -> None:
        s = self.service
        self.rpc.register_stream("Scheduler.AnnouncePeer", s.announce_peer)
        self.rpc.register_unary("Scheduler.AnnounceHost", s.announce_host)
        self.rpc.register_unary("Scheduler.LeaveHost", s.leave_host)
        self.rpc.register_unary("Scheduler.LeavePeer", s.leave_peer)
        self.rpc.register_unary("Scheduler.AnnounceTask", s.announce_task)
        self.rpc.register_unary("Scheduler.StatTask", s.stat_task)
        self.rpc.register_unary("Scheduler.UploadPersistentCacheTaskStarted",
                                s.upload_persistent_cache_task_started)
        self.rpc.register_unary("Scheduler.UploadPersistentCacheTaskFinished",
                                s.upload_persistent_cache_task_finished)
        self.rpc.register_unary("Scheduler.UploadPersistentCacheTaskFailed",
                                s.upload_persistent_cache_task_failed)
        self.rpc.register_unary("Scheduler.StatPersistentCacheTask",
                                s.stat_persistent_cache_task)
        self.rpc.register_unary("Scheduler.ListPersistentCacheTasks",
                                s.list_persistent_cache_tasks)
        self.rpc.register_unary("Scheduler.DeletePersistentCacheTask",
                                s.delete_persistent_cache_task)
        self.rpc.register_unary("Scheduler.StatPeer", s.stat_peer)
        self.rpc.register_unary("Scheduler.ListHosts", s.list_hosts)
        self.rpc.register_unary("Scheduler.PodTimeline", s.pod_timeline)

    async def _gc(self) -> None:
        counts = self.service.gc()
        if any(counts.values()):
            log.info("resource gc", **counts)

    async def _snapshot_flush(self) -> None:
        self.service.snapshot_flush()

    async def serve(self) -> None:
        await self.start()
        log.info("scheduler up", port=self.port())
        await self._stopped.wait()

    async def start(self) -> None:
        await self.rpc.serve(NetAddr.tcp(self.config.server.host,
                                         self.config.server.port))
        if self.config.prof.enabled:
            self.prof_obs = proflib.install(self.config.prof)
            self._prof_probe = self.prof_obs.arm_loop("scheduler")
            if self.service.slo is not None:
                # Scheduler wedge time burns against the same /debug/slo
                # as the broadcast SLIs.
                self.service.slo.probes.update(self.prof_obs.slo_probes())
        if self.config.metrics_port >= 0:
            # Loopback only, as in the JAX server: /debug exposes stacks.
            self.metrics = MetricsServer(
                pod_flight=self.service.pod_flight,
                fleet=self.service.fleet,
                slo=self.service.slo,
                pod_timeline=self.service.pod_timeline_report,
                prof=self.prof_obs)
            await self.metrics.serve("127.0.0.1", self.config.metrics_port)
        self.gc.serve()
        if self.config.manager_addr:
            try:
                await self._connect_manager()
            except Exception as e:
                # A manager briefly down must not stop a serving
                # scheduler: it serves with its local config meanwhile.
                log.warning("manager unreachable, retrying in background",
                            error=str(e))
                await self._drop_announcer()
                self._manager_retry = asyncio.create_task(
                    self._retry_manager())

    async def _drop_announcer(self) -> None:
        """Close a half-open manager client."""
        if self.announcer is not None:
            await self.announcer.stop()
            self.announcer = None

    async def _retry_manager(self) -> None:
        while True:
            await asyncio.sleep(10.0)
            try:
                await self._connect_manager()
                return
            except Exception as e:
                log.warning("manager still unreachable", error=str(e))
                await self._drop_announcer()

    async def _connect_manager(self) -> None:
        """Register with the manager, keep the cluster's config and seed
        peers fresh, and start the job worker."""
        self.announcer = SchedulerAnnouncer(
            self.config.manager_addr, cluster_id=self.config.cluster_id,
            port=self.port(), ip=self.config.server.advertise_ip or "127.0.0.1",
            hostname=self.config.hostname,
            keepalive_interval=self.config.manager_keepalive_interval,
            qos_payload=self.service.manager_payload)
        await self.announcer.start()
        cluster_id = self.announcer.registered["scheduler_cluster_id"]
        self.dynconfig = SchedulerDynconfig(self.announcer.client, cluster_id)

        def sync_seed_peers(data: dict) -> None:
            for sp in data.get("seed_peers", []):
                w = seed_peer_host_wire(sp)
                host = self.service.hosts.load_or_store(Host(
                    w["id"], hostname=w["hostname"], ip=w["ip"],
                    port=w["port"], upload_port=w["upload_port"],
                    host_type=HostType(w["type"]), idc=w["idc"],
                    location=w["location"]))
                host.touch()

        self.dynconfig.register(sync_seed_peers)
        await self.dynconfig.dc.refresh()
        self.dynconfig.serve()
        self.job_worker = JobWorker(self.service, self.announcer.client,
                                    cluster_id)
        self.job_worker.serve()

    def port(self) -> int:
        return self.rpc.port()

    async def stop(self) -> None:
        self.gc.stop()
        if self.service.snapshot is not None:
            # A graceful stop leaves a fresh snapshot; a crash leaves the
            # last periodic flush. Both are valid restore points.
            try:
                self.service.snapshot_flush()
            except Exception:
                log.warning("snapshot flush at stop failed", exc_info=True)
        if self.job_worker is not None:
            self.job_worker.stop()
        if self._manager_retry is not None:
            self._manager_retry.cancel()
        if self.dynconfig is not None:
            self.dynconfig.stop()
        await self._drop_announcer()
        await self.service.seed_clients.close()
        if self.metrics is not None:
            await self.metrics.close()
        if self.prof_obs is not None:
            if self._prof_probe is not None:
                self._prof_probe.disarm()
                self.prof_obs.probes.pop(self._prof_probe.name, None)
                self._prof_probe = None
            if self.service.slo is not None:
                self.service.slo.probes.pop("loop_lag", None)
            proflib.release(self.prof_obs)
            self.prof_obs = None
        await self.rpc.close()
        self._stopped.set()
