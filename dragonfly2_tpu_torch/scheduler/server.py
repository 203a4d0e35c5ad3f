"""The scheduler server: the port's copy of
``dragonfly2_tpu/scheduler/server.py``.

``SchedulerServer`` registers every ``Scheduler.*`` handler of the JAX
server on the port's drpc, runs the resource GC and the HA snapshot
flush on their intervals (``pkg/cache.GC``), flushes the snapshot once
more at stop, and serves ``/metrics`` and ``/healthy`` on the port's
``pkg/metrics_server.py`` when ``metrics_port >= 0`` (no ``/debug/*``
routes). The manager's announcer, dynconfig and job worker are not here
(``manager_addr`` is refused), and ``prof`` installs nothing.

From Python::

    cfg = SchedulerConfig.from_dict({"server": {"port": 0},
                                     "fleet": {"enabled": False}})
    server = SchedulerServer(cfg)
    await server.start()      # server.port() is the bound drpc port
    ...
    await server.stop()
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.cache import GC, GCTask
from dragonfly2_tpu_torch.pkg.metrics_server import MetricsServer
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Server
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
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
        if self.config.metrics_port >= 0:
            # Loopback only, as in the JAX server.
            self.metrics = MetricsServer()
            await self.metrics.serve("127.0.0.1", self.config.metrics_port)
        self.gc.serve()

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
        await self.service.seed_clients.close()
        if self.metrics is not None:
            await self.metrics.close()
        await self.rpc.close()
        self._stopped.set()
