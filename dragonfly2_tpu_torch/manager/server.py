"""The manager's bootstrap: the port's copy of
``dragonfly2_tpu/manager/server.py``.

``ManagerServer`` starts the REST API (``manager/rest.py``), the drpc
server with ``Manager.*`` (``manager/rpcserver.py``), the keepalive
expiry on ``keepalive_gc_interval`` (``pkg/cache.GC``) and, with
``metrics_port >= 0``, the port's ``pkg/metrics_server.py`` on loopback.
With ``prof.enabled`` (the default) it installs the runtime observatory
(``pkg/prof``), probes its loop and serves ``/debug/prof*``. Divergence,
intended: no cluster control tower, so no ``/debug/cluster*`` route
(ROADMAP A7.4 item 6).

From Python::

    server = ManagerServer(ManagerConfig())
    await server.start()   # server.rest_port, server.grpc_port()
    ...
    await server.stop()

From a shell: ``python -m dragonfly2_tpu_torch.manager --port 8080
--grpc-port 65003``.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.manager.config import ManagerConfig
from dragonfly2_tpu_torch.manager.database import Database
from dragonfly2_tpu_torch.manager.rest import RestServer
from dragonfly2_tpu_torch.manager.rpcserver import ManagerRpcServer
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg import prof as proflib
from dragonfly2_tpu_torch.pkg.cache import GC, GCTask
from dragonfly2_tpu_torch.pkg.metrics_server import MetricsServer
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Server

log = dflog.get("manager.server")


class ManagerServer:
    def __init__(self, config: ManagerConfig | None = None):
        self.config = config or ManagerConfig()
        self.db = Database(self.config.database.path)
        self.service = ManagerService(
            self.db, keepalive_timeout=self.config.keepalive_timeout)
        self.rest = RestServer(self.service)
        self.rpc = Server("manager")
        ManagerRpcServer(self.service).register(self.rpc)
        self.gc = GC(log)
        self.gc.add(GCTask("keepalive", self.config.keepalive_gc_interval, 10.0,
                           self._expire))
        self.metrics: MetricsServer | None = None
        self.prof_obs = None    # the runtime observatory (pkg/prof)
        self._prof_probe = None
        self._stopped = asyncio.Event()

    async def _expire(self) -> None:
        n = self.service.expire_stale()
        if n:
            log.info("keepalive expiry", flipped=n)

    async def start(self) -> None:
        await self.rest.serve(self.config.server.host, self.config.server.port)
        await self.rpc.serve(NetAddr.tcp(self.config.grpc.host,
                                         self.config.grpc.port))
        if self.config.prof.enabled:
            self.prof_obs = proflib.install(self.config.prof)
            self._prof_probe = self.prof_obs.arm_loop("manager")
        if self.config.metrics_port >= 0:
            # Loopback only, as in the JAX server.
            self.metrics = MetricsServer(prof=self.prof_obs)
            await self.metrics.serve("127.0.0.1", self.config.metrics_port)
        self.gc.serve()
        log.info("manager up", rest_port=self.rest.port,
                 grpc_port=self.rpc.port())

    async def serve(self) -> None:
        await self.start()
        await self._stopped.wait()

    @property
    def rest_port(self) -> int:
        return self.rest.port

    def grpc_port(self) -> int:
        return self.rpc.port()

    def metrics_port(self) -> int:
        return self.metrics.port if self.metrics is not None else -1

    async def stop(self) -> None:
        self.gc.stop()
        if self.metrics is not None:
            await self.metrics.close()
        if self.prof_obs is not None:
            if self._prof_probe is not None:
                self._prof_probe.disarm()
                self.prof_obs.probes.pop(self._prof_probe.name, None)
                self._prof_probe = None
            proflib.release(self.prof_obs)
            self.prof_obs = None
        await self.rest.close()
        await self.rpc.close()
        self.db.close()
        self._stopped.set()
