"""The daemon: the port's copy of ``dragonfly2_tpu/daemon/daemon.py``.
``Daemon(config, device=)`` builds every service from a ``DaemonConfig``
(``daemon/config.py``), ``start()`` brings them up, ``stop()`` tears them
down and ``serve()`` runs until ``stop()`` or ``alive_time``.

Construction, in the JAX order:

- the host's slice and worker from the environment
  (``parallel/topology.apply_to_host_config``);
- the task stores over ``<work_home>/data`` with the config's TTL, quota,
  GC interval and idle-descriptor close, reloaded from disk;
- the piece manager under the download rate;
- the scheduler client when ``scheduler.addrs`` names schedulers (with
  ``manager_addr``, ``start()`` resolves it from the manager instead, or
  as well: ``daemon/dynconfig.py``);
- with ``qos.enabled``, the QoS plane (``qos/``): one ``WFQGate`` of
  ``qos.dispatch_capacity`` slots (2 x ``download.parent_concurrency``
  when 0) that every conductor's piece workers share, and
  ``TenantBuckets`` splitting ``upload.rate_limit`` among the tenants the
  upload server serves;
- the upload server;
- the port's ``DeviceSinkManager`` on ``device`` when ``tpu_sink.enabled``
  (a ``device: "tpu"`` request lands there on the card);
- the ``TaskManager`` (total rate, traffic shaper, ``prefetch``), the drpc
  services (``DaemonRpcServer``, whose delta tasks build base manifests on
  ``device``), with ``proxy.enabled`` the forward proxy and registry
  mirror (``daemon/proxy.py`` over a ``P2PTransport`` with the config's
  rules; with ``hijack_https`` or ``sni_hijack`` its CA,
  ``proxy.ca_cert``/``ca_key`` or one generated and kept under
  ``<work_home>/ca``) and, when ``object_storage.enabled``, the object
  gateway;
- the GC task: the stores' GC, then the device sinks' TTL sweep, every
  ``gc_interval``.

``start()``: the host library built off the loop (``pkg/dfhost``, CRC-32C
of every stored piece), with ``manager_addr`` the manager-fed dynconfig
(the active schedulers of ``Manager.ListSchedulers`` for this host, the
static ``scheduler.addrs`` as fallback, refreshed every 10 s: a
scheduler that registers later is picked up then, and the announcer
starts late; the seed peers of ``Manager.ListSeedPeers`` are where the
gateway replicates a PUT), the traffic shaper's loop, the flight recorder's
``dump_dir``, ``keep_bundles`` and ``clock_offset_s``, with
``prof.enabled`` (the default) the runtime observatory (``pkg/prof``:
the sampler, a lag probe on the daemon's loop, the GC observatory; slow
ticks and pauses stamped into running flights, its snapshot in
post-mortem bundles) and a runtime-only SLO engine of ``RUNTIME_SLOS``
(``loop_lag`` at ``prof.lag_slow_s``), the metrics server on loopback at
``metrics_port`` (-1: none: ``/metrics`` and the ``/debug/*`` routes with
the flight recorder, the observatory and that engine), the download
service on
``unix_sock``, the peer service on ``download.peer_port`` (-1: none), the
upload server, the proxy on ``proxy.port`` and, with ``sni_enabled``, its
SNI listener on ``sni_port``, the gateway, PEX when enabled (gossiping
every completed store), the announcer when there is a scheduler, and the
GC loop.
``stop()``: the GC loop, the shaper, PEX, the metrics server, the
observatory (released), the dynconfig,
the announcer (its ``leave_host``), the scheduler client, the proxy, the gateway, the
upload server, the drpc services, the sink worker (waited for), the origin
clients' pooled connections, then the stores.

The conductor gets ``download.parent_concurrency`` piece workers,
``download.report_batch`` and ``is_seed`` from a seed trigger or
``seed_peer``; its host record is the announcer's ``host_wire`` less the
telemetry. ``download.calculate_digest`` sets nothing: the port's piece
path always records each piece's CRC-32C, fused into the store write.

Refused at construction with ``ValueError`` naming the ``ROADMAP.md``
item, since the port does not have it yet: an object-storage backend
other than ``fs``.
"""

from __future__ import annotations

import asyncio
import os

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.daemon.announcer import Announcer
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.peer.conductor import conductor_factory
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManager,
    PieceManagerOption,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager
from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer
from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
from dragonfly2_tpu_torch.daemon.upload import UploadManager
from dragonfly2_tpu_torch.parallel.topology import apply_to_host_config
from dragonfly2_tpu_torch.pkg import aio, dflog
from dragonfly2_tpu_torch.pkg.cache import GC, GCTask
from dragonfly2_tpu_torch.pkg.objectstorage import NOT_PORTED
from dragonfly2_tpu_torch.pkg.ratelimit import Limiter
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption

log = dflog.get("daemon")


def refuse_unported(config: DaemonConfig) -> None:
    """Raise ValueError for a service the config enables that the port
    does not have yet; nothing goes on without it."""
    unported = []
    backend = config.object_storage.backend
    if config.object_storage.enabled and backend != "fs":
        which = ("is not ported yet" if backend in NOT_PORTED
                 else "is unknown")
        unported.append(f"object_storage.backend {backend!r} {which}: the "
                        f"cloud backends come with ROADMAP A7.3's source "
                        f"clients")
    if unported:
        raise ValueError("the port's daemon cannot run this config: "
                         + "; ".join(unported))


class Daemon:
    def __init__(self, config: DaemonConfig, *, device=None):
        refuse_unported(config)
        self.config = config
        self.device = default_device(device)
        path = config.dfpath.ensure()
        dflog.configure(log_dir=path.log_dir)
        apply_to_host_config(config.host)

        self.storage = StorageManager(StorageOption(
            data_dir=path.data_dir,
            task_ttl=config.storage.task_ttl,
            disk_gc_threshold=config.storage.disk_gc_threshold,
            gc_interval=config.gc_interval,
            fd_idle_close=config.storage.fd_idle_close))
        self.storage.reload()

        rate = config.download.rate_limit
        self.piece_manager = PieceManager(
            PieceManagerOption(
                concurrency=config.download.piece_concurrency,
                concurrent_min_length=config.download.concurrent_min_length),
            limiter=Limiter(rate if rate > 0 else float("inf")))

        self.scheduler_client: SchedulerClient | None = None
        if config.scheduler.addrs:
            self.scheduler_client = SchedulerClient(config.scheduler.addrs)
        self.qos_gate = None
        qos_buckets = None
        if config.qos.enabled:
            from dragonfly2_tpu_torch import qos as qoslib

            capacity = config.qos.dispatch_capacity or (
                2 * max(1, config.download.parent_concurrency))
            self.qos_gate = qoslib.WFQGate(capacity)
            qos_buckets = qoslib.TenantBuckets(
                float(config.upload.rate_limit),
                min_share_fraction=config.qos.upload_min_share_fraction)
        self.upload = UploadManager(self.storage,
                                    rate_limit=config.upload.rate_limit,
                                    qos_buckets=qos_buckets)
        device_sinks = None
        if config.tpu_sink.enabled:
            from dragonfly2_tpu_torch.daemon.peer.device_sink import (
                DeviceSinkManager,
            )

            device_sinks = DeviceSinkManager(
                mesh_shape=config.tpu_sink.mesh_shape,
                batch_pieces=config.tpu_sink.batch_pieces,
                max_tasks=config.tpu_sink.max_tasks, device=self.device)
        self.task_manager = TaskManager(
            self.storage,
            self.piece_manager,
            host_ip=config.host.ip,
            scheduler_client=self.scheduler_client,
            total_rate_limit=rate,
            host_wire=self._host_wire,
            traffic_shaper=config.download.traffic_shaper,
            prefetch=config.download.prefetch,
            device_sinks=device_sinks,
        )
        if self.scheduler_client is not None:
            self._use_conductors()
        self.rpc = DaemonRpcServer(self.task_manager, device=self.device)
        self.proxy = None
        if config.proxy.enabled:
            from dragonfly2_tpu_torch.daemon.proxy import Proxy
            from dragonfly2_tpu_torch.daemon.transport import (
                P2PTransport,
                rules_from_config,
            )

            ca = None
            if config.proxy.hijack_https or config.proxy.sni_hijack:
                from dragonfly2_tpu_torch.pkg.certify import CertAuthority

                ca = CertAuthority.load_or_generate(
                    config.proxy.ca_cert, config.proxy.ca_key,
                    persist_dir=os.path.join(config.work_home, "ca"))
            self.proxy = Proxy(
                P2PTransport(self.task_manager,
                             rules=rules_from_config(config.proxy.rules)),
                registry_mirror=config.proxy.registry_mirror,
                max_concurrency=config.proxy.max_concurrency,
                white_list_ports=config.proxy.white_list_ports,
                cert_authority=ca,
                hijack_hosts=config.proxy.hijack_hosts)
        self.object_storage = None
        if config.object_storage.enabled:
            from dragonfly2_tpu_torch.daemon.objectstorage import (
                ObjectStorageService,
            )
            from dragonfly2_tpu_torch.daemon.transport import P2PTransport
            from dragonfly2_tpu_torch.pkg.objectstorage import new_client

            backend = new_client(config.object_storage.backend,
                                 **config.object_storage.backend_options)
            self.object_storage = ObjectStorageService(
                backend, P2PTransport(self.task_manager),
                get_seed_peers=self._known_seed_peers,
                trigger_seed=self._trigger_seed_peer)
        self.announcer: Announcer | None = None
        self.dynconfig = None  # the manager-fed scheduler resolution
        self.pex = None        # gossip peer exchange (started in start())
        self.metrics = None    # the metrics and /debug server
        self.prof_obs = None   # the runtime observatory (pkg/prof)
        self._prof_probe = None
        self._runtime_slo = None
        self._source_registry = None
        self._started = False
        self._peer_port = 0
        self.gc = GC(log)
        self.gc.add(GCTask("storage", config.gc_interval, 30.0,
                           self._gc_storage))
        self._stopped = asyncio.Event()

    def _use_conductors(self) -> None:
        """P2P downloads through ``self.scheduler_client``."""
        self.task_manager.conductor_factory = conductor_factory(
            scheduler_client=self.scheduler_client,
            piece_manager=self.piece_manager,
            host_wire=self._conductor_host,
            task_manager=self.task_manager,
            piece_parallelism=self.config.download.parent_concurrency,
            report_batch=self.config.download.report_batch,
            seed_peer=self.config.seed_peer, wfq=self.qos_gate)

    def _host_wire(self) -> dict:
        """The host's identity, {} before the announcer exists."""
        if self.announcer is None:
            return {}
        return self.announcer.host_wire()

    def _conductor_host(self) -> dict:
        if self.announcer is None:
            raise RuntimeError("conductor requires a started daemon "
                               "(announcer missing)")
        return self.announcer.host_wire()

    # -- object-storage replication hooks ----------------------------------

    def _known_seed_peers(self) -> list[dict]:
        """The seed peers a PUT replicates to: the manager's, as the
        dynconfig last pulled them; none without a manager."""
        if self.dynconfig is not None:
            return self.dynconfig.cached_seed_peers()
        return []

    async def _trigger_seed_peer(self, seed: dict, spec: dict) -> bool:
        """``Peer.TriggerDownloadTask`` at a seed daemon."""
        from dragonfly2_tpu_torch.rpc import Client

        cli = Client(NetAddr.tcp(seed.get("ip", ""), int(seed.get("port", 0))))
        try:
            resp = await cli.call("Peer.TriggerDownloadTask", spec,
                                  timeout=10.0)
            return bool(resp and resp.get("ok"))
        except Exception:
            return False
        finally:
            await cli.close()

    # -- the manager-fed scheduler list ----------------------------------

    async def _resolve_schedulers_from_manager(self) -> None:
        """Resolve the scheduler set through the manager and keep it fresh;
        the static ``scheduler.addrs`` stay the fallback. The refresh loop
        always runs, so a daemon started before any scheduler registered
        picks one up on the next refresh."""
        from dragonfly2_tpu_torch.daemon.dynconfig import (
            DaemonDynconfig,
            active_scheduler_addrs,
        )

        h = self.config.host
        self.dynconfig = DaemonDynconfig(
            local_addrs=self.config.scheduler.addrs,
            manager_addr=self.config.manager_addr,
            host_info={"hostname": h.hostname, "ip": h.ip, "idc": h.idc,
                       "location": h.location, "pod": h.tpu_slice},
            cache_dir=self.config.dfpath.cache_dir)
        addrs = await self.dynconfig.scheduler_addrs()
        if addrs:
            self._apply_scheduler_addrs(addrs)
        else:
            log.warning("manager returned no schedulers yet; will keep polling")

        def _on_change(data: dict) -> None:
            fresh = active_scheduler_addrs(data)
            if fresh:
                self._apply_scheduler_addrs(fresh)

        self.dynconfig.register(_on_change)
        self.dynconfig.serve()

    def _apply_scheduler_addrs(self, addrs: list[str]) -> None:
        if self.scheduler_client is not None:
            self.scheduler_client.update_addrs(addrs)
            return
        self.scheduler_client = SchedulerClient(addrs)
        self.task_manager.scheduler_client = self.scheduler_client
        self._use_conductors()
        # Discovered after start(): the announcer comes up now, so the
        # scheduler learns this host.
        if self._started and self.announcer is None:
            self.announcer = Announcer(
                self.config, self.scheduler_client,
                peer_port=self._peer_port, upload_port=self.upload.port,
                recorder=self.task_manager.flight)
            aio.spawn(self.announcer.start())

    async def _gc_storage(self) -> None:
        self.storage.gc()
        if self.task_manager.device_sinks is not None:
            # Unclaimed sinks must not hold device memory for the
            # daemon's lifetime.
            self.task_manager.device_sinks.gc()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Bring every service up (returns once they serve)."""
        from dragonfly2_tpu_torch.source import default_registry

        # Taken first: a sibling daemon's stop must not close the shared
        # origin clients under a request that raced in.
        self._source_registry = default_registry().retain()
        try:
            await self._start_inner()
        except BaseException:
            registry, self._source_registry = self._source_registry, None
            await registry.release()
            raise

    async def _start_inner(self) -> None:
        from dragonfly2_tpu_torch.ops import _build

        # A cold host library is seconds of g++: never on the loop.
        await asyncio.get_running_loop().run_in_executor(
            None, _build.host_library)
        if self.config.manager_addr:
            await self._resolve_schedulers_from_manager()
        self.task_manager.shaper.serve()
        recorder = self.task_manager.flight
        if not recorder.dump_dir:
            recorder.dump_dir = self.config.dfpath.log_dir
        recorder.keep_bundles = self.config.flight_keep_bundles
        if self.config.clock_offset_s:
            recorder.wall_offset = self.config.clock_offset_s
        if self.config.prof.enabled:
            # The runtime observatory: slow ticks and pauses stamp typed
            # events into every running flight; the loop probe feeds a
            # daemon-side loop_lag SLO engine at /debug/slo.
            from dataclasses import replace as _dc_replace

            from dragonfly2_tpu_torch.pkg import prof as proflib
            from dragonfly2_tpu_torch.pkg import slo as slolib

            self.prof_obs = proflib.install(self.config.prof,
                                            recorder=recorder)
            self._prof_probe = self.prof_obs.arm_loop("daemon")
            recorder.runtime = self.prof_obs
            self._runtime_slo = slolib.SLOEngine(
                specs=tuple(
                    _dc_replace(s, threshold=self.config.prof.lag_slow_s)
                    for s in slolib.RUNTIME_SLOS),
                probes=self.prof_obs.slo_probes())
        if self.config.metrics_port >= 0:
            from dragonfly2_tpu_torch.pkg.metrics_server import MetricsServer

            # Loopback only: /debug exposes live stacks.
            self.metrics = MetricsServer(flight=recorder, prof=self.prof_obs,
                                         slo=self._runtime_slo)
            await self.metrics.serve("127.0.0.1", self.config.metrics_port)
        await self.rpc.serve_download(NetAddr.unix(self.config.unix_sock))
        if self.config.download.peer_port >= 0:
            await self.rpc.serve_peer(NetAddr.tcp(
                self.config.host.ip, self.config.download.peer_port))
        self.upload.serve(self.config.host.ip, self.config.upload.port)
        if self.proxy is not None:
            await self.proxy.serve(self.config.host.ip, self.config.proxy.port)
            if self.config.proxy.sni_enabled:
                await self.proxy.serve_sni(
                    self.config.host.ip, self.config.proxy.sni_port,
                    hijack=self.config.proxy.sni_hijack)
        if self.object_storage is not None:
            await self.object_storage.serve(self.config.host.ip,
                                            self.config.object_storage.port)
        peer_port = self.peer_port()
        if self.config.pex.enabled:
            from dragonfly2_tpu_torch.daemon.pex import PeerExchange

            self.pex = PeerExchange(
                ip=self.config.host.ip, peer_port=peer_port,
                upload_port=self.upload.port, secret=self.config.pex.secret)
            await self.pex.start(self.config.pex.port, self.config.pex.seeds)
            self.task_manager.pex = self.pex
            # Gossip what is already complete on disk.
            for store in self.storage.tasks():
                if store.metadata.done and not store.metadata.invalid:
                    self.pex.add_task(store.metadata.task_id)
        self._peer_port = peer_port
        self._started = True
        if self.scheduler_client is not None:
            self.announcer = Announcer(
                self.config, self.scheduler_client, peer_port=peer_port,
                upload_port=self.upload.port, recorder=recorder)
            await self.announcer.start()
        self.gc.serve()
        log.info("daemon up", sock=self.config.unix_sock, peer_port=peer_port,
                 upload_port=self.upload.port, seed=self.config.seed_peer)

    async def serve(self) -> None:
        """``start()``, then wait for ``stop()`` or ``alive_time``."""
        await self.start()
        if self.config.alive_time > 0:
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       self.config.alive_time)
            except asyncio.TimeoutError:
                log.info("alive time reached, exiting")
        else:
            await self._stopped.wait()

    async def stop(self) -> None:
        self.gc.stop()
        self.task_manager.shaper.stop()
        if self.pex is not None:
            await self.pex.stop()
        if self.metrics is not None:
            await self.metrics.close()
        if self.prof_obs is not None:
            from dragonfly2_tpu_torch.pkg import prof as proflib

            if self._prof_probe is not None:
                self._prof_probe.disarm()
                self.prof_obs.probes.pop(self._prof_probe.name, None)
                self._prof_probe = None
            self.task_manager.flight.runtime = None
            proflib.release(self.prof_obs)
            self.prof_obs = None
        if self.dynconfig is not None:
            await self.dynconfig.stop()
        if self.announcer is not None:
            await self.announcer.stop()
        if self.scheduler_client is not None:
            await self.scheduler_client.close()
        if self.proxy is not None:
            await self.proxy.close()
        if self.object_storage is not None:
            await self.object_storage.close()
        await asyncio.to_thread(self.upload.close)
        await self.rpc.close()
        if self.task_manager.device_sinks is not None:
            await asyncio.to_thread(self.task_manager.device_sinks.close,
                                    wait=True)
        registry, self._source_registry = self._source_registry, None
        if registry is not None:
            await registry.release(close_when_idle=True)
        self.storage.close()
        self._stopped.set()

    def peer_port(self) -> int:
        """The peer service's port (0 when it does not serve)."""
        server = self.rpc.peer_server
        return server.port() if server._servers else 0
