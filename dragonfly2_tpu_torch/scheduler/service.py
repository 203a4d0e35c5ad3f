"""The scheduler service, the AnnouncePeer stream and the resource RPCs:
the port's copy of ``dragonfly2_tpu/scheduler/service.py``, with every
handler the JAX server registers.

Stream protocol (drpc ``Scheduler.AnnouncePeer``):
  open_body: {host:{...}, peer_id, task_id, url, tag, application, digest,
              filters, header, priority, range, is_seed, pod_broadcast}
  client -> server: register | download_started | piece_finished |
                    pieces_finished | piece_failed | reschedule |
                    download_finished | download_failed
  server -> client: empty_task | tiny_task | small_task |
                    normal_task{task, parents, stripe?} |
                    need_back_source{reason} | schedule_failed{reason}

With ``fleet.enabled`` (the default) the service feeds the fleet
observatory (``pkg/fleet.py``) from its report paths, as the JAX service
does: registrations, announces, piece batches, typed failures,
quarantines, back-to-source and stripe handouts, failed schedules and
admission transitions; ``fleet.straggler_filter`` wires it into the
scheduling core (handout records, the advisory straggler filter).
With ``podlens.enabled`` (the default) it builds the pod lens
(``pkg/podlens.py``): each announce's clock sample feeds its per-host
offset estimate, each terminal announce's flight digest is stored, and
``pod_timeline_report`` merges them, pulling up to
``podlens.pull_missing`` digests of participants that shipped none over
``Daemon.FlightReport`` (``Scheduler.PodTimeline``, ``/debug/pod/<task>/
timeline``). ``podlens.slo_enabled`` (the default) adds the SLO engine
(``pkg/slo.py``) over the fleet series and the shipped completions. A
``scheduling.algorithm`` other than ``"default"`` is an evaluator plugin
(``pkg/dfplugin.py``). ``manager_addr`` is served
(``scheduler/server.py``: the announcer, dynconfig and job worker);
``manager_payload`` is what its keepalive carries: the tenant burn
snapshot, and no fleet frame (the manager has no cluster tower). The
tiny task's direct piece is fetched with ``http.client`` on a worker
thread, with the JAX fetch's URL, timeout and digest check. One
divergence: each task's candidate sample draws from a
``random.Random`` of its own, not the global generator
(``pkg/dag.py``).
"""

from __future__ import annotations

import asyncio
import http.client
import urllib.parse

from dragonfly2_tpu_torch.pkg import aio, dflog
from dragonfly2_tpu_torch.pkg import digest as dfdigest
from dragonfly2_tpu_torch.pkg import fleet as fleetlib
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg import podlens as podlenslib
from dragonfly2_tpu_torch.pkg import slo as slolib
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.fsm import TransitionError
from dragonfly2_tpu_torch.pkg.piece import PieceInfo, SizeScope
from dragonfly2_tpu_torch.pkg.types import HostType
from dragonfly2_tpu_torch.proto import reportcodec
from dragonfly2_tpu_torch.qos.admission import TenantBurnBook
from dragonfly2_tpu_torch.rpc import RpcContext, ServerStream
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig
from dragonfly2_tpu_torch.scheduler.resource import (
    Host,
    HostManager,
    Peer,
    PeerManager,
    PeerState,
    Task,
    TaskManager,
    TaskState,
)
from dragonfly2_tpu_torch.scheduler.resource import persistentcache as pc
from dragonfly2_tpu_torch.scheduler.resource.snapshot import SnapshotStore
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.scheduling import stripe as stripe_mod
from dragonfly2_tpu_torch.scheduler.scheduling.scheduling import ScheduleResult
from dragonfly2_tpu_torch.scheduler.seed_client import SeedPeerClientPool

log = dflog.get("scheduler.service")

from dragonfly2_tpu_torch.pkg import metrics  # noqa: E402

REGISTER_SCOPE_COUNT = metrics.counter(
    "scheduler_register_size_scope_total",
    "Peer registrations by task size scope shortcut", ("scope",))

PARENT_PICK_COUNT = metrics.counter(
    "scheduler_parent_picks_total",
    "Scheduled parent handouts by ICI locality: intra (same tpu_slice), "
    "cross (different slices), unlabeled (either end without coordinates)",
    ("locality",))

STRIPE_HANDOUT_COUNT = metrics.counter(
    "scheduler_stripe_handouts_total",
    "Striped-broadcast plan deliveries: striped (handout carried a stripe) "
    "or reshuffle (membership-change push to a live slice member)",
    ("kind",))

PARENT_DEMOTION_COUNT = metrics.counter(
    "scheduler_parent_quarantine_total",
    "Hosts entering scheduler-side quarantine from typed piece_failed "
    "reports, by tipping reason", ("reason",))

PEER_REREGISTER_COUNT = metrics.counter(
    "scheduler_peer_reregister_total",
    "Terminal peers replaced by a fresh registration (announce-stream "
    "recovery after a drop)")

REPORT_BATCH_COUNT = metrics.counter(
    "scheduler_report_batches_total",
    "Ingested piece-report batches (piece_finished counts as a batch of "
    "one), by wire encoding: packed (proto/reportcodec columns) or dict "
    "(legacy per-piece PIECE maps)", ("encoding",))

INGEST_BATCH_PIECES = metrics.histogram(
    "scheduler_ingest_batch_pieces",
    "Pieces per ingested report batch — how well the announce wire "
    "coalesces under load (1 = idle single-piece latency path)",
    (), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024))

STATE_REBUILT_COUNT = metrics.counter(
    "scheduler_state_rebuilt_peers_total",
    "Peers whose Task/Peer state this scheduler rebuilt without having "
    "watched the download: resume-carrying re-registrations after a "
    "failover/restart, and durable-snapshot restores at boot",
    ("source",))

class SchedulerService:
    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        gc = self.config.gc
        self.hosts = HostManager(ttl=gc.host_ttl)
        self.tasks = TaskManager(ttl=gc.task_ttl)
        self.peers = PeerManager(ttl=gc.peer_ttl)
        self.scheduling = Scheduling(self.config.scheduling)
        self.seed_clients = SeedPeerClientPool()
        self.persistent = pc.PersistentCacheResource(
            self.config.persistent_cache_db)
        # Pod-level flight aggregation: per-host phase attribution from
        # the piece reports' timings, and quarantine correlation.
        self.pod_flight = flightlib.PodAggregator()
        # Fleet observatory (pkg/fleet): bounded cluster time-series +
        # cross-task host scorecards + scheduling decision audit log, fed
        # from the report paths below and served at /debug/fleet* by the
        # scheduler's MetricsServer. The scorecard straggler flag feeds
        # an advisory filter into scheduling._is_candidate.
        fc = self.config.fleet
        self.fleet: "fleetlib.FleetObservatory | None" = None
        if fc.enabled:
            self.fleet = fleetlib.FleetObservatory(
                bucket_s=fc.bucket_s, buckets=fc.buckets,
                decision_cap=fc.decision_cap, max_hosts=fc.scorecard_hosts,
                straggler_z=fc.straggler_z,
                min_serve_samples=fc.min_serve_samples,
                min_population=fc.min_population,
                sampler=self._fleet_gauges,
                config_snapshot={
                    "seed_peer_enabled": self.config.seed_peer_enabled,
                    "cluster_id": self.config.cluster_id,
                    "scheduling": {
                        "algorithm": self.config.scheduling.algorithm,
                        "candidate_parent_limit":
                            self.config.scheduling.candidate_parent_limit,
                        "retry_interval":
                            self.config.scheduling.retry_interval,
                        "stripe_min_slice_peers":
                            self.config.scheduling.stripe_min_slice_peers,
                    },
                    "gc": {"peer_ttl": gc.peer_ttl, "task_ttl": gc.task_ttl,
                           "host_ttl": gc.host_ttl},
                })
            if fc.straggler_filter:
                self.scheduling.wire_fleet(self.fleet)
        # Pod lens (pkg/podlens): per-host clock alignment from announce
        # round-trip samples + the bounded store of shipped flight
        # digests, merged on demand into /debug/pod/<task>/timeline.
        plc = self.config.podlens
        self.pod_lens: "podlenslib.PodLens | None" = None
        if plc.enabled:
            self.pod_lens = podlenslib.PodLens(
                max_tasks=plc.max_tasks,
                clock_estimator=podlenslib.ClockEstimator(
                    max_hosts=plc.clock_hosts))
        # SLO engine (pkg/slo): continuous burn rates over the fleet
        # time-series + pod completions, served at /debug/slo.
        self.slo: "slolib.SLOEngine | None" = None
        if plc.enabled and plc.slo_enabled:
            self.slo = slolib.SLOEngine(
                series=self.fleet.series if self.fleet else None,
                max_completions=plc.max_completions)
        # The tenant QoS plane: the per-tenant burn book, fed from
        # shipped flights. Always on, as in the JAX scheduler: a
        # breaching tenant's handouts narrow.
        self.tenant_burn = TenantBurnBook()
        self.scheduling.wire_qos(self.tenant_burn.throttled)
        self._tenant_admission_state: dict[str, str] = {}
        # Scheduler HA: the durable bounded snapshot of live task, peer
        # and host state, restored at construction
        # (scheduler/resource/snapshot.py).
        self.snapshot = None
        if self.config.ha.enabled:
            self.snapshot = SnapshotStore(
                self.config.ha.snapshot_db
                or self.config.persistent_cache_db)
            restored = self.restore_from_snapshot()
            if restored:
                log.info("state restored from snapshot", **restored)

    def manager_payload(self) -> dict:
        """What the scheduler's manager keepalive carries: the tenant burn
        snapshot, for the manager's job admission. (The JAX scheduler adds
        its cluster fleet frame; the port's manager has no cluster
        tower.)"""
        return self.tenant_burn_payload()

    def tenant_burn_payload(self) -> dict:
        """Keepalive piggyback for the manager's admission controller:
        {"tenant_burn": {tenant: {burn, state, completions}}}. Breach
        transitions (either direction) are recorded in the fleet decision
        log as ``admission`` decisions with the TENANT as subject —
        transition-only, so the log stays bounded while /debug/fleet/
        decisions?kind=admission shows when and why each tenant's jobs
        started (and stopped) being pushed back."""
        snap = self.tenant_burn.snapshot()
        for tenant, info in snap.items():
            prev = self._tenant_admission_state.get(tenant)
            state = info["state"]
            if state != prev and "breach" in (state, prev):
                if self.fleet is not None:
                    self.fleet.note_admission(
                        tenant,
                        decision="deny" if state == "breach" else "restore",
                        burn=info["burn"], source="burn_book")
            self._tenant_admission_state[tenant] = state
        return {"tenant_burn": snap}

    def _fleet_gauges(self) -> dict:
        """Gauge sample for the fleet time-series. O(hosts+peers+tasks)
        scans — called at bucket rotation (amortized once per bucket_s)
        and on /debug/fleet snapshots, never per event."""
        hc = self.hosts.counts()
        return {
            "hosts_total": hc["total"],
            "hosts_seed": hc["seed"],
            "hosts_quarantined": hc["quarantined"],
            "peers_running": sum(1 for p in self.peers.all()
                                 if not p.is_done()),
            "tasks_active": sum(1 for t in self.tasks.all()
                                if t.fsm.current == TaskState.RUNNING),
            "straggler_hosts": len(
                self.fleet.scorecards._stragglers) if self.fleet else 0,
        }

    # ------------------------------------------------------------------ #
    # HA: durable snapshot save/restore (scheduler/resource/snapshot.py)
    # ------------------------------------------------------------------ #

    def snapshot_flush(self) -> dict | None:
        """Write the bounded live-state snapshot (periodic GC-style task
        in scheduler/server.py + once at stop)."""
        if self.snapshot is None:
            return None
        ha = self.config.ha
        return self.snapshot.save(
            self.hosts.all(), self.tasks.all(), self.peers.all(),
            max_tasks=ha.max_tasks, max_peers=ha.max_peers)

    def restore_from_snapshot(self) -> dict | None:
        """Rebuild Host/Task/Peer objects from the snapshot rows. Piece
        metadata rebuilds through the SAME apply path live resume
        re-registration uses, so snapshot load and re-registration are one
        code path and converge by construction (property-tested)."""
        if self.snapshot is None:
            return None
        data = self.snapshot.load()
        if not data["peers"] and not data["tasks"]:
            return None
        for hw in data["hosts"]:
            host = self.hosts.load_or_store(
                Host(
                    hw.get("id", "unknown"),
                    hostname=hw.get("hostname", ""), ip=hw.get("ip", ""),
                    port=hw.get("port", 0),
                    upload_port=hw.get("upload_port", 0),
                    host_type=HostType(hw.get("type", 0)),
                    idc=hw.get("idc", ""), location=hw.get("location", ""),
                    tpu_slice=hw.get("tpu_slice", ""),
                    tpu_worker_index=hw.get("tpu_worker_index", -1),
                ))
            host.touch()
        for tr in data["tasks"]:
            task = self.tasks.load_or_store(Task(
                tr["task_id"], url=tr["url"], tag=tr["tag"],
                application=tr["application"], digest=tr["digest"],
                back_to_source_limit=self.config.scheduling.back_to_source_count,
                range_header=tr["range_header"],
            ))
            task.update_lengths(tr["content_length"], tr["piece_size"],
                                tr["total_piece_count"])
            task.fsm.restore(tr["state"])
        restored_peers = 0
        for pr in data["peers"]:
            task = self.tasks.load(pr["task_id"])
            host = self.hosts.load(pr["host_id"])
            if task is None or host is None:
                continue
            peer = self.peers.load_or_store(Peer(
                pr["peer_id"], task, host,
                is_seed=bool(pr["is_seed"]), priority=pr["priority"],
                range_header=pr["range_header"],
            ))
            peer.fsm.restore(pr["state"])
            peer.pod_broadcast = bool(pr["pod_broadcast"])
            self._apply_resume_pieces(task, peer, pr["piece_nums"])
            restored_peers += 1
            STATE_REBUILT_COUNT.labels("snapshot").inc()
        return {"hosts": len(data["hosts"]), "tasks": len(data["tasks"]),
                "peers": restored_peers}

    def _apply_resume_pieces(self, task: Task, peer: Peer,
                             piece_nums) -> int:
        """Idempotently install a re-announced landed-piece bitset: the
        peer's finished set plus task piece metadata computed from the
        task geometry (digests arrive via the idempotent re-report that
        follows — the duplicate path backfills them)."""
        added = 0
        ps = task.piece_size
        cl = task.content_length
        for num in piece_nums:
            num = int(num)
            if num in peer.finished_pieces:
                continue
            peer.finished_pieces.add(num)
            added += 1
            if ps > 0 and num not in task.pieces:
                offset = num * ps
                size = ps if cl < 0 else max(0, min(ps, cl - offset))
                task.store_piece(PieceInfo(
                    piece_num=num, range_start=offset, range_size=size))
        if added:
            peer.touch()
            task.touch()
        return added

    # ------------------------------------------------------------------ #
    # resource resolution (reference handleResource :1457)
    # ------------------------------------------------------------------ #

    def _resolve(self, open_body: dict) -> tuple[Host, Task, Peer]:
        h = open_body.get("host") or {}
        host = self.hosts.load_or_store(
            Host(
                h.get("id") or h.get("hostname", "unknown"),
                hostname=h.get("hostname", ""),
                ip=h.get("ip", ""),
                port=h.get("port", 0),
                upload_port=h.get("upload_port", 0),
                host_type=HostType(h.get("type", 0)),
                idc=h.get("idc", ""),
                location=h.get("location", ""),
                tpu_slice=h.get("tpu_slice", ""),
                tpu_worker_index=h.get("tpu_worker_index", -1),
            )
        )
        # Keep ports fresh: a daemon restart re-announces with new ports.
        host.port = h.get("port", host.port)
        host.upload_port = h.get("upload_port", host.upload_port)

        task_for_digest = self.tasks.load(open_body["task_id"])
        if (task_for_digest is not None and not task_for_digest.digest
                and open_body.get("digest")):
            # Backfill: a later registrant may know the content digest the
            # first one didn't — it guards the tiny inline-content cache.
            task_for_digest.digest = open_body["digest"]
        if (task_for_digest is not None and not task_for_digest.tenant
                and open_body.get("tenant")):
            # Same backfill posture for the QoS attribution tag: the first
            # registrant's tenant wins, later ones fill an empty slot.
            task_for_digest.tenant = open_body["tenant"]

        task = self.tasks.load_or_store(
            Task(
                open_body["task_id"],
                url=open_body.get("url", ""),
                tag=open_body.get("tag", ""),
                application=open_body.get("application", ""),
                digest=open_body.get("digest", ""),
                filtered_query_params=open_body.get("filters") or [],
                header=open_body.get("header") or {},
                back_to_source_limit=self.config.scheduling.back_to_source_count,
                range_header=open_body.get("range", ""),
                tenant=open_body.get("tenant", ""),
            )
        )
        stale = self.peers.load(open_body["peer_id"])
        if stale is not None and stale.fsm.current in (PeerState.FAILED,
                                                       PeerState.LEAVE):
            # Announce-stream recovery: the daemon's stream died mid-task
            # (scheduler restart, net blip) and _on_stream_gone failed the
            # peer. The SAME peer id re-registering is the conductor
            # reconnecting — replace the terminal record with a fresh one;
            # its completed pieces re-arrive via the recovery re-report
            # (idempotent application) so it becomes a usable parent again.
            self.peers.delete(stale.id)
            PEER_REREGISTER_COUNT.inc()
            if self.fleet is not None:
                self.fleet.note_register(reconnect=True)
            log.info("terminal peer re-registered", peer=stale.id[:24],
                     prior_state=stale.fsm.current)
        peer = self.peers.load_or_store(
            Peer(
                open_body["peer_id"],
                task,
                host,
                is_seed=bool(open_body.get("is_seed")),
                priority=open_body.get("priority", 3),
                range_header=open_body.get("range", ""),
                disable_back_source=bool(open_body.get("disable_back_source")),
            )
        )
        if open_body.get("pod_broadcast"):
            # Sticky across re-announces: once a peer declared the task a
            # pod broadcast it stays a stripe member until it leaves.
            peer.pod_broadcast = True
        return host, task, peer

    # ------------------------------------------------------------------ #
    # AnnouncePeer stream (reference service_v2.go:84)
    # ------------------------------------------------------------------ #

    async def announce_peer(self, stream: ServerStream, ctx: RpcContext) -> None:
        open_body = stream.open_body or {}
        if not open_body.get("task_id") or not open_body.get("peer_id"):
            raise DfError(Code.BadRequest, "task_id and peer_id required")
        host, task, peer = self._resolve(open_body)
        peer.announce_stream = stream
        if self.fleet is not None:
            self.fleet.note_register()
        log.info("announce peer", peer=peer.id[:24], task=task.id[:16],
                 host=host.id, seed=peer.is_seed)
        try:
            while True:
                msg = await stream.recv()
                if msg is None:
                    break
                await self._dispatch(msg, task, peer)
                if peer.is_done():
                    break
        finally:
            peer.announce_stream = None
            self._on_stream_gone(task, peer)

    async def _dispatch(self, msg: dict, task: Task, peer: Peer) -> None:
        kind = msg.get("type", "")
        if kind == "register":
            await self._handle_register(task, peer, msg)
        elif kind == "download_started":
            self._handle_download_started(msg, task, peer)
        elif kind == "piece_finished":
            self._handle_piece_finished(msg, task, peer)
        elif kind == "pieces_finished":
            self._handle_pieces_finished(msg, task, peer)
        elif kind == "piece_failed":
            self._handle_piece_failed(msg, task, peer)
        elif kind == "reschedule":
            await self._handle_reschedule(msg, task, peer)
        elif kind == "download_finished":
            self._handle_download_finished(msg, task, peer)
        elif kind == "download_failed":
            self._handle_download_failed(msg, task, peer)
        else:
            log.warning("unknown announce message", kind=kind, peer=peer.id[:24])

    # -- register (reference handleRegisterPeerRequest :991) --------------

    @staticmethod
    def _stamped(msg: dict) -> dict:
        """Every register/reschedule ANSWER carries the scheduler's
        anchored wall clock: the daemon brackets the round trip with its
        own t0/t1 stamps and the triple becomes a clock-alignment sample
        (pkg/podlens.ClockEstimator) shipped back inside the flight
        digest — no extra RPC, the announce stream IS the time source."""
        msg["sched_wall"] = flightlib.anchored_wall()
        # Capability negotiation rides the same piggyback: this flag
        # tells the conductor the scheduler decodes packed piece-report
        # batches and resume bitmaps (proto/reportcodec). The daemon
        # re-learns it from every reconnect answer, so failover to an
        # older scheduler downgrades the wire automatically.
        msg["packed_reports"] = True
        return msg

    async def _handle_register(self, task: Task, peer: Peer,
                               msg: dict | None = None) -> None:
        # Failover / restart re-registration: the register carries the
        # daemon's full resume state, or the peer object is a ghost this
        # scheduler restored from its snapshot (already RUNNING, stream
        # only now attached). Either way the peer holds landed bytes and
        # live parent sync streams — rebuild state and answer normal_task,
        # never demote it to origin.
        # Seeds stay on the reference path: a seed re-announcing a
        # complete store rides the need_back_source answer into the
        # conductor's announce-only fast path, which re-reports every
        # piece WITH digests — strictly more information than the bitset.
        resume = (msg or {}).get("resume")
        if (resume is not None and not peer.is_seed) \
                or peer.fsm.current in (PeerState.RUNNING,
                                        PeerState.BACK_TO_SOURCE):
            await self._handle_resume_register(task, peer, resume or {})
            return

        # Empty-content shortcut (reference registerEmptyTask).
        if task.content_length == 0:
            peer.fsm.event("register_empty")
            peer.fsm.event("download_succeeded")
            REGISTER_SCOPE_COUNT.labels("empty").inc()
            await peer.announce_stream.send(
                self._stamped({"type": "empty_task"}))
            return

        # Size-scope shortcuts (reference service_v1.go:885-996): once the
        # task has succeeded somewhere, tiny content is inlined in the
        # register response and single-piece tasks get one direct parent —
        # no announce-stream scheduling machinery for either.
        if not peer.is_seed and task.state == TaskState.SUCCEEDED:
            scope = task.size_scope()
            if (scope == SizeScope.TINY
                    and len(task.direct_piece) == task.content_length):
                if not self._verify_direct_piece(task, task.direct_piece):
                    # A newly-learned digest contradicts the cached inline
                    # content: drop the poisoned cache and fall through to
                    # normal registration (a fresh fetch re-verifies).
                    log.warning("cached tiny piece failed digest, dropped",
                                task=task.id[:16])
                    task.direct_piece = b""
                else:
                    peer.fsm.event("register_tiny")
                    peer.fsm.event("download_succeeded")
                    REGISTER_SCOPE_COUNT.labels("tiny").inc()
                    await peer.announce_stream.send(self._stamped({
                        "type": "tiny_task", "task": task.to_wire(),
                        "content": task.direct_piece}))
                    return
            if scope == SizeScope.SMALL and await self._register_small(task, peer):
                REGISTER_SCOPE_COUNT.labels("small").inc()
                return

        peer.fsm.event("register_normal")
        REGISTER_SCOPE_COUNT.labels("normal").inc()

        # Seed peers and solo first-comers go straight to origin; everyone
        # else gets parents (back-to-source dedup: ~1 origin fetch per task).
        if peer.is_seed:
            self._mark_task_running(task)
            self._to_back_source(task, peer, "seed peer registration")
            await peer.announce_stream.send(self._stamped(
                {"type": "need_back_source", "reason": "seed peer",
                 "task": task.to_wire()}))
            return

        seeding = False
        if task.fsm.current == TaskState.PENDING or not task.has_available_peer():
            seeding = await self._maybe_trigger_seed(task, peer)
            if not seeding:
                if peer.disable_back_source:
                    # The peer refuses origin; hold it in the schedule loop
                    # waiting for a parent to appear instead of demoting it.
                    await self._schedule_and_send(
                        task, peer,
                        patience=self.config.scheduling.no_source_patience)
                    return
                if task.can_back_to_source():
                    self._mark_task_running(task)
                    self._to_back_source(task, peer, "first peer, no seed")
                    await peer.announce_stream.send(self._stamped(
                        {"type": "need_back_source", "reason": "first peer",
                         "task": task.to_wire()}))
                    return
                # Out of back-source budget and nothing running: fail fast.
                self._fail_peer(peer)
                await peer.announce_stream.send(self._stamped(
                    {"type": "schedule_failed",
                     "reason": "no sources available"}))
                return

        # While a seed is actively fetching, hold the peer in the schedule
        # loop instead of demoting it to a redundant origin fetch.
        patience = 30.0 if seeding else 0.0
        await self._schedule_and_send(task, peer, patience=patience)

    async def _handle_resume_register(self, task: Task, peer: Peer,
                                      resume: dict) -> None:
        """Rebuild Task/Peer state from a resume-carrying re-registration
        (scheduler failover/restart — the server half of the conductor's
        announce recovery). The answer is ALWAYS normal_task: a peer that
        re-announced landed pieces is itself a parent candidate the pod
        needs, its remainder keeps flowing from the sync streams it never
        lost, and a back-source demotion here would re-fetch bytes the pod
        already holds. An empty parent list is fine — the conductor keeps
        its live parents, and membership-change pushes top it up as the
        rest of the pod re-registers."""
        task.update_lengths(
            resume.get("content_length", -1),
            resume.get("piece_size", 0),
            resume.get("total_piece_count", -1),
        )
        if resume.get("pod_broadcast"):
            peer.pod_broadcast = True
        piece_nums = resume.get("piece_nums")
        if not piece_nums and resume.get("piece_bitmap"):
            piece_nums = reportcodec.bitmap_to_nums(resume["piece_bitmap"])
        added = self._apply_resume_pieces(task, peer, piece_nums or [])
        # Fresh peers walk the normal register→download transitions; a
        # snapshot ghost is already RUNNING; a SUCCEEDED ghost whose
        # daemon says "still running" drops back to RUNNING — the daemon
        # is the authority on its own download state.
        for event in ("register_normal", "download"):
            if peer.fsm.can(event):
                peer.fsm.event(event)
        if peer.fsm.current not in (PeerState.RUNNING,
                                    PeerState.BACK_TO_SOURCE):
            peer.fsm.restore(PeerState.RUNNING)
        if task.fsm.current != TaskState.SUCCEEDED:
            # A resuming peer never demotes task-level success: SUCCEEDED
            # means the content is fully available somewhere, which one
            # peer's unfinished remainder does not contradict.
            self._mark_task_running(task)
        STATE_REBUILT_COUNT.labels("reregister").inc()
        if self.fleet is not None:
            self.fleet.note_register(reconnect=True)
        if added:
            # The re-announced pieces make this peer a usable parent NOW:
            # wake every schedule loop blocked on this task.
            task.notify_parents_changed()
        log.info("peer resume-registered", peer=peer.id[:24],
                 task=task.id[:16], pieces=len(peer.finished_pieces),
                 rebuilt=added)
        stream = peer.announce_stream
        if stream is None:
            return
        parents = self.scheduling.find_candidate_parents(peer)
        if parents:
            self.scheduling.reattach_peer(peer, parents)
        out = {"type": "normal_task", "task": task.to_wire(),
               "parents": [p.to_wire() for p in parents]}
        stripe = self._stripe_for(task, peer)
        peer.stripe = stripe
        if stripe is not None:
            out["stripe"] = stripe
            STRIPE_HANDOUT_COUNT.labels("striped").inc()
            if self.fleet is not None:
                self.fleet.note_stripe(task.id, peer.id, peer.host.id,
                                       reshuffle=False)
        await stream.send(self._stamped(out))
        if peer.host.tpu_slice:
            aio.spawn(self._push_stripe_updates(
                task, peer.host.tpu_slice, exclude=peer.id))

    async def _register_small(self, task: Task, peer: Peer) -> bool:
        """Single-piece shortcut (reference registerSmallTask :917): hand
        the registrant one SUCCEEDED parent plus piece 0's info so it can
        fetch the whole content with one upload-server GET. Returns False
        to fall through to normal registration."""
        piece = task.pieces.get(0)
        if piece is None:
            return False
        candidates = self.scheduling.find_candidate_parents(peer)
        parent = next((c for c in candidates
                       if c.state == PeerState.SUCCEEDED
                       and c.host.upload_port > 0), None)
        if parent is None:
            return False
        try:
            task.delete_peer_in_edges(peer.id)
            task.add_peer_edge(parent.id, peer.id)
            peer.fsm.event("register_small")
        except Exception:
            return False
        await peer.announce_stream.send(self._stamped({
            "type": "small_task", "task": task.to_wire(),
            "parent": parent.to_wire(), "piece": piece.to_wire()}))
        return True

    def _seed_active(self, task: Task) -> bool:
        # Via the task's seed index, not a full-DAG scan: this probe sits
        # inside every schedule loop iteration and seeds are usually zero.
        for pid in task.seed_peer_ids:
            p = task.load_peer(pid)
            if p is not None and p.is_seed and not p.is_done():
                return True
        return False

    async def _schedule_and_send(self, task: Task, peer: Peer, patience: float = 0.0) -> None:
        deadline = asyncio.get_running_loop().time() + patience
        seed_seen = False
        while True:
            active = self._seed_active(task)
            seed_seen = seed_seen or active
            # Hold while the (possibly still-registering) seed works; stop
            # holding once a seen seed is done/failed or patience runs out.
            hold = (asyncio.get_running_loop().time() < deadline
                    and (active or not seed_seen))
            result = await self.scheduling.schedule_candidate_parents(
                peer, allow_back_source=not hold and not peer.disable_back_source)
            if result.kind != ScheduleResult.FAILED or not hold:
                break
        stream = peer.announce_stream
        if stream is None:
            return
        if result.kind == ScheduleResult.CANDIDATES:
            for parent in result.parents:
                if not peer.host.tpu_slice or not parent.host.tpu_slice:
                    PARENT_PICK_COUNT.labels("unlabeled").inc()
                elif parent.host.tpu_slice == peer.host.tpu_slice:
                    PARENT_PICK_COUNT.labels("intra").inc()
                else:
                    PARENT_PICK_COUNT.labels("cross").inc()
            self.scheduling.reattach_peer(peer, result.parents)
            if peer.fsm.can("download"):
                peer.fsm.event("download")
            self._mark_task_running(task)
            msg = {
                "type": "normal_task",
                "task": task.to_wire(),
                "parents": [p.to_wire() for p in result.parents],
            }
            stripe = self._stripe_for(task, peer)
            peer.stripe = stripe
            if stripe is not None:
                msg["stripe"] = stripe
                STRIPE_HANDOUT_COUNT.labels("striped").inc()
                if self.fleet is not None:
                    self.fleet.note_stripe(task.id, peer.id, peer.host.id,
                                           reshuffle=False)
            await stream.send(self._stamped(msg))
            if peer.host.tpu_slice:
                # Membership may have just changed (this peer joined or
                # reshuffled): re-push differing stripe plans to the other
                # slice members so every host's wanted-set stays disjoint.
                aio.spawn(self._push_stripe_updates(
                    task, peer.host.tpu_slice, exclude=peer.id))
        elif result.kind == ScheduleResult.NEED_BACK_SOURCE:
            self._mark_task_running(task)
            self._to_back_source(task, peer, result.reason)
            await stream.send(self._stamped(
                {"type": "need_back_source", "reason": result.reason,
                 "task": task.to_wire()}))
        else:
            self._fail_peer(peer)
            if self.fleet is not None:
                self.fleet.note_schedule_failed(task.id, peer.id,
                                                peer.host.id, result.reason)
            await stream.send(self._stamped(
                {"type": "schedule_failed", "reason": result.reason}))

    # -- striped slice broadcast (scheduling/stripe.py) --------------------

    def _stripe_members(self, task: Task, slice_name: str) -> list[Peer]:
        """Alive broadcast peers of ``task`` on ``slice_name``. Succeeded
        peers stay members: they hold every piece, so keeping their rank
        costs nothing and spares a reshuffle per finisher; failed/left
        peers trigger the real reshuffle."""
        out = []
        for pid in task.slice_index.get(slice_name, ()):
            q = task.load_peer(pid)
            if q is None or q.fsm.current in (PeerState.FAILED,
                                              PeerState.LEAVE):
                continue
            out.append(q)
        auto = self.config.scheduling.stripe_min_slice_peers
        if 2 <= auto <= len(out):
            return out
        return [q for q in out if q.pod_broadcast]

    def _stripe_for(self, task: Task, peer: Peer) -> dict | None:
        """This peer's stripe plan, or None (unstriped fallback). Ranged
        tasks never stripe — the range already narrows the byte window,
        and mod-S piece ownership over a slice-relative grid would differ
        per range."""
        if not peer.host.tpu_slice or peer.range_header or peer.is_seed:
            return None
        members = self._stripe_members(task, peer.host.tpu_slice)
        if peer not in members:
            return None
        plan = stripe_mod.plan_stripe(
            [stripe_mod.member_key(q.host.tpu_worker_index, q.host.id, q.id)
             for q in members], peer.id)
        if plan is None:
            return None
        # Mates ride a dedicated channel, NOT the parent DAG: intra-slice
        # exchange is mutual (A serves B's stripe while B serves A's),
        # which the acyclic parent DAG cannot express — and ICI transfers
        # don't consume NIC upload slots, so DAG upload accounting would
        # mis-bill them anyway.
        plan["slice"] = peer.host.tpu_slice
        plan["mates"] = [q.to_wire() for q in members
                         if q.id != peer.id and q.host.upload_port > 0]
        return plan

    async def _push_stripe_updates(self, task: Task, slice_name: str,
                                   exclude: str = "") -> None:
        """Membership changed (join, death, reshuffle): push differing
        stripe plans to the slice's live members over their announce
        streams. Parents refresh too — a new mate should also enter the
        DCN candidate picture where the DAG allows it."""
        for pid in list(task.slice_index.get(slice_name, ())):
            if pid == exclude:
                continue
            q = task.load_peer(pid)
            if (q is None or q.announce_stream is None or q.is_done()
                    or q.fsm.current == PeerState.BACK_TO_SOURCE):
                continue
            stripe = self._stripe_for(task, q)
            if stripe == q.stripe:
                continue
            q.stripe = stripe
            msg = {"type": "normal_task", "task": task.to_wire(),
                   "parents": []}
            if stripe is not None:
                msg["stripe"] = stripe
            parents = self.scheduling.find_candidate_parents(q)
            if parents:
                self.scheduling.reattach_peer(q, parents)
                msg["parents"] = [p.to_wire() for p in parents]
            try:
                await q.announce_stream.send(msg)
                STRIPE_HANDOUT_COUNT.labels("reshuffle").inc()
                if self.fleet is not None:
                    self.fleet.note_stripe(task.id, q.id, q.host.id,
                                           reshuffle=True)
            except Exception:
                # A dying stream reaps through _on_stream_gone; the push
                # is best-effort by design.
                pass

    def _mark_task_running(self, task: Task) -> None:
        if task.fsm.can("download"):
            task.fsm.event("download")

    def _to_back_source(self, task: Task, peer: Peer, reason: str) -> None:
        if peer.fsm.can("download_back_to_source"):
            peer.fsm.event("download_back_to_source")
            task.back_to_source_peers.add(peer.id)
            if self.fleet is not None:
                self.fleet.note_back_source(task.id, peer.id, peer.host.id,
                                            reason)
            # A back-sourcing peer is a valid candidate parent from this
            # instant (the sync stream pushes pieces as they land) — wake
            # blocked schedule loops now, not at its first piece report.
            task.notify_parents_changed()
            log.info("peer going back-to-source", peer=peer.id[:24], reason=reason)

    def _fail_peer(self, peer: Peer) -> None:
        if peer.fsm.can("download_failed"):
            peer.fsm.event("download_failed")

    # -- seed triggering (reference downloadTaskBySeedPeer :1504) ----------

    async def _maybe_trigger_seed(self, task: Task, requesting_peer: Peer) -> bool:
        """Pick the least-loaded live seed host and trigger a seed download.
        Returns True if a seed is (already) seeding this task."""
        if not self.config.seed_peer_enabled:
            return False
        # Already seeding?
        if self._seed_active(task):
            return True
        seeds = [h for h in self.hosts.all() if h.is_seed() and h.port > 0]
        if not seeds:
            return False
        seeds.sort(key=lambda h: len(h.peer_ids))
        seed_host = seeds[0]
        ok = await self.seed_clients.trigger_download_task(
            seed_host,
            {
                "task_id": task.id,
                "url": task.url,
                "tag": task.tag,
                "application": task.application,
                "digest": task.digest,
                "filters": task.filtered_query_params,
                "header": task.header,
                "range": task.range_header,
                "tenant": task.tenant,
                "priority": requesting_peer.priority,
            },
        )
        if ok:
            self._mark_task_running(task)
            log.info("triggered seed download", task=task.id[:16], seed=seed_host.id)
        return ok

    # -- piece reports (reference :1291-1455) ------------------------------

    def _handle_download_started(self, msg: dict, task: Task, peer: Peer) -> None:
        task.update_lengths(
            msg.get("content_length", -1),
            msg.get("piece_size", 0),
            msg.get("total_piece_count", -1),
        )

    def _handle_piece_finished(self, msg: dict, task: Task, peer: Peer) -> None:
        REPORT_BATCH_COUNT.labels("dict").inc()
        INGEST_BATCH_PIECES.observe(1)
        self._apply_piece_finished(msg.get("piece") or {}, task, peer)

    def _apply_piece_finished(self, p: dict, task: Task, peer: Peer) -> None:
        num = p["piece_num"]
        if num in peer.finished_pieces:
            # Duplicate report: the client's flush restores a popped batch
            # on cancellation even when the send hit the wire (at-least-once
            # delivery), so application must be idempotent — a re-send must
            # not re-count the parent's upload or duplicate cost samples.
            # Checked on the raw dict BEFORE any PieceInfo construction:
            # this runs once per piece per peer across the whole pod.
            # Resume-rebuilt piece metadata has no digest (the bitset is
            # numbers-only); the idempotent re-report that follows a
            # re-registration is where the digest arrives — backfill it.
            info = task.pieces.get(num)
            if info is not None and not info.digest and p.get("digest"):
                info.digest = p["digest"]
            peer.touch()
            return
        first_piece = not peer.finished_pieces
        peer.add_finished_piece(num, p.get("download_cost_ms", 0))
        self.pod_flight.note_piece(task.id, peer.host.id,
                                   p.get("timings"),
                                   p.get("download_cost_ms", 0))
        if num not in task.pieces:
            # Construct piece metadata only for the first reporter; every
            # later peer re-reporting the same piece skips the allocation.
            task.store_piece(PieceInfo.from_wire(p))
        task.touch()
        if first_piece:
            # The peer just became a usable parent: wake schedule loops
            # instead of letting them poll out their retry interval.
            task.notify_parents_changed()
        parent_id = p.get("dst_peer_id", "")
        parent = self.peers.load(parent_id) if parent_id else None
        if parent is not None:
            parent.host.upload_count += 1
            parent.touch()
        if self.fleet is not None:
            cost = p.get("download_cost_ms", 0)
            col = fleetlib.C_BYTES_UNLABELED
            parent_host = None
            if parent is not None:
                parent_host = parent.host.id
                if peer.host.tpu_slice and parent.host.tpu_slice:
                    col = (fleetlib.C_BYTES_INTRA
                           if parent.host.tpu_slice == peer.host.tpu_slice
                           else fleetlib.C_BYTES_CROSS)
            self.fleet.note_piece(peer.host.id, col,
                                  p.get("range_size", 0), cost,
                                  parent_host, p.get("timings"))

    def _handle_pieces_finished(self, msg: dict, task: Task, peer: Peer) -> None:
        """Coalesced batch (clients flush reports on a short window);
        semantics identical to N piece_finished in order. Two wire forms
        arrive here: the negotiated packed batch (proto/reportcodec —
        decoded by the backend ladder in one call, applied in bulk) and
        the legacy per-piece dict list. Both land the exact same FSM
        state; the wire bench asserts it byte for byte."""
        packed = msg.get("packed")
        if packed is not None:
            try:
                batch = reportcodec.decode_packed(packed)
            except reportcodec.CodecError as e:
                # Malformed packed body: drop the batch, keep the stream.
                # Reports are delivered at-least-once (the conductor
                # restores unsent batches and recovery re-reports all
                # pieces), so dropping never loses state permanently.
                log.warning("malformed packed piece report dropped",
                            peer=peer.id[:24], error=str(e))
                return
            REPORT_BATCH_COUNT.labels("packed").inc()
            INGEST_BATCH_PIECES.observe(batch.n)
            self._apply_packed_batch(batch, task, peer)
            return
        pieces = msg.get("pieces") or []
        REPORT_BATCH_COUNT.labels("dict").inc()
        INGEST_BATCH_PIECES.observe(len(pieces))
        self._apply_piece_dicts(pieces, task, peer)

    def _apply_packed_batch(self, batch, task: Task, peer: Peer) -> None:
        """Bulk-apply a decoded packed batch: set-level dup check, one
        piece_costs extend, one PodAggregator feed, one upload-count step
        per distinct parent — Python cost per BATCH, not per piece. Eligible
        only when every piece is new to this peer (the overwhelmingly
        common case — dup re-delivery happens on flush-restore races and
        recovery re-reports); anything else bridges to the dict walk,
        whose per-piece dup handling is the reference semantics."""
        nums = batch.nums
        nums_set = set(nums)
        if len(nums_set) != batch.n \
                or not peer.finished_pieces.isdisjoint(nums_set):
            self._apply_piece_dicts(batch.to_dicts(), task, peer)
            return
        was_empty = not peer.finished_pieces
        peer.finished_pieces.update(nums_set)
        costs = batch.costs
        if batch.min_cost > 0:
            peer.piece_costs.extend(costs)
        elif batch.cost_total:
            peer.piece_costs.extend(c for c in costs if c > 0)
        self.pod_flight.note_pieces(task.id, peer.host.id, batch.n,
                                    batch.phase_ms)
        # Subset probe first: in the steady state every piece is already
        # stored (the first reporter paid that), and <= on a keys view
        # costs one C-level membership sweep with no result-set build.
        missing = (() if nums_set <= task.pieces.keys()
                   else nums_set.difference(task.pieces.keys()))
        if missing:
            starts, sizes, peer_idx, peers = (
                batch.starts, batch.sizes, batch.peer_idx, batch.peers)
            for i, num in enumerate(nums):
                if num in missing:
                    task.store_piece(PieceInfo(
                        piece_num=num, range_start=starts[i],
                        range_size=sizes[i], digest=batch.digest(i),
                        download_cost_ms=costs[i],
                        dst_peer_id=peers[peer_idx[i]]))
        peer.touch()
        task.touch()
        if was_empty and peer.finished_pieces:
            task.notify_parents_changed()
        by_parent_host: dict[str, list] = {}
        my_slice = peer.host.tpu_slice
        for pidx, (k, cost_sum, nbytes) in enumerate(batch.parent_aggs):
            if not k:
                continue
            parent_id = batch.peers[pidx]
            parent = self.peers.load(parent_id) if parent_id else None
            host_key = ""
            col = fleetlib.C_BYTES_UNLABELED
            if parent is not None:
                parent.host.upload_count += k
                parent.touch()
                host_key = parent.host.id
                if my_slice and parent.host.tpu_slice:
                    col = (fleetlib.C_BYTES_INTRA
                           if parent.host.tpu_slice == my_slice
                           else fleetlib.C_BYTES_CROSS)
            entry = by_parent_host.get(host_key)
            if entry is None:
                by_parent_host[host_key] = [k, cost_sum, nbytes, col]
            else:
                entry[0] += k
                entry[1] += cost_sum
                entry[2] += nbytes
        if self.fleet is not None and batch.n:
            self.fleet.note_pieces(peer.host.id, batch.n, batch.cost_total,
                                   by_parent=by_parent_host)

    def _apply_piece_dicts(self, pieces: list, task: Task, peer: Peer) -> None:
        """The reference per-piece walk: the per-batch bookkeeping — task
        touch, parent-availability wakeup, parent upload accounting and
        registry lookups — runs once per batch (or once per distinct
        parent) instead of once per piece. This is the scheduler's
        hottest ingest path: a 1024-host fan-out delivers ~hosts x pieces
        of these."""
        was_empty = not peer.finished_pieces
        # Per-parent aggregation: one registry lookup, one upload-count
        # update, and ONE fleet serve-EWMA step per DISTINCT parent per
        # batch (not per piece) — this is the scheduler's hottest ingest
        # path and the observatory must ride it at batch granularity.
        parent_aggs: dict[str, list] = {}   # pid -> [count, cost_sum, bytes]
        landed = 0
        cost_total = 0
        for p in pieces:
            num = p["piece_num"]
            if num in peer.finished_pieces:
                # Idempotent re-delivery (see _apply_piece_finished) —
                # digest backfill for resume-rebuilt piece metadata.
                info = task.pieces.get(num)
                if info is not None and not info.digest and p.get("digest"):
                    info.digest = p["digest"]
                continue
            cost = p.get("download_cost_ms", 0)
            peer.add_finished_piece(num, cost)
            self.pod_flight.note_piece(task.id, peer.host.id,
                                       p.get("timings"), cost)
            if num not in task.pieces:
                task.store_piece(PieceInfo.from_wire(p))
            landed += 1
            cost_total += cost
            agg = parent_aggs.get(p.get("dst_peer_id", ""))
            if agg is None:
                agg = parent_aggs[p.get("dst_peer_id", "")] = [0, 0, 0]
            agg[0] += 1
            agg[1] += cost
            agg[2] += p.get("range_size", 0)
        peer.touch()
        task.touch()
        if was_empty and peer.finished_pieces:
            task.notify_parents_changed()
        by_parent_host: dict[str, list] = {}
        my_slice = peer.host.tpu_slice
        for parent_id, (k, cost_sum, nbytes) in parent_aggs.items():
            parent = self.peers.load(parent_id) if parent_id else None
            host_key = ""
            col = fleetlib.C_BYTES_UNLABELED
            if parent is not None:
                parent.host.upload_count += k
                parent.touch()
                host_key = parent.host.id
                if my_slice and parent.host.tpu_slice:
                    col = (fleetlib.C_BYTES_INTRA
                           if parent.host.tpu_slice == my_slice
                           else fleetlib.C_BYTES_CROSS)
            entry = by_parent_host.get(host_key)
            if entry is None:
                by_parent_host[host_key] = [k, cost_sum, nbytes, col]
            else:
                entry[0] += k
                entry[1] += cost_sum
                entry[2] += nbytes
        if self.fleet is not None and landed:
            self.fleet.note_pieces(peer.host.id, landed, cost_total,
                                   by_parent=by_parent_host)

    def _handle_piece_failed(self, msg: dict, task: Task, peer: Peer) -> None:
        parent_id = msg.get("parent_id", "")
        if parent_id:
            # Transient failures (429 throttle, size mismatch) only dent the
            # upload stats; permanent ones blocklist the parent for this peer.
            if not msg.get("temporary"):
                peer.block_parents.add(parent_id)
            parent = self.peers.load(parent_id)
            if parent is not None:
                parent.host.upload_count += 1
                parent.host.upload_failed_count += 1
                # Typed reason → pod-wide demotion: enough reason-weighted
                # strikes (corrupt bytes tip in one) quarantine the HOST,
                # filtering it from every peer's candidate set — not just
                # this reporter's blocklist.
                reason = msg.get("reason", "")
                if reason:
                    # Straggler attribution: the failure counts against
                    # the PARENT host that served (or failed to serve).
                    self.pod_flight.note_failure(task.id, parent.host.id,
                                                 reason)
                    if self.fleet is not None:
                        self.fleet.note_piece_failed(parent.host.id, reason)
                if reason and parent.host.note_served_bad(reason):
                    PARENT_DEMOTION_COUNT.labels(reason).inc()
                    self.pod_flight.note_quarantine(task.id, parent.host.id,
                                                    reason)
                    if self.fleet is not None:
                        self.fleet.note_quarantine(task.id, parent.host.id,
                                                   reason,
                                                   reporter=peer.id)
                    log.warning("parent host quarantined",
                                host=parent.host.id, reason=reason,
                                reporter=peer.id[:24])
                    task.notify_parents_changed()

    # -- reschedule (reference :1157 handleRescheduleRequest) --------------

    async def _handle_reschedule(self, msg: dict, task: Task, peer: Peer) -> None:
        peer.reschedule_count += 1
        for pid in msg.get("blocklist") or []:
            peer.block_parents.add(pid)
        task.delete_peer_in_edges(peer.id)
        # The dropped edges freed upload slots on the old parents.
        task.notify_parents_changed()
        patience = 30.0 if self._seed_active(task) else 0.0
        await self._schedule_and_send(task, peer, patience=patience)

    # -- completion (reference :1180/:1236) --------------------------------

    def _note_shipped_flight(self, msg: dict, task: Task,
                             peer: Peer) -> None:
        """Flight shipping ingest: the terminal announce message carries
        the daemon's bounded flight digest (pkg/flight.digest). The pod
        lens stores it (and its clock samples) for the merged timeline;
        the SLO engine and the tenant burn book book its completion
        SLIs."""
        fl = msg.get("flight")
        if not isinstance(fl, dict):
            return
        if self.pod_lens is not None:
            self.pod_lens.note_flight(task.id, peer.host.id, fl,
                                      peer_id=peer.id)
        if fl.get("state") != "failed" \
                and msg.get("type", "download_finished") \
                != "download_failed":
            makespan, ttfb, stall_frac = podlenslib.completion_stats(fl)
            if makespan > 0:
                if self.slo is not None:
                    self.slo.note_completion(peer.host.id, makespan,
                                             ttfb_s=ttfb,
                                             stall_frac=stall_frac)
                # The same completion, attributed to the task's tenant.
                self.tenant_burn.note_completion(task.tenant, makespan,
                                                ttfb_s=ttfb,
                                                stall_frac=stall_frac)

    def _handle_download_finished(self, msg: dict, task: Task, peer: Peer) -> None:
        self._note_shipped_flight(msg, task, peer)
        if peer.state == PeerState.SUCCEEDED:
            return  # tiny-register peers are marked succeeded up front
        try:
            peer.fsm.event("download_succeeded")
        except TransitionError:
            log.warning("download_finished in bad state", state=peer.state)
            return
        task.update_lengths(
            msg.get("content_length", task.content_length),
            msg.get("piece_size", task.piece_size),
            msg.get("total_piece_count", task.total_piece_count),
        )
        # Detach from parents: the finished peer downloads nothing anymore, so
        # its parents' upload slots must come back (it stays in the DAG as a
        # parent candidate via its own out-edges).
        try:
            task.delete_peer_in_edges(peer.id)
        except Exception:
            pass
        if task.fsm.can("download_succeeded"):
            task.fsm.event("download_succeeded")
        # Finished peer = SUCCEEDED parent + freed upload slots on its old
        # parents: both change candidacy for waiting schedule loops.
        task.notify_parents_changed()
        log.info("peer finished", peer=peer.id[:24], task=task.id[:16])
        # Tiny tasks: pull the content off the finisher's upload server so
        # later registrants get it inlined (reference service_v1.go:1196-1210
        # fills Task.DirectPiece the same way).
        if (task.size_scope() == SizeScope.TINY and not task.direct_piece
                and peer.host.upload_port > 0):
            aio.spawn(self._fetch_direct_piece(task, peer))
        # Persistent-cache replica bookkeeping: a replication download that
        # finished becomes a durable replica row (reference service_v2.go
        # persistent cache peer state handling).
        if self.persistent.get_task(task.id) is not None:
            self.persistent.upsert_peer(peer.id, task.id, peer.host.id,
                                        state=pc.STATE_SUCCEEDED)
            self.persistent.upsert_host(
                peer.host.id, hostname=peer.host.hostname, ip=peer.host.ip,
                port=peer.host.port, upload_port=peer.host.upload_port)

    def _handle_download_failed(self, msg: dict, task: Task, peer: Peer) -> None:
        # The failure's flight digest still merges into the pod timeline
        # (a failed host is exactly the one an operator wants on the
        # picture); it books no SLO completion.
        self._note_shipped_flight(msg, task, peer)
        self._fail_peer(peer)
        # Task fails only when nothing is still making progress.
        still_running = any(
            not p.is_done() and p.id != peer.id for p in task.peers()
        )
        if not still_running and task.fsm.can("download_failed"):
            task.fsm.event("download_failed")

    def _on_stream_gone(self, task: Task, peer: Peer) -> None:
        """Stream dropped: a running peer that vanished must not stay a
        parent candidate (reference: peer leave → DAG edge deletion)."""
        if not peer.is_done():
            self._fail_peer(peer)
        if peer.fsm.current in (PeerState.FAILED, PeerState.LEAVE):
            try:
                task.delete_peer_out_edges(peer.id)
                task.delete_peer_in_edges(peer.id)
            except Exception:
                pass
            if peer.host.tpu_slice and (peer.pod_broadcast or peer.stripe):
                # Slice peer death: surviving members reshuffle to S-1
                # stripes (a lone survivor gets no stripe field and falls
                # back to the unstriped path).
                aio.spawn(self._push_stripe_updates(
                    task, peer.host.tpu_slice, exclude=peer.id))

    # ------------------------------------------------------------------ #
    # unary RPCs
    # ------------------------------------------------------------------ #

    async def announce_host(self, body: dict, ctx: RpcContext) -> dict:
        """Periodic host announcement (reference AnnounceHost :460)."""
        h = body or {}
        host = self.hosts.load_or_store(
            Host(
                h.get("id", "unknown"),
                hostname=h.get("hostname", ""),
                ip=h.get("ip", ""),
                port=h.get("port", 0),
                upload_port=h.get("upload_port", 0),
                host_type=HostType(h.get("type", 0)),
                idc=h.get("idc", ""),
                location=h.get("location", ""),
                tpu_slice=h.get("tpu_slice", ""),
                tpu_worker_index=h.get("tpu_worker_index", -1),
            )
        )
        host.port = h.get("port", host.port)
        host.upload_port = h.get("upload_port", host.upload_port)
        if self.fleet is not None:
            self.fleet.note_announce()
        # Clock alignment: the previous announce's round-trip sample
        # (daemon t0/t1 bracketing our echoed sched_wall) feeds the pod
        # lens's per-host offset estimate.
        clock = h.get("clock")
        if self.pod_lens is not None and isinstance(clock, dict):
            self.pod_lens.clock.add_sample(
                host.id, float(clock.get("t0", 0.0)),
                float(clock.get("t1", 0.0)), float(clock.get("echo", 0.0)))
        tel = h.get("telemetry") or {}
        for k, v in tel.items():
            if hasattr(host.telemetry, k):
                setattr(host.telemetry, k, v)
        host.touch()
        resp: dict = {"ok": True, "sched_wall": flightlib.anchored_wall()}
        # The subject host's fleet-wide standing rides back so the daemon
        # can embed it into post-mortem bundles.
        if self.fleet is not None:
            s = self.fleet.scorecards._hosts.get(host.id)
            if s is not None:
                resp["scorecard"] = {
                    "serve_ewma_ms": round(s.serve_ewma_ms, 2),
                    "serve_samples": s.serve_samples,
                    "down_ewma_ms": round(s.down_ewma_ms, 2),
                    "down_samples": s.down_samples,
                    "uploads": round(s.uploads, 1),
                    "failures": {r: round(v, 2)
                                 for r, v in s.failures.items()},
                    "straggler":
                        self.fleet.scorecards.is_straggler(host.id),
                    "zscore": self.fleet.scorecards.zscore(host.id),
                }
        return resp

    async def leave_host(self, body: dict, ctx: RpcContext) -> dict:
        """Host shutdown (reference LeaveHost :641): fail its peers, drop it."""
        host_id = (body or {}).get("id", "")
        host = self.hosts.load(host_id)
        if host is None:
            return {"ok": False}
        for pid in list(host.peer_ids):
            peer = self.peers.load(pid)
            if peer is not None:
                if peer.fsm.can("leave"):
                    peer.fsm.event("leave")
                self.peers.delete(pid)
        self.hosts.delete(host_id)
        # A departing host takes its persistent replicas with it; restore
        # the replica count elsewhere (reference: persistentcache host GC
        # + reschedule).
        affected = self.persistent.delete_peers_of_host(host_id)
        self.persistent.delete_host(host_id)
        for task_id in affected:
            aio.spawn(self._ensure_replicas(task_id))
        return {"ok": True}

    async def leave_peer(self, body: dict, ctx: RpcContext) -> dict:
        peer_id = (body or {}).get("id", "")
        peer = self.peers.load(peer_id)
        if peer is None:
            return {"ok": False}
        if peer.fsm.can("leave"):
            peer.fsm.event("leave")
        self.peers.delete(peer_id)
        return {"ok": True}

    # ------------------------------------------------------------------ #
    # persistent cache task family (reference service_v2.go:1580-1895)
    # ------------------------------------------------------------------ #

    async def upload_persistent_cache_task_started(self, body: dict,
                                                   ctx: RpcContext) -> dict:
        """An uploader begins importing a persistent cache task
        (reference :1726 UploadPersistentCacheTaskStarted)."""
        task_id = body.get("task_id", "")
        if not task_id:
            raise DfError(Code.BadRequest, "task_id required")
        h = body.get("host") or {}
        host_id = h.get("id") or h.get("hostname", "unknown")
        self.persistent.upsert_host(
            host_id, hostname=h.get("hostname", ""), ip=h.get("ip", ""),
            port=h.get("port", 0), upload_port=h.get("upload_port", 0))
        self.persistent.upsert_task(
            task_id, url=body.get("url", ""), tag=body.get("tag", ""),
            application=body.get("application", ""),
            piece_size=body.get("piece_size", 0),
            content_length=body.get("content_length", -1),
            total_piece_count=body.get("total_piece_count", -1),
            replica_count=max(1, int(body.get("replica_count", 1))),
            ttl=float(body.get("ttl", 0)),
            digest=body.get("digest", ""),
            state=pc.STATE_UPLOADING)
        self.persistent.upsert_peer(body.get("peer_id", ""), task_id, host_id,
                                    state=pc.STATE_UPLOADING)
        return {"ok": True}

    async def upload_persistent_cache_task_finished(self, body: dict,
                                                    ctx: RpcContext) -> dict:
        """Uploader finished; record the first replica and fan replication
        triggers until replica_count is met (reference :1791 Finished +
        the replica scheduling the Redis resource drives)."""
        task_id = body.get("task_id", "")
        task = self.persistent.get_task(task_id)
        if task is None:
            raise DfError(Code.PeerTaskNotFound, f"persistent task {task_id} unknown")
        self.persistent.upsert_task(
            task_id, state=pc.STATE_SUCCEEDED,
            content_length=body.get("content_length", task["content_length"]),
            piece_size=body.get("piece_size", task["piece_size"]),
            total_piece_count=body.get("total_piece_count",
                                       task["total_piece_count"]))
        h = body.get("host") or {}
        host_id = h.get("id") or h.get("hostname", "unknown")
        self.persistent.upsert_peer(body.get("peer_id", ""), task_id, host_id,
                                    state=pc.STATE_SUCCEEDED)
        # Replication runs in the background: N trigger RPCs (10s timeout
        # each, possibly against dead hosts) must not stall — or fail — the
        # uploader's Finished ack.
        aio.spawn(self._ensure_replicas(task_id))
        return {"ok": True}

    async def upload_persistent_cache_task_failed(self, body: dict,
                                                  ctx: RpcContext) -> dict:
        """Upload failed: drop the half-registered task (reference :1855) —
        but a failed RE-import of a task with live replicas must not erase
        the healthy replica bookkeeping."""
        task_id = body.get("task_id", "")
        if self.persistent.replica_count(task_id) > 0:
            self.persistent.upsert_task(task_id, state=pc.STATE_SUCCEEDED)
            self.persistent.delete_peer_if_not_succeeded(
                body.get("peer_id", ""))
        else:
            self.persistent.delete_task(task_id)
        return {"ok": True}

    async def stat_persistent_cache_task(self, body: dict,
                                         ctx: RpcContext) -> dict:
        wire = self.persistent.task_wire((body or {}).get("task_id", ""))
        if wire is None:
            raise DfError(Code.PeerTaskNotFound, "persistent task not found")
        return wire

    async def list_persistent_cache_tasks(self, body: dict,
                                          ctx: RpcContext) -> dict:
        return {"tasks": [self.persistent.task_wire(t["task_id"])
                          for t in self.persistent.list_tasks()]}

    async def delete_persistent_cache_task(self, body: dict,
                                           ctx: RpcContext) -> dict:
        """Remove the task everywhere: fan Peer.DeleteTask to every holder,
        then drop the rows (reference DeletePersistentCacheTask)."""
        task_id = (body or {}).get("task_id", "")
        deleted, failed = [], []
        for p in self.persistent.peers_of(task_id):
            host = self._persistent_host(p["host_id"])
            if host is None:
                continue
            ok = await self.seed_clients.delete_task(host, task_id)
            (deleted if ok else failed).append(p["host_id"])
        self.persistent.delete_task(task_id)
        self.tasks.delete(task_id)
        return {"ok": not failed, "deleted": deleted, "failed": failed}

    def _persistent_host(self, host_id: str):
        """Address a persistent host via the live resource if announced,
        else the durable snapshot (scheduler restarted since)."""
        host = self.hosts.load(host_id)
        if host is not None and host.port > 0:
            return host
        row = self.persistent.get_host(host_id)
        if row is None or not row["port"]:
            return None
        return Host(row["host_id"], hostname=row["hostname"], ip=row["ip"],
                    port=row["port"], upload_port=row["upload_port"])

    async def _ensure_replicas(self, task_id: str) -> int:
        """Fan download triggers to hosts without a replica until the
        desired count is met. Returns the number of triggers fired."""
        task = self.persistent.get_task(task_id)
        if task is None or task["state"] != "succeeded":
            return 0
        have = {p["host_id"] for p in self.persistent.peers_of(task_id)}
        want = task["replica_count"] - len(have)
        if want <= 0:
            return 0
        candidates = [h for h in self.hosts.all()
                      if h.port > 0 and h.id not in have]
        candidates.sort(key=lambda h: len(h.peer_ids))
        spec = {
            "task_id": task_id, "url": task["url"], "tag": task["tag"],
            "application": task["application"],
            "digest": task["digest"],     # end-to-end verify on replicas
            # Replicas PULL from peers; dfcache:// has no origin.
            "seed": False, "disable_back_source": True,
        }
        fired = 0
        for host in candidates[:want]:
            if await self.seed_clients.trigger_download_task(host, spec):
                fired += 1
                log.info("replication triggered", task=task_id[:16],
                         host=host.id)
        return fired

    async def _fetch_direct_piece(self, task: Task, peer: Peer) -> None:
        """Download a tiny task's whole content (<= 128 B) from the
        finished peer's upload server into ``task.direct_piece``: the JAX
        fetch's URL, 10 s timeout and digest check, on ``http.client`` on
        a worker thread."""
        query = urllib.parse.urlencode({"peerId": peer.id, "pieceNum": "0"})
        path = f"/download/{task.id[:3]}/{task.id}?{query}"
        try:
            data = await asyncio.to_thread(
                _http_get, peer.host.ip, peer.host.upload_port, path, 10.0)
        except (OSError, http.client.HTTPException):
            return
        if data is None:
            return
        if len(data) != task.content_length:
            return
        # Verify against the reported piece-0 digest (or the whole-task
        # digest) before caching: a corrupt or malicious finisher must not
        # poison the inlined content for every later registrant.
        if not self._verify_direct_piece(task, data):
            log.warning("tiny direct piece digest mismatch, not cached",
                        task=task.id[:16], peer=peer.id[:16])
            return
        task.direct_piece = data
        log.info("tiny direct piece cached", task=task.id[:16],
                 size=len(data))

    @staticmethod
    def _verify_direct_piece(task: Task, data: bytes) -> bool:
        """True iff ``data`` matches every digest the task has on record
        (piece 0's digest and/or the task content digest)."""
        expectations = []
        piece = task.pieces.get(0)
        if piece is not None and piece.digest:
            expectations.append(piece.digest)
        if task.digest:
            expectations.append(task.digest)
        for value in expectations:
            try:
                expected = dfdigest.parse(value)
            except dfdigest.InvalidDigestError:
                return False
            if dfdigest.hash_bytes(expected.algorithm, data) != expected:
                return False
        # No digest on record: accept (nothing to verify against), matching
        # the reference's behavior for digest-less tasks.
        return True

    async def announce_task(self, body: dict, ctx: RpcContext) -> dict:
        """A daemon announces an already-complete local task (dfcache import,
        persisted stores after restart) so it becomes a parent candidate —
        reference service_v1.go:331 AnnounceTask."""
        host, task, peer = self._resolve(body)
        task.update_lengths(
            body.get("content_length", task.content_length),
            body.get("piece_size", task.piece_size),
            body.get("total_piece_count", task.total_piece_count),
        )
        # Same apply path as resume re-registration and snapshot restore:
        # the bitset also rebuilds task piece metadata, so all three
        # reconstruction routes converge on one Task state.
        self._apply_resume_pieces(task, peer, body.get("piece_nums") or [])
        for event in ("register_normal", "download", "download_succeeded"):
            if peer.fsm.can(event):
                peer.fsm.event(event)
        if task.fsm.can("download"):
            task.fsm.event("download")
        if task.fsm.can("download_succeeded"):
            task.fsm.event("download_succeeded")
        # A complete local task just became a parent candidate.
        task.notify_parents_changed()
        log.info("task announced", task=task.id[:16], host=host.id,
                 pieces=len(peer.finished_pieces))
        return {"ok": True}

    async def stat_task(self, body: dict, ctx: RpcContext) -> dict:
        task = self.tasks.load((body or {}).get("task_id", ""))
        if task is None:
            raise DfError(Code.PeerTaskNotFound, "task not found")
        return task.to_wire()

    async def stat_peer(self, body: dict, ctx: RpcContext) -> dict:
        peer = self.peers.load((body or {}).get("peer_id", ""))
        if peer is None:
            raise DfError(Code.SchedPeerNotFound, "peer not found")
        return peer.to_wire()

    async def list_hosts(self, body: dict, ctx: RpcContext) -> dict:
        return {"hosts": [h.to_wire() for h in self.hosts.all()]}

    # ------------------------------------------------------------------ #
    # pod lens: merged cross-host timeline
    # ------------------------------------------------------------------ #

    async def pod_timeline_report(self, task_id: str) -> "dict | None":
        """The merged cross-host timeline: the digests daemons shipped
        on completion, topped up with bounded on-demand
        ``Daemon.FlightReport`` pulls for task participants that never
        shipped one. Pulled digests merge but are not retained."""
        if self.pod_lens is None:
            return None
        extra: dict = {}
        task = self.tasks.load(task_id)
        budget = self.config.podlens.pull_missing
        if task is not None and budget > 0:
            shipped = self.pod_lens.shipped_hosts(task_id)
            missing: dict = {}
            for p in task.peers():
                h = p.host
                if h.id not in shipped and h.id not in missing and h.port > 0:
                    missing[h.id] = h
            for host_id, host in list(missing.items())[:budget]:
                d = await self.seed_clients.flight_digest(host, task_id)
                if isinstance(d, dict):
                    extra[host_id] = d
        return self.pod_lens.timeline(task_id, extra=extra)

    async def pod_timeline(self, body: dict, ctx: RpcContext) -> dict:
        """Unary surface for ``dfget --pod`` (``Daemon.PodTimeline``
        proxies here): the merged timeline and its text waterfall, the
        renderer ``/debug/pod/<task_id>/timeline?format=text`` uses."""
        task_id = (body or {}).get("task_id", "")
        report = await self.pod_timeline_report(task_id)
        if report is None:
            raise DfError(Code.PeerTaskNotFound,
                          f"no shipped flight digests for task {task_id}")
        return {"report": report,
                "text": podlenslib.render_timeline(report)}

    # ------------------------------------------------------------------ #
    # GC
    # ------------------------------------------------------------------ #

    def gc(self) -> dict:
        expired = self.persistent.expired_tasks()
        for task in expired:
            aio.spawn(self.delete_persistent_cache_task(
                {"task_id": task["task_id"]}, None))
        # Replication repair: a trigger whose download later failed never
        # created a peer row, so re-check every succeeded task each GC pass
        # and top up under-replicated ones (_ensure_replicas no-ops at
        # quota).
        expired_ids = {t["task_id"] for t in expired}
        for task in self.persistent.list_tasks(state="succeeded"):
            if (task["task_id"] not in expired_ids
                    and self.persistent.replica_count(task["task_id"])
                    < task["replica_count"]):
                aio.spawn(self._ensure_replicas(task["task_id"]))
        return {
            "peers": len(self.peers.gc()),
            "tasks": len(self.tasks.gc()),
            "hosts": len(self.hosts.gc()),
            "persistent_tasks": len(expired),
        }


def _http_get(ip: str, port: int, path: str, timeout: float) -> "bytes | None":
    """One GET on a fresh connection; the body on 200 or 206 (upload
    servers serve pieces as ranges), else None."""
    conn = http.client.HTTPConnection(ip, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        return data if resp.status in (200, 206) else None
    finally:
        conn.close()
