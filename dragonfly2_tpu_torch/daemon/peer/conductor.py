"""Peer task conductor, which runs one P2P download: the port's copy of
``dragonfly2_tpu/daemon/peer/conductor.py``.

``run()`` registers on the scheduler's AnnouncePeer stream and acts on the
answer:

  empty_task        → an empty content, finished
  tiny_task         → the content inlined in the answer
  small_task        → piece 0 straight from the one parent named
  need_back_source  → ``PieceManager.download_source``, reporting pieces
  normal_task       → sync the parents' piece maps, run the piece workers
                      (one ranged GET a run of contiguous pieces, else one
                      GET a piece), report each piece, reschedule when
                      starved
  schedule_failed   → fails the task

A scheduler unreachable at registration demotes the task to
back-to-source (unless that is disabled). After registration a receive
loop applies pushed parent sets and demotions; a stream lost mid-download
is reopened on the ring (failover, re-registration with the landed pieces,
re-reports), and only a spent reconnect budget demotes the rest to
back-to-source. A child that pulled every piece against a done parent's
digests waits, bounded, for that parent's certification, so its
completion re-hash can be skipped (``_await_certification``).

Every move stamps the task's flight (``pkg/flight``): register and the
answer, pushes, reschedules, reconnects, stripes, back-to-source, each
piece landed or failed, quarantine entries. Each piece report carries the
flight's ``timings`` for it, and the terminal message (``download_finished``
/ ``download_failed``) the task's flight digest with the clock samples of
the register and reconnect answers that echoed the scheduler's
``sched_wall``. A piece failure penalizes its parent in the daemon-wide
quarantine (``pkg/quarantine``, keyed by ``parent_key``), counted in
``peer_parent_quarantine_total{reason}`` when it tips the parent over.
When a stamped answer says ``packed_reports``, report batches go packed
(``proto/reportcodec``, the dict list when the encoder refuses a batch)
and a resume of 16 pieces or more goes as a bitmap when it is no more
than twice the list's length; every register or reconnect answer renews
the flag, so a failover to a scheduler without it goes back to the dict
forms.

With ``wfq`` (the daemon's ``qos.WFQGate``) every piece worker takes a
slot of the gate, in its priority's dispatch class, for each request it
issues.

``conductor_factory`` builds the task manager's conductor factory, as the
JAX ``Daemon._make_conductor`` does: the daemon (``daemon/daemon.py``)
gives it the config's worker count, report batch, ``seed_peer`` and,
with ``qos.enabled``, the gate.
"""

from __future__ import annotations

import asyncio
from collections import deque

from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import (
    PieceAssignment,
    PieceDispatcher,
    parent_key,
)
from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
    PieceDownloader,
    failure_reason,
    is_parent_gone,
    pull_one_piece,
)
from dragonfly2_tpu_torch.daemon.peer.synchronizer import (
    PieceTaskSynchronizer,
)
from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg import retry as retrylib
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import PieceInfo, Range, compute_piece_count
from dragonfly2_tpu_torch.pkg.ratelimit import Limiter
from dragonfly2_tpu_torch.proto import reportcodec
from dragonfly2_tpu_torch.qos import normalize_tenant
from dragonfly2_tpu_torch.rpc import codec
from dragonfly2_tpu_torch.storage.local_store import LocalTaskStore

log = dflog.get("peer.conductor")

PIECE_DOWNLOAD_COUNT = metrics.counter(
    "peer_piece_download_total", "P2P piece downloads", ("result",))
BACK_SOURCE_COUNT = metrics.counter(
    "peer_back_source_total", "Tasks that fell back to origin")
PIECE_FAIL_REASON = metrics.counter(
    "peer_piece_failures_total",
    "P2P piece failures by typed reason code", ("reason",))
PARENT_QUARANTINE_COUNT = metrics.counter(
    "peer_parent_quarantine_total",
    "Parents entering the daemon-wide quarantine, by tipping reason",
    ("reason",))
ANNOUNCE_RECONNECT_COUNT = metrics.counter(
    "peer_announce_reconnects_total",
    "Mid-download announce-stream recovery attempts", ("result",))
PIECE_BYTES = metrics.counter(
    "peer_piece_bytes_total",
    "P2P piece bytes downloaded, by parent ICI locality",
    ("locality",))
ANNOUNCE_BYTES = metrics.counter(
    "peer_announce_bytes_total",
    "Serialized announce-stream traffic with the scheduler, by direction "
    "(sent = reports/registers, recv = schedule pushes and answers)",
    ("direction",))

MAX_RESCHEDULES = 8
# The defaults of the piece workers a P2P pull runs and of the most piece
# reports one pieces_finished message carries (the daemon's config sets
# them: download.parent_concurrency and download.report_batch).
PIECE_WORKERS = 4
REPORT_BATCH = 32
# One ranged GET covers up to this many contiguous pieces a parent holds
# (availability decides the real run lengths).
SPAN_MAX_PIECES = 8

class PeerTaskConductor:
    def __init__(
        self,
        *,
        task_id: str,
        peer_id: str,
        url: str,
        store: LocalTaskStore,
        scheduler_client,
        piece_manager,
        host_info: dict,
        meta: dict | None = None,
        is_seed: bool = False,
        piece_parallelism: int = PIECE_WORKERS,
        limiter: Limiter | None = None,
        on_piece=None,
        disable_back_source: bool = False,
        local_range_source=None,
        quarantine=None,
        flight=None,
        report_batch: int = REPORT_BATCH,
        wfq=None,
    ):
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        self.store = store
        self.scheduler_client = scheduler_client
        self.piece_manager = piece_manager
        self.host_info = host_info
        self.meta = meta or {}
        # A seed trigger's task, or any task of a daemon configured as a
        # seed peer, registers as a seed's.
        self.is_seed = is_seed
        self.piece_parallelism = piece_parallelism
        # The cap of a coalesced pieces_finished message: idle traffic
        # still flushes single reports at once, a backlog grows batches
        # toward it and a recovery re-report drains in messages of it.
        self.report_batch = max(1, int(report_batch))
        self.limiter = limiter or Limiter()
        self.on_piece = on_piece
        self.disable_back_source = disable_back_source
        # async (store, on_piece) -> bool: fill a ranged store from a LOCAL
        # covering parent task instead of the origin.
        self.local_range_source = local_range_source
        # A ranged task's content is its slice, and a back-to-source
        # demotion fetches exactly it; derived from meta["range"] (also
        # what registers with the scheduler) so the two cannot disagree.
        range_header = self.meta.get("range", "")
        self.content_range = (Range.parse_http(range_header)
                              if range_header else None)
        # The daemon-wide parent quarantine (the task manager's), or None.
        self.quarantine = quarantine
        # This task's flight: the task manager's recorder's, else the
        # process-wide recorder's.
        self.flight = flight if flight is not None \
            else flightlib.for_task(task_id)
        # [t0, t1, sched_wall] of the answers that echoed the scheduler's
        # clock, on this host's anchored wall clock (at most 4).
        self._clock_samples: list = []
        self.dispatcher = PieceDispatcher(quarantine=quarantine,
                                          flight=self.flight)
        self.downloader = PieceDownloader()
        # Every upstream piece request carries the task's tenant tag.
        self.tenant = normalize_tenant(self.meta.get("tenant"))
        # The daemon's QoS gate (``qos.WFQGate``), shared by every task's
        # piece workers, or None; a request's class is its priority's.
        self.wfq = wfq
        self._qos_priority = int(self.meta.get("priority", 3) or 3)
        self.synchronizer: PieceTaskSynchronizer | None = None
        # This host's slice, which labels pulled bytes by parent locality.
        self.own_slice = (host_info or {}).get("tpu_slice", "") or ""
        self._stream = None
        self._reschedules = 0
        self._from_p2p = False
        self._report_lock = asyncio.Lock()
        self._resched_lock = asyncio.Lock()
        self._sched_update = asyncio.Event()   # the receive loop applied a push
        self._need_back_source = False
        # Piece reports coalesce into pieces_finished batches: the first
        # flushes at once (the scheduler's "peer became a usable parent"
        # wake-up must not lag), later ones within the flush window share
        # a message, up to report_batch.
        self._pending_reports: deque = deque()
        self._flush_task: asyncio.Task | None = None
        self._last_flush = 0.0
        # The scheduler takes packed reports and resume bitmaps: learned
        # from each stamped register or reconnect answer.
        self._packed_ok = False
        # Announce-stream recovery: the register body kept for
        # re-registration, the reconnect lock, and the terminal flag that
        # stops recovery racing teardown.
        self._open_body: dict | None = None
        self._announce_lock = asyncio.Lock()
        self._announce_done = False
        self._stream_reconnects = 0
        # Set when a ring rebuild moved the task to another live member:
        # the next reconnect books result="rehomed".
        self._rehome_pending = False

    # ------------------------------------------------------------------ #

    async def run(self) -> None:
        """Complete the task into self.store, or raise DfError."""
        open_body = {
            "host": self.host_info,
            "peer_id": self.peer_id,
            "task_id": self.task_id,
            "url": self.url,
            "tag": self.meta.get("tag", ""),
            "application": self.meta.get("application", ""),
            "digest": self.meta.get("digest", ""),
            "filters": self.meta.get("filters") or [],
            "header": self.meta.get("header") or {},
            "priority": self.meta.get("priority", 3),
            "tenant": self.meta.get("tenant", ""),
            "range": self.meta.get("range", ""),
            "is_seed": self.is_seed,
            "disable_back_source": self.disable_back_source,
            "pod_broadcast": bool(self.meta.get("pod_broadcast")),
        }
        self._open_body = open_body
        # Registration: a transport failure before the scheduler answers
        # (refused, connect-then-drop, silence) demotes to back-to-source
        # instead of failing the task; a schedule_failed ANSWER stays
        # fatal (the dispatch below).
        watch = getattr(self.scheduler_client, "watch_ring", None)
        if watch is not None:
            watch(self.task_id, self._on_ring_change)
        msg = None
        register_error = "scheduler closed stream at register"
        self.flight.record(flightlib.EV_REGISTER)
        t0_clock = self.flight.wall_now()
        try:
            self._stream = await self.scheduler_client.open_announce_stream(
                open_body)
            reg: dict = {"type": "register"}
            if self.store.metadata.pieces:
                # A partial store (a restart): the scheduler rebuilds this
                # peer's state instead of treating it as fresh.
                reg["resume"] = self._resume_state()
            await self._stream.send(reg)
            msg = await self._stream.recv(timeout=60.0)
            self._note_clock_sample(t0_clock, msg)
        except DfError as e:
            if self.disable_back_source:
                await self._teardown()
                raise
            register_error = str(e)
        if msg is None:
            self.flight.record(flightlib.EV_SCHEDULED, -1, 0.0, "unavailable")
            if self.disable_back_source:
                await self._teardown()
                raise DfError(Code.SchedError,
                              "scheduler unavailable at register")
            log.warning("scheduler unavailable at register; "
                        "degrading to back-to-source",
                        task=self.task_id[:16], error=register_error)
            try:
                await self._back_source()
            finally:
                await self._teardown()
            return
        self.flight.record(flightlib.EV_SCHEDULED, -1, 0.0,
                           str(msg.get("type", "")))
        try:
            await self._dispatch_schedule(msg)
        except BaseException:
            await self._safe_send({"type": "download_failed"})
            raise
        finally:
            await self._teardown()

    async def _dispatch_schedule(self, msg: dict) -> None:
        """Act on the scheduler's answer to a register or reschedule."""
        kind = msg.get("type")
        if kind == "empty_task":
            await self._finish_empty()
        elif kind == "tiny_task":
            await self._finish_tiny(msg)
        elif kind == "small_task":
            await self._finish_small(msg)
        elif kind == "need_back_source":
            await self._back_source()
        elif kind == "normal_task":
            await self._pull_pieces_p2p(msg)
        elif kind == "schedule_failed":
            raise DfError(Code.SchedError, msg.get("reason", "schedule failed"))
        else:
            raise DfError(Code.SchedError,
                          f"unexpected scheduler response {kind}")

    @property
    def from_p2p(self) -> bool:
        return self._from_p2p

    # -- empty, tiny, small --------------------------------------------------

    async def _finish_empty(self) -> None:
        self.store.update_task(content_length=0, total_piece_count=0,
                               piece_size=1)
        await self._safe_send({"type": "download_finished",
                               "content_length": 0})

    async def _finish_tiny(self, msg: dict) -> None:
        """The scheduler inlined the whole content in its answer."""
        content = bytes(msg.get("content") or b"")
        self._from_p2p = True
        self.store.update_task(content_length=len(content),
                               piece_size=max(len(content), 1),
                               total_piece_count=1)
        if 0 not in self.store.metadata.pieces:
            self.store.write_piece(0, content)
        await self._safe_send({"type": "download_finished",
                               "content_length": len(content),
                               "piece_size": max(len(content), 1),
                               "total_piece_count": 1})

    async def _finish_small(self, msg: dict) -> None:
        """One direct parent and piece 0's info: one upload-server GET."""
        task_wire = msg.get("task") or {}
        parent = msg.get("parent") or {}
        piece = PieceInfo.from_wire(msg.get("piece") or {})
        host = parent.get("host") or {}
        self._apply_task_meta(task_wire)
        try:
            if piece.piece_num not in self.store.metadata.pieces:
                chunks, size, cost_ms, received_digest = \
                    await self.downloader.download_piece(
                        host.get("ip", ""), host.get("upload_port", 0),
                        self.task_id, piece.piece_num,
                        src_peer_id=parent.get("id", ""),
                        expected_size=piece.range_size,
                        expected_digest=piece.digest)
                await self.limiter.wait(size)
                rec = self.store.write_piece_chunks(
                    piece.piece_num, chunks, received_digest,
                    expected_digest=piece.digest, cost_ms=cost_ms)
                self.flight.record(flightlib.EV_LANDED, piece.piece_num,
                                   float(cost_ms))
                await self._report_piece(rec, parent_id=parent.get("id", ""))
                if self.on_piece is not None:
                    await self.on_piece(self.store, rec)
            self._from_p2p = True
            await self._safe_send({
                "type": "download_finished",
                "content_length": self.store.metadata.content_length,
                "piece_size": self.store.metadata.piece_size,
                "total_piece_count": self.store.metadata.total_piece_count,
            })
        except DfError as e:
            # The parent handed out was bad: ask for a reschedule and act
            # on whatever the scheduler answers.
            log.warning("small-task direct pull failed, rescheduling",
                        task=self.task_id[:16], error=str(e))
            await self._safe_send({"type": "reschedule",
                                   "blocklist": [parent.get("id", "")]})
            nxt = await self._stream.recv(timeout=60.0)
            if nxt is None:
                raise DfError(Code.SchedError,
                              "scheduler closed stream after small-task retry")
            if nxt.get("type") == "small_task":
                # No ping-pong between bad small parents.
                raise DfError(Code.ClientPieceDownloadFail,
                              "small-task retry returned another direct parent")
            await self._dispatch_schedule(nxt)

    # -- back-to-source ------------------------------------------------------

    async def _back_source(self) -> None:
        self.flight.record(flightlib.EV_BACK_SOURCE)
        # Content already complete locally (a seed re-announcing after a
        # scheduler restart): report the pieces, no origin request.
        if self.store.metadata.done and self.store.is_complete():
            m = self.store.metadata
            await self._safe_send({
                "type": "download_started",
                "content_length": m.content_length,
                "piece_size": m.piece_size,
                "total_piece_count": m.total_piece_count,
            })
            for rec in self.store.get_pieces():
                await self._report_piece(rec, parent_id="")
            await self._safe_send({
                "type": "download_finished",
                "content_length": m.content_length,
                "piece_size": m.piece_size,
                "total_piece_count": m.total_piece_count,
            })
            return

        started_sent = False

        async def on_piece(store: LocalTaskStore, rec) -> None:
            nonlocal started_sent
            if not started_sent and store.metadata.piece_size > 0:
                started_sent = True
                await self._safe_send({
                    "type": "download_started",
                    "content_length": store.metadata.content_length,
                    "piece_size": store.metadata.piece_size,
                    "total_piece_count": store.metadata.total_piece_count,
                })
            await self._report_piece(rec, parent_id="")
            if self.on_piece is not None:
                await self.on_piece(store, rec)

        # A ranged slice a LOCAL parent store covers imports warm. Not a
        # back-to-source: it runs before the disable gate and is neither
        # counted nor logged as one.
        imported = (self.content_range is not None
                    and self.local_range_source is not None
                    and await self.local_range_source(self.store, on_piece))
        if not imported:
            if self.disable_back_source:
                raise DfError(Code.ClientBackSourceError,
                              "scheduler demanded back-to-source but it "
                              "is disabled")
            BACK_SOURCE_COUNT.inc()
            log.info("back-to-source", task=self.task_id[:16],
                     seed=self.is_seed)
            if LocalTaskStore.completion_digest_applies(
                    self.meta.get("digest", ""),
                    self.content_range is not None):
                # Self-computed pieces are never certifiable: the
                # completion re-hash is certain; overlap it.
                self.store.start_prefix_hasher(self.meta.get("digest", ""))
            await self.piece_manager.download_source(
                self.store, self.url, self.meta.get("header") or {},
                content_range=self.content_range,
                on_piece=on_piece, limiter=self.limiter,
            )
        await self._safe_send({
            "type": "download_finished",
            "content_length": self.store.metadata.content_length,
            "piece_size": self.store.metadata.piece_size,
            "total_piece_count": self.store.metadata.total_piece_count,
        })

    # -- the P2P pull --------------------------------------------------------

    async def _pull_pieces_p2p(self, schedule_msg: dict) -> None:
        self._from_p2p = True
        self._apply_task_meta(schedule_msg.get("task") or {})
        # Dead parents need no hook here: the synchronizer's drop_parent
        # blocks them, and the next starvation pass sends them in the
        # reschedule blocklist.
        self.synchronizer = PieceTaskSynchronizer(
            self.task_id, self.peer_id, self.dispatcher,
            own_slice=self.own_slice)
        self.synchronizer.sync_parents(schedule_msg.get("parents") or [])
        self._apply_stripe(schedule_msg.get("stripe"))
        # Pieces already on disk need no download.
        self.dispatcher.mark_known_downloaded(
            self.store.metadata.pieces.keys())

        receiver = asyncio.ensure_future(self._receive_scheduler_loop())
        workers = [asyncio.ensure_future(self._piece_worker(i))
                   for i in range(self.piece_parallelism)]
        try:
            try:
                await asyncio.gather(*workers)
            except BaseException:
                # The first failure cancels the siblings before teardown.
                for w in workers:
                    w.cancel()
                await asyncio.gather(*workers, return_exceptions=True)
                raise
            if self._need_back_source and not self._complete():
                # Demoted mid-flight: the rest from the origin (pieces on
                # disk are skipped).
                await self._back_source()
                return
            if not self._complete():
                raise DfError(Code.ClientPieceDownloadFail,
                              f"p2p download stalled at "
                              f"{self.dispatcher.downloaded_count()} pieces")
            # A done parent's digest map may certify the completion re-hash
            # skip; every done parent's map is tried, and the bounded wait
            # goes on while none certifies yet.
            await self._await_certification()
            await self._safe_send({
                "type": "download_finished",
                "content_length": self.store.metadata.content_length,
                "piece_size": self.store.metadata.piece_size,
                "total_piece_count": self.store.metadata.total_piece_count,
            })
        finally:
            receiver.cancel()

    async def _await_certification(self) -> bool:
        """The cold race: a child's last pieces land moments before its
        parent's completion gate passes (a seed validates the whole
        content before its sync streams say done), so without a wait each
        child would re-hash the whole content. Waiting, bounded near the
        break-even point, turns N children's hashing into the seed's one
        validation. ``store.apply_certification`` decides; only a map that
        certifies ends the wait. True when one was installed."""
        if not LocalTaskStore.completion_digest_applies(
                self.meta.get("digest", ""), self.content_range is not None):
            return False  # no completion re-hash would run
        content = self.store.metadata.content_length
        if content <= 0:
            return False
        if not self.store.pieces_verified_against_digests():
            # A piece landed unchecked against any advertised digest: no
            # map can ever certify, so waiting is futile.
            return False
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self._cert_wait_bound(content)
        disp = self.dispatcher
        while disp.pending_certifiers():
            remaining = deadline - loop.time()
            if remaining <= 0:
                break  # a done at the deadline still gets the last try
            disp.certified_event.clear()
            if self.store.apply_certification(disp.certified_digest_maps()):
                return True
            try:
                await asyncio.wait_for(disp.certified_event.wait(), remaining)
            except asyncio.TimeoutError:
                break
        return self.store.apply_certification(disp.certified_digest_maps())

    @staticmethod
    def _cert_wait_bound(content_length: int) -> float:
        """The wait's budget: 50 ms for a done to propagate plus twice a
        ~1 GB/s hash of the content, at most 3 s. The alternative to
        waiting is N children hashing at once on shared cores, so the
        worst case (no done arrives) loses about the hash's cost."""
        return min(3.0, 0.05 + 2 * content_length / 1.0e9)

    def _note_clock_sample(self, t0: float, msg: "dict | None") -> None:
        """A register or reconnect answer: its bytes counted, the packed
        capability renewed, and, when it echoed the scheduler's
        ``sched_wall``, a clock sample (t0/t1 bracket the round trip, so
        the midpoint's error is at most (t1 - t0) / 2)."""
        if not msg:
            return
        self._note_recv(msg)
        self._packed_ok = bool(msg.get("packed_reports"))
        echo = msg.get("sched_wall")
        if not isinstance(echo, (int, float)) or echo <= 0:
            return
        self._clock_samples.append(
            (t0, self.flight.wall_now(), float(echo)))
        del self._clock_samples[:-4]

    def _apply_stripe(self, stripe: dict | None) -> None:
        """Enter, reshuffle or leave stripe mode from a scheduler answer.
        The plan's mates are synced like parents, marked same_slice, so
        pieces outside this host's stripe fill from them."""
        if stripe and int(stripe.get("slice_size", 0)) >= 2:
            self.flight.record(flightlib.EV_STRIPE, -1,
                               float(stripe["slice_size"]), "applied")
            self.dispatcher.set_stripe(int(stripe["slice_size"]),
                                       int(stripe.get("slice_rank", -1)))
            mates = stripe.get("mates") or []
            if mates and self.synchronizer is not None:
                self.synchronizer.sync_parents(mates)
            log.info("stripe plan applied", task=self.task_id[:16],
                     slice_size=stripe["slice_size"],
                     slice_rank=stripe.get("slice_rank"), mates=len(mates))
        else:
            if self.dispatcher.stripe is not None:
                self.flight.record(flightlib.EV_STRIPE, -1, 0.0, "cleared")
            self.dispatcher.clear_stripe()

    def _note_piece_failure(self, parent, err: DfError) -> str:
        """Classify a piece failure, count it and penalize the parent in
        the daemon-wide quarantine; the reason goes to the scheduler."""
        reason = failure_reason(err)
        PIECE_FAIL_REASON.labels(reason).inc()
        if self.quarantine is not None:
            if self.quarantine.penalize(parent_key(parent), reason):
                PARENT_QUARANTINE_COUNT.labels(reason).inc()
                self.flight.record(
                    flightlib.EV_QUARANTINE, -1, 0.0,
                    f"{parent_key(parent)}|{reason}")
                log.warning("parent quarantined",
                            parent=parent.peer_id[:24],
                            endpoint=parent_key(parent), reason=reason,
                            task=self.task_id[:16])
                self.dispatcher._wakeup.set()
        return reason

    def _parent_locality(self, parent) -> str:
        if not self.own_slice or not parent.tpu_slice:
            return "unlabeled"
        if parent.same_slice or parent.tpu_slice == self.own_slice:
            return "intra"
        return "cross"

    def _note_piece_bytes(self, parent, size: int) -> None:
        if size <= 0:
            return
        PIECE_BYTES.labels(self._parent_locality(parent)).inc(size)

    def _apply_task_meta(self, task_wire: dict) -> None:
        cl = task_wire.get("content_length", -1)
        ps = task_wire.get("piece_size", 0)
        tp = task_wire.get("total_piece_count", -1)
        if cl >= 0 and ps > 0 and tp < 0:
            tp = compute_piece_count(cl, ps)
        self.store.update_task(content_length=cl if cl >= 0 else None,
                               piece_size=ps if ps > 0 else None,
                               total_piece_count=tp if tp >= 0 else None)
        self.dispatcher.content_length = self.store.metadata.content_length
        self.dispatcher.piece_size = self.store.metadata.piece_size
        if self.store.metadata.total_piece_count >= 0:
            self.dispatcher.total_piece_count = \
                self.store.metadata.total_piece_count

    def _complete(self) -> bool:
        m = self.store.metadata
        if m.total_piece_count < 0 and self.dispatcher.total_piece_count >= 0:
            self.store.update_task(
                total_piece_count=self.dispatcher.total_piece_count,
                content_length=self.dispatcher.content_length
                if self.dispatcher.content_length >= 0 else None,
                piece_size=self.dispatcher.piece_size
                if self.dispatcher.piece_size > 0 else None,
            )
        return m.total_piece_count >= 0 and self.store.is_complete()

    async def _receive_scheduler_loop(self) -> None:
        """The one reader of the scheduler stream after registration:
        applies pushed parent sets and demotions. A stream lost
        mid-download is not terminal: the workers keep pulling from their
        parents while this loop reconnects (ring failover, re-register
        with the landed pieces, re-report); only a spent reconnect budget
        demotes to back-to-source."""
        try:
            while True:
                try:
                    msg = await self._stream.recv()
                except DfError:
                    msg = None   # stream lost: the same recovery as a close
                if msg is None:
                    if self._announce_done or self._complete():
                        return
                    if await self._recover_announce_stream():
                        continue
                    self._degrade_after_scheduler_loss()
                    return
                self._note_recv(msg)
                kind = msg.get("type")
                self.flight.record(flightlib.EV_SCHED_PUSH, -1, 0.0,
                                   str(kind))
                if kind == "normal_task":
                    self._apply_task_meta(msg.get("task") or {})
                    if self.synchronizer is not None:
                        self.synchronizer.sync_parents(
                            msg.get("parents") or [])
                    self._apply_stripe(msg.get("stripe"))
                    self._sched_update.set()
                elif kind in ("need_back_source", "schedule_failed"):
                    if kind == "need_back_source":
                        self._need_back_source = True
                    # drop_parent wakes both the workers and a completion
                    # wait that can now never be certified.
                    for pid in list(self.dispatcher.parents):
                        self.dispatcher.drop_parent(pid)
                    self._sched_update.set()
        except asyncio.CancelledError:
            pass

    # Announce-stream recovery: attempts per disruption (with the ANNOUNCE
    # backoff a few seconds in all, enough for a scheduler restart), and
    # the task-lifetime cap, so a flapping scheduler cannot hold the
    # receiver in a reconnect loop.
    RECONNECT_BUDGET = 4
    MAX_STREAM_RECONNECTS = 8

    def _resume_state(self) -> dict:
        """The task's local state for a (re-)register: the landed pieces,
        the geometry, the content digest once complete, the stripe and the
        pod-broadcast flag. A failover member or a restarted scheduler
        rebuilds this peer from it."""
        m = self.store.metadata
        nums = sorted(m.pieces.keys())
        resume: dict = {
            "piece_nums": nums,
            "content_length": m.content_length,
            "piece_size": m.piece_size,
            "total_piece_count": m.total_piece_count,
            "prefix_digest": m.digest or "",
            "pod_broadcast": bool(self.meta.get("pod_broadcast")),
        }
        if self._packed_ok and len(nums) >= 16:
            # The negotiated bitmap, one bit a piece; a sparse set stays a
            # list (the density gate).
            bitmap = reportcodec.nums_to_bitmap(nums)
            if len(bitmap) <= 2 * len(nums):
                resume["piece_bitmap"] = bitmap
                resume["piece_nums"] = []
        stripe = self.dispatcher.stripe
        if stripe is not None:
            resume["stripe"] = {"slice_size": stripe[0],
                                "slice_rank": stripe[1]}
        return resume

    def _on_ring_change(self, new_owner: str) -> None:
        """The scheduler client's ring-rebuild callback: the task moved to
        another live member. Flush the reports to the old member, close
        the stream, and let the receive loop's recovery reconnect on the
        rebuilt ring with the resume state."""
        if self._announce_done:
            return
        self._rehome_pending = True
        log.info("task ownership moved; re-homing announce stream",
                 task=self.task_id[:16], new_owner=new_owner)
        asyncio.ensure_future(self._rehome())

    async def _rehome(self) -> None:
        try:
            await self._flush_reports()
        except Exception:
            pass  # the stream is dying: recovery re-reports anyway
        stream = self._stream
        if stream is not None and not stream.closed:
            await stream.close()

    def _degrade_after_scheduler_loss(self) -> None:
        """The reconnect budget is spent: with the origin allowed the
        workers hand the rest to back-to-source (landed pieces kept);
        without it they ride out their parents and fail by starvation if
        those run dry."""
        log.warning("announce stream unrecoverable; degrading",
                    task=self.task_id[:16],
                    back_source=not self.disable_back_source)
        if not self.disable_back_source:
            self._need_back_source = True
            for pid in list(self.dispatcher.parents):
                self.dispatcher.drop_parent(pid)
        self._sched_update.set()

    async def _recover_announce_stream(self) -> bool:
        """Reopen the announce stream (ring failover is the scheduler
        client's), re-register, re-report the landed pieces, flush the
        buffered reports. False when the budget is spent or the scheduler
        rejected the peer."""
        async with self._announce_lock:
            if self._announce_done:
                return False
            if self._stream is not None and not self._stream.closed:
                return True   # a racing caller already recovered it
            if self._stream_reconnects >= self.MAX_STREAM_RECONNECTS:
                ANNOUNCE_RECONNECT_COUNT.labels("exhausted").inc()
                return False
            policy = retrylib.ANNOUNCE
            for attempt in range(self.RECONNECT_BUDGET):
                await asyncio.sleep(policy.delay(attempt))
                if self._announce_done:
                    return False
                try:
                    t0_clock = self.flight.wall_now()
                    stream = await self.scheduler_client.open_announce_stream(
                        self._open_body)
                    await stream.send({"type": "register",
                                       "resume": self._resume_state()})
                    msg = await stream.recv(timeout=30.0)
                    self._note_clock_sample(t0_clock, msg)
                except DfError as e:
                    ANNOUNCE_RECONNECT_COUNT.labels("retry").inc()
                    self.flight.record(flightlib.EV_RECONNECT, -1, 0.0,
                                       "retry")
                    log.warning("announce reconnect failed",
                                task=self.task_id[:16], attempt=attempt,
                                error=str(e))
                    continue
                if msg is None:
                    ANNOUNCE_RECONNECT_COUNT.labels("retry").inc()
                    continue
                old, self._stream = self._stream, stream
                if old is not None:
                    await old.close()
                self._stream_reconnects += 1
                kind = msg.get("type")
                if kind == "normal_task":
                    self._apply_task_meta(msg.get("task") or {})
                    if self.synchronizer is not None:
                        self.synchronizer.sync_parents(
                            msg.get("parents") or [])
                    self._apply_stripe(msg.get("stripe"))
                elif kind == "need_back_source":
                    self._need_back_source = True
                    for pid in list(self.dispatcher.parents):
                        self.dispatcher.drop_parent(pid)
                elif kind == "schedule_failed":
                    # An answer, not an outage: the verdict stands.
                    ANNOUNCE_RECONNECT_COUNT.labels("rejected").inc()
                    self._sched_update.set()
                    return False
                self._sched_update.set()
                # A restarted scheduler (or a failover member) does not
                # know what this peer holds: re-report every landed piece
                # (reports apply idempotently).
                for rec in self.store.get_pieces():
                    self._pending_reports.append({
                        "piece_num": rec.num,
                        "range_start": rec.offset,
                        "range_size": rec.size,
                        "digest": rec.digest,
                        "download_cost_ms": rec.cost_ms,
                        "dst_peer_id": "",
                    })
                await self._flush_reports()
                outcome = "rehomed" if self._rehome_pending else "ok"
                self._rehome_pending = False
                ANNOUNCE_RECONNECT_COUNT.labels(outcome).inc()
                self.flight.record(flightlib.EV_RECONNECT, -1, 0.0, outcome)
                log.info("announce stream recovered",
                         task=self.task_id[:16], attempt=attempt,
                         result=outcome, reconnects=self._stream_reconnects)
                return True
            ANNOUNCE_RECONNECT_COUNT.labels("exhausted").inc()
            self.flight.record(flightlib.EV_RECONNECT, -1, 0.0, "exhausted")
            return False

    async def _piece_worker(self, index: int) -> None:
        while True:
            if self._complete() or self._need_back_source:
                return
            assignment = await self.dispatcher.get(timeout=10.0)
            if assignment is None:
                if self._complete() or self._need_back_source:
                    return
                if not await self._handle_starvation():
                    return
                continue
            run = self.dispatcher.extend_run(assignment, SPAN_MAX_PIECES)
            if self.wfq is None:
                await self._dispatch_assignment(assignment, run)
                continue
            # The QoS gate: the assignment is held while this worker waits
            # its DWRR turn, so the order requests go out across tasks
            # follows the class weights. Taken after dispatcher.get(), so
            # a worker parked in a starvation wait holds no slot.
            await self.wfq.acquire(self._qos_priority)
            try:
                await self._dispatch_assignment(assignment, run)
            finally:
                self.wfq.release()

    async def _dispatch_assignment(self, assignment: PieceAssignment,
                                   run: list[PieceAssignment]) -> None:
        if len(run) > 1 and await self._download_run(run):
            return
        for extra in run[1:]:
            # The run is ineligible: hand the reservations back and pull
            # the head piece alone.
            self.dispatcher.release_assignment(extra)
        await self._download_one(assignment)

    async def _landed(self, a: PieceAssignment, rec) -> None:
        p = a.parent
        self.dispatcher.report_success(a, rec.cost_ms)
        PIECE_DOWNLOAD_COUNT.labels("ok").inc()
        self._note_piece_bytes(p, rec.size)
        self.flight.record(flightlib.EV_LANDED, a.piece_num,
                           float(rec.cost_ms), self._parent_locality(p))
        await self._report_piece(rec, parent_id=p.peer_id)
        if self.on_piece is not None:
            await self.on_piece(self.store, rec)

    async def _send_piece_failed(self, a: PieceAssignment, gone: bool,
                                 reason: str) -> None:
        self.flight.record(flightlib.EV_FAILED, a.piece_num, 0.0, reason)
        await self._safe_send({
            "type": "piece_failed",
            "piece_num": a.piece_num,
            "parent_id": a.parent.peer_id,
            "temporary": not gone,
            "reason": reason,
        })

    async def _download_run(self, run: list[PieceAssignment]) -> bool:
        """One ranged GET for the run; False when the downloader found it
        ineligible (the caller pulls piece by piece). Results arrive as
        each piece lands."""
        penalized: list = []   # the error OBJECTS already penalized

        async def on_result(a: PieceAssignment, rec, err) -> None:
            if rec is not None:
                await self._landed(a, rec)
                return
            PIECE_DOWNLOAD_COUNT.labels("fail").inc()
            gone = is_parent_gone(err)
            # One span-level event (429, 416, a dead stream) arrives as the
            # SAME error object for every piece: penalize the parent once.
            # Distinct errors (per-piece digest mismatches) count each.
            if any(e is err for e in penalized):
                self.dispatcher.release_assignment(a)
                reason = failure_reason(err)
            else:
                penalized.append(err)
                self.dispatcher.report_failure(a, parent_gone=gone)
                reason = self._note_piece_failure(a.parent, err)
            await self._send_piece_failed(a, gone, reason)

        p = run[0].parent
        return await self.downloader.download_span_to_store(
            p.ip, p.upload_port, self.task_id, run, self.store,
            src_peer_id=self.peer_id, limiter=self.limiter,
            on_result=on_result, tenant=self.tenant)

    async def _download_one(self, assignment: PieceAssignment) -> None:
        try:
            rec = await pull_one_piece(
                self.downloader, self.store, self.dispatcher, assignment,
                task_id=self.task_id, peer_id=self.peer_id,
                limiter=self.limiter, tenant=self.tenant)
        except DfError as e:
            PIECE_DOWNLOAD_COUNT.labels("fail").inc()
            gone = is_parent_gone(e)
            self.dispatcher.report_failure(assignment, parent_gone=gone)
            await self._send_piece_failed(
                assignment, gone,
                self._note_piece_failure(assignment.parent, e))
            return
        await self._landed(assignment, rec)

    async def _handle_starvation(self) -> bool:
        """Nothing assignable: ask the scheduler for new parents. One
        worker at a time runs it; the answer arrives through the receive
        loop. False when the worker should exit (back-to-source took
        over)."""
        async with self._resched_lock:
            if self._complete() or self._need_back_source:
                return False
            # Another worker may have refreshed the parents (a peek only:
            # try_get would leak a reservation). A live parent with nothing
            # assignable does not count.
            if self.dispatcher.has_assignable():
                return True
            self._reschedules += 1
            if self._reschedules > MAX_RESCHEDULES:
                raise DfError(Code.ClientScheduleTimeout,
                              f"starved after {MAX_RESCHEDULES} reschedules")
            blocklist = self.dispatcher.unusable_parent_ids()
            self._sched_update.clear()
            self.flight.record(flightlib.EV_RESCHEDULE, -1, 0.0,
                               "starvation")
            await self._safe_send({"type": "reschedule",
                                   "blocklist": blocklist,
                                   "description": "piece starvation"})
            try:
                # Longer than the scheduler's 30 s seed-patience hold.
                await asyncio.wait_for(self._sched_update.wait(),
                                       timeout=60.0)
            except asyncio.TimeoutError:
                raise DfError(Code.SchedError,
                              "scheduler silent during reschedule")
            self.flight.record(flightlib.EV_SCHED_ANSWER)
            return not self._need_back_source

    # -- reporting -----------------------------------------------------------

    _REPORT_FLUSH_S = 0.05

    async def _report_piece(self, rec, parent_id: str) -> None:
        report = {
            "piece_num": rec.num,
            "range_start": rec.offset,
            "range_size": rec.size,
            "digest": rec.digest,
            "download_cost_ms": rec.cost_ms,
            "dst_peer_id": parent_id,
        }
        # The piece's phase split, for the scheduler's per-host rollup.
        timings = self.flight.piece_report_timings(rec.num)
        if timings:
            report["timings"] = timings
        self._pending_reports.append(report)
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.ensure_future(self._flush_soon())

    async def _flush_soon(self) -> None:
        # Loop until drained: a report appended while _flush_reports is
        # mid-send would otherwise strand past the window.
        loop = asyncio.get_running_loop()
        while True:
            wait = self._last_flush + self._REPORT_FLUSH_S - loop.time()
            if wait > 0 and len(self._pending_reports) < self.report_batch:
                # A full batch waiting skips the window (it only grows
                # batches).
                await asyncio.sleep(wait)
            if not await self._flush_reports():
                # Stream down: the reports stay buffered for the recovery
                # flush.
                return
            if not self._pending_reports:
                return

    def _batch_msg(self, batch: list) -> dict:
        """One report batch on the wire: packed when the scheduler
        negotiated it and the encoder carries the batch exactly, else the
        dict list."""
        if len(batch) == 1:
            return {"type": "piece_finished", "piece": batch[0]}
        if self._packed_ok:
            packed = reportcodec.encode_reports(batch)
            if packed is not None:
                return {"type": "pieces_finished", "packed": packed}
        return {"type": "pieces_finished", "pieces": batch}

    async def _flush_reports(self) -> bool:
        """Send the buffered reports in report_batch-sized messages. False
        when the stream was down: the unsent batch is put back in order
        for the recovery path."""
        async with self._report_lock:
            pending = self._pending_reports
            while pending:
                cap = min(self.report_batch, len(pending))
                batch = [pending.popleft() for _ in range(cap)]
                self._last_flush = asyncio.get_running_loop().time()
                try:
                    sent = await self._safe_send(self._batch_msg(batch))
                except BaseException:
                    # A cancel (teardown racing a flush) must not drop the
                    # popped batch: teardown's own flush reports it.
                    pending.extendleft(reversed(batch))
                    raise
                if not sent:
                    pending.extendleft(reversed(batch))
                    return False
            return True

    @staticmethod
    def _note_recv(msg: dict) -> None:
        """Count a received announce message's serialized bytes."""
        try:
            ANNOUNCE_BYTES.labels("recv").inc(len(codec.packb(msg)))
        except Exception:
            pass   # accounting must never break the stream

    async def _safe_send(self, msg: dict) -> bool:
        """Send on the announce stream; False when it is down (the receive
        loop owns reconnection)."""
        # The scheduler's piece counts must be current when it acts on a
        # terminal or reschedule message: buffered reports go first.
        if msg.get("type") in ("download_finished", "reschedule",
                               "download_failed"):
            await self._flush_reports()
        if msg.get("type") in ("download_finished", "download_failed") \
                and "flight" not in msg:
            # The terminal message ships the task's flight digest and clock
            # samples; a digest failure must never fail the task.
            try:
                msg["flight"] = flightlib.digest(
                    self.flight, clock_samples=self._clock_samples)
            except Exception:
                log.warning("flight digest failed",
                            task=self.task_id[:16], exc_info=True)
        stream = self._stream
        if stream is None or stream.closed:
            return False
        try:
            await stream.send(msg)
            ANNOUNCE_BYTES.labels("sent").inc(len(codec.packb(msg)))
            return True
        except DfError:
            return False

    async def _teardown(self) -> None:
        self._announce_done = True   # recovery must not race teardown
        unwatch = getattr(self.scheduler_client, "unwatch_ring", None)
        if unwatch is not None:
            unwatch(self.task_id)
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        await self._flush_reports()
        if self.synchronizer is not None:
            await self.synchronizer.close()
        await self.downloader.close()
        if self._stream is not None:
            await self._stream.close()


def conductor_factory(*, scheduler_client, piece_manager, host_wire,
                      task_manager=None, piece_parallelism: int = PIECE_WORKERS,
                      report_batch: int = REPORT_BATCH,
                      seed_peer: bool = False, wfq=None):
    """The ``TaskManager``'s ``conductor_factory``, built as the JAX
    ``Daemon._make_conductor`` builds its conductors: the host record from
    ``host_wire()`` (less its telemetry), the request's metadata, ``is_seed``
    from the task (a seed trigger's) or ``seed_peer``, and the piece
    workers, report batch and QoS gate (``wfq``) given; with
    ``task_manager``, a ranged task's import from a local parent, the
    task's flight from the task manager's recorder and its daemon-wide
    quarantine."""

    def make(*, task_id: str, peer_id: str, request, store, on_piece,
             is_seed: bool = False, limiter=None) -> PeerTaskConductor:
        host_info = dict(host_wire())
        host_info.pop("telemetry", None)
        m = request.meta
        meta = {
            "tag": m.tag,
            "application": m.application,
            "digest": m.digest,
            "filters": m.filter.split("&") if m.filter else [],
            "header": dict(m.header),
            "priority": m.priority,
            "tenant": m.tenant,
            "range": m.range,
            "pod_broadcast": getattr(request, "pod_broadcast", False),
        }
        local = flight = quarantine = None
        if task_manager is not None:
            def local(s, cb, _req=request):
                return task_manager.import_range_from_local_parent(s, _req, cb)
            flight = task_manager.flight.task(task_id)
            quarantine = task_manager.quarantine
        return PeerTaskConductor(
            task_id=task_id, peer_id=peer_id, url=request.url, store=store,
            scheduler_client=scheduler_client, piece_manager=piece_manager,
            host_info=host_info, meta=meta,
            is_seed=is_seed or seed_peer,
            piece_parallelism=piece_parallelism, report_batch=report_batch,
            limiter=limiter, on_piece=on_piece,
            disable_back_source=getattr(request, "disable_back_source", False),
            local_range_source=local, flight=flight, quarantine=quarantine,
            wfq=wfq)

    return make
