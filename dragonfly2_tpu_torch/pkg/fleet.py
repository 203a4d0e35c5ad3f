"""The fleet observatory: the port's copy of ``dragonfly2_tpu/pkg/fleet.py``.
The scheduler's bounded view of its cluster, fed from the report traffic
its service already handles (piece reports with per-phase ``timings``,
typed ``piece_failed.reason``, announces, registrations):

  * ``FleetTimeSeries`` — a preallocated ring of fixed-width time buckets
    (default 5 s x 720 = 1 h) of numeric columns. O(1) per event, O(buckets
    x columns) resident bytes regardless of host count. Gauge columns
    (hosts by state, active broadcasts, quarantine population) are sampled
    from a provider callback at bucket rotation — at most once per
    ``bucket_s`` no matter the event rate. Served at ``/debug/fleet``.

  * ``HostScorecards`` — decaying per-host cross-task stats: EWMA piece
    service time as a downloader (from report ``timings``), EWMA serve
    cost as a parent (from children's reports), failure counts by typed
    reason, upload-serve load. A robust z-score (median/MAD — a single
    outlier cannot inflate the yardstick it is measured against) flags
    fleet-wide stragglers, which feeds an ADVISORY filter into
    ``scheduling._is_candidate``. Bounded: LRU-evicted past ``max_hosts``.
    Served at ``/debug/fleet/hosts``.

  * ``DecisionLog`` — a preallocated ring of scheduling decisions (parent
    handouts with top rejected alternatives, quarantine demotions,
    back-to-source demotions, stripe handouts/reshuffles, straggler
    filters), so "why did host X get parent Y" is answerable after the
    fact at ``/debug/fleet/decisions?host=|task=``.

Hot-path contract: the per-piece feed (``note_pieces``) does one clock
read, a handful of list index increments and per-host EWMA float math —
no per-event dicts, no scans. Scans (gauge sampling, straggler
recompute) run at bucket/TTL cadence or serve time only.

Every method that reads a clock also takes ``now=`` (monotonic seconds
for the series and scorecards, wall seconds for the decision log and the
uptime), so two observatories can be fed one clock. The counters go into
the port's own registry (``pkg/metrics.py``).
"""

from __future__ import annotations

import sys
import time

from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("fleet")

# Typed failure-reason vocabulary (pkg/quarantine weights + piece
# downloader classifier); anything else folds into "other" so the
# time-series stays fixed-width.
REASONS = ("corrupt", "truncated", "stall", "refused", "transport",
           "throttle", "not_found", "http5xx")

COUNTERS = (
    "announces",          # host announce RPCs
    "registers",          # peer registrations (announce_peer opens)
    "reconnects",         # terminal peers replaced by re-registration
    "pieces_landed",
    "bytes_intra",        # landed piece bytes, parent in the same slice
    "bytes_cross",        # ... parent in another slice (real DCN)
    "bytes_unlabeled",    # ... either end without TPU coordinates
    "back_source",        # demotions to origin
    "quarantines",        # hosts entering scheduler-side quarantine
    "stripe_handouts",    # striped-broadcast plans attached to handouts
    "stripe_reshuffles",  # membership-change stripe pushes
    "handouts",           # parent handouts (scheduling decisions)
) + tuple(f"failed_{r}" for r in REASONS) + ("failed_other",)

GAUGES = (
    "hosts_total",
    "hosts_seed",
    "hosts_quarantined",
    "peers_running",
    "tasks_active",       # active broadcasts (RUNNING tasks)
    "straggler_hosts",
)

# Hot-path column handles (ints; name lookup only at export time).
C_ANNOUNCES = COUNTERS.index("announces")
C_REGISTERS = COUNTERS.index("registers")
C_RECONNECTS = COUNTERS.index("reconnects")
C_PIECES = COUNTERS.index("pieces_landed")
C_BYTES_INTRA = COUNTERS.index("bytes_intra")
C_BYTES_CROSS = COUNTERS.index("bytes_cross")
C_BYTES_UNLABELED = COUNTERS.index("bytes_unlabeled")
C_BACK_SOURCE = COUNTERS.index("back_source")
C_QUARANTINES = COUNTERS.index("quarantines")
C_STRIPE_HANDOUTS = COUNTERS.index("stripe_handouts")
C_STRIPE_RESHUFFLES = COUNTERS.index("stripe_reshuffles")
C_HANDOUTS = COUNTERS.index("handouts")
_FAILED_COL = {r: COUNTERS.index(f"failed_{r}") for r in REASONS}
C_FAILED_OTHER = COUNTERS.index("failed_other")


def failed_col(reason: str) -> int:
    return _FAILED_COL.get(reason, C_FAILED_OTHER)


DECISION_COUNT = metrics.counter(
    "scheduler_decisions_total",
    "Scheduling decisions recorded in the fleet audit log, by kind "
    "(handout / quarantine / back_source / stripe_handout / "
    "stripe_reshuffle / straggler_filter / schedule_failed / "
    "admission / throttle)", ("kind",))

STRAGGLER_GAUGE = metrics.gauge(
    "fleet_straggler_hosts",
    "Hosts currently flagged as fleet-wide stragglers by the scorecard "
    "robust z-score (slow serve EWMA across tasks)")

# labels() does lock+lookup work on every call; decisions are frequent
# enough (one per handout) that the children are bound once here.
_DECISION_CHILDREN: dict = {}


def _decision_child(kind: str):
    child = _DECISION_CHILDREN.get(kind)
    if child is None:
        child = _DECISION_CHILDREN[kind] = DECISION_COUNT.labels(kind)
    return child


def _deep_bytes(obj, _seen=None) -> int:
    """Recursive getsizeof over the containers the observatory owns —
    the resident-bytes bound fleet_bench publishes. Cycles guarded."""
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return 0
    _seen.add(oid)
    size = sys.getsizeof(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            size += _deep_bytes(k, _seen) + _deep_bytes(v, _seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            size += _deep_bytes(v, _seen)
    elif hasattr(obj, "__slots__"):
        for slot in obj.__slots__:
            if hasattr(obj, slot):
                size += _deep_bytes(getattr(obj, slot), _seen)
    elif hasattr(obj, "__dict__"):
        size += _deep_bytes(obj.__dict__, _seen)
    return size


# --------------------------------------------------------------------- #
# Cluster time-series
# --------------------------------------------------------------------- #

class FleetTimeSeries:
    """Preallocated ring of fixed-width time buckets. ``inc`` is O(1);
    rotation (bounded by ring length, amortized once per ``bucket_s``)
    zeroes reused slots and samples the gauge provider."""

    __slots__ = ("bucket_s", "n_buckets", "_counts", "_gauges", "_stamp",
                 "_gauge_stamp", "_cur", "_sampler", "_clock",
                 "_wall_anchor")

    def __init__(self, bucket_s: float = 5.0, buckets: int = 720,
                 sampler=None, clock=time.monotonic):
        self.bucket_s = float(bucket_s)
        self.n_buckets = int(buckets)
        nc, ng = len(COUNTERS), len(GAUGES)
        self._counts = [[0.0] * nc for _ in range(self.n_buckets)]
        self._gauges = [[0.0] * ng for _ in range(self.n_buckets)]
        self._stamp = [-1] * self.n_buckets      # absolute bucket number
        # Buckets where the gauge sampler actually RAN (rotation stamps
        # skipped-over gap buckets too, but only the rotation target gets
        # a sample — gauge consumers must not read the gaps as zeros).
        self._gauge_stamp = [-1] * self.n_buckets
        self._cur = -1
        self._sampler = sampler
        self._clock = clock
        # wall = monotonic + anchor, for export timestamps.
        self._wall_anchor = time.time() - clock()

    # -- hot path ----------------------------------------------------------

    def inc(self, col: int, n: float = 1.0, now: "float | None" = None) -> None:
        if now is None:
            now = self._clock()
        b = int(now / self.bucket_s)
        if b != self._cur:
            self._rotate(b)
        self._counts[b % self.n_buckets][col] += n

    def bucket(self, now: "float | None" = None) -> list:
        """Current bucket's counter row (rotated first) — lets a batch
        caller do several ``row[col] += n`` on one clock read."""
        if now is None:
            now = self._clock()
        b = int(now / self.bucket_s)
        if b != self._cur:
            self._rotate(b)
        return self._counts[b % self.n_buckets]

    def _rotate(self, b: int) -> None:
        start = self._cur + 1 if 0 <= b - self._cur <= self.n_buckets \
            else b - self.n_buckets + 1
        for a in range(max(start, b - self.n_buckets + 1), b + 1):
            slot = a % self.n_buckets
            if self._stamp[slot] != a:
                if self._stamp[slot] >= 0:
                    # Reused slot: zero it. Pristine slots (stamp -1)
                    # were zero-constructed — the first rotation after
                    # start-up must not pay a full-ring rewrite.
                    row = self._counts[slot]
                    for i in range(len(row)):
                        row[i] = 0.0
                    grow = self._gauges[slot]
                    for i in range(len(grow)):
                        grow[i] = 0.0
                self._stamp[slot] = a
        self._cur = b
        if self._sampler is not None:
            try:
                sampled = self._sampler()
            except Exception:          # a broken sampler must not drop events
                sampled = None
            if sampled:
                slot = b % self.n_buckets
                grow = self._gauges[slot]
                for i, name in enumerate(GAUGES):
                    grow[i] = float(sampled.get(name, 0.0))
                self._gauge_stamp[slot] = b

    # -- export ------------------------------------------------------------

    def window(self, seconds: float, now: "float | None" = None) -> dict:
        """Newest-last series for the trailing ``seconds`` (clamped to the
        ring), as {column: [v, ...]} plus per-column totals."""
        if now is None:
            now = self._clock()
        self.bucket(now)               # rotate so stale slots read zero
        want = max(1, min(self.n_buckets, int(seconds / self.bucket_s) + 1))
        cur = int(now / self.bucket_s)
        buckets = []
        for a in range(cur - want + 1, cur + 1):
            slot = a % self.n_buckets
            if a < 0 or self._stamp[slot] != a:
                buckets.append(None)
            else:
                buckets.append(slot)
        series = {}
        for i, name in enumerate(COUNTERS):
            series[name] = [0.0 if s is None else self._counts[s][i]
                            for s in buckets]
        gauges = {}
        for i, name in enumerate(GAUGES):
            gauges[name] = [0.0 if s is None else self._gauges[s][i]
                            for s in buckets]
        return {
            "bucket_s": self.bucket_s,
            "buckets": want,
            "t_start_wall": round(
                (cur - want + 1) * self.bucket_s + self._wall_anchor, 3),
            "counters": series,
            "gauges": gauges,
            "totals": {name: sum(vals) for name, vals in series.items()},
        }

    def totals(self, seconds: float, columns: "tuple | list",
               now: "float | None" = None) -> dict:
        """Per-column sums over the trailing window WITHOUT materializing
        per-bucket series — the SLO engine's repeated-cadence accessor
        (window() builds one list per column; at a 720-bucket ring that
        is ~25k list appends per call, too hot for a burn-rate tick)."""
        if now is None:
            now = self._clock()
        self.bucket(now)               # rotate so stale slots read zero
        want = max(1, min(self.n_buckets, int(seconds / self.bucket_s) + 1))
        cur = int(now / self.bucket_s)
        # The all-columns call (cluster frame builder, every keepalive)
        # skips the per-column index scans.
        idx = range(len(COUNTERS)) if columns is COUNTERS \
            else [COUNTERS.index(c) for c in columns]
        sums = [0.0] * len(idx)
        for a in range(cur - want + 1, cur + 1):
            slot = a % self.n_buckets
            if a < 0 or self._stamp[slot] != a:
                continue
            row = self._counts[slot]
            for j, i in enumerate(idx):
                sums[j] += row[i]
        return dict(zip(columns, sums))

    def gauge_column(self, name: str, seconds: float,
                     now: "float | None" = None) -> list:
        """One gauge column's sampled values over the trailing window —
        buckets the sampler actually ran for, only. Gap buckets (rotated
        past, never sampled) are not fabricated as zeros, so a
        fraction-of-bad-buckets SLI stays honest."""
        i = GAUGES.index(name)
        if now is None:
            now = self._clock()
        self.bucket(now)
        want = max(1, min(self.n_buckets, int(seconds / self.bucket_s) + 1))
        cur = int(now / self.bucket_s)
        out = []
        for a in range(cur - want + 1, cur + 1):
            slot = a % self.n_buckets
            if a >= 0 and self._gauge_stamp[slot] == a:
                out.append(self._gauges[slot][i])
        return out

    def gauges_last(self, seconds: float,
                    now: "float | None" = None) -> dict:
        """Newest sampled gauge row within the trailing window, as
        {name: value} — {} when the sampler never ran in the window
        (never fabricates zeros). The sampler stamps every gauge into
        one bucket, so one reverse scan serves all columns; the cluster
        frame builder needs this every keepalive and per-column
        ``gauge_column()`` calls would re-walk the ring once per gauge."""
        if now is None:
            now = self._clock()
        self.bucket(now)
        want = max(1, min(self.n_buckets, int(seconds / self.bucket_s) + 1))
        cur = int(now / self.bucket_s)
        for a in range(cur, cur - want, -1):
            slot = a % self.n_buckets
            if a >= 0 and self._gauge_stamp[slot] == a:
                grow = self._gauges[slot]
                return {name: grow[i] for i, name in enumerate(GAUGES)}
        return {}

    def resident_bytes(self) -> int:
        return (_deep_bytes(self._counts) + _deep_bytes(self._gauges)
                + _deep_bytes(self._stamp))


# --------------------------------------------------------------------- #
# Per-host scorecards
# --------------------------------------------------------------------- #

class HostScore:
    """One host's decaying cross-task stats. EWMA math only on the hot
    path; time-based decay of failure counts is applied lazily on read."""

    __slots__ = ("host_id", "serve_ewma_ms", "serve_samples",
                 "serve_stamp", "down_ewma_ms", "down_samples", "stall_ms",
                 "dcn_ms", "store_ms", "uploads", "failures", "fail_stamp",
                 "last_seen")

    def __init__(self, host_id: str):
        self.host_id = host_id
        self.serve_ewma_ms = 0.0   # as a PARENT: children's piece cost
        self.serve_samples = 0
        self.serve_stamp = -1.0    # last serve sample (probation clock)
        self.down_ewma_ms = 0.0    # as a DOWNLOADER: own piece time
        self.down_samples = 0
        self.stall_ms = 0.0        # decayed phase accumulators (timings)
        self.dcn_ms = 0.0
        self.store_ms = 0.0
        self.uploads = 0.0         # decayed upload-serve load
        self.failures: dict = {}   # reason -> decayed count
        self.fail_stamp = -1.0     # -1 = never stamped (0.0 is a real time)
        self.last_seen = 0.0


class HostScorecards:
    """Bounded per-host registry. ``is_straggler`` consults a cached flag
    set recomputed at most every ``recompute_s`` from a robust z-score
    over serve EWMAs: z = (x - median) / max(1.4826*MAD, floor). The
    median/MAD yardstick means one pathological host cannot widen the
    spread enough to hide itself (a classic mean/sigma failure at small
    populations)."""

    def __init__(self, *, max_hosts: int = 1024, ewma_alpha: float = 0.2,
                 half_life_s: float = 600.0, z_threshold: float = 3.0,
                 min_serve_samples: int = 8, min_population: int = 8,
                 recompute_s: float = 2.0, flag_ttl_s: float = 120.0,
                 clock=time.monotonic):
        self.max_hosts = max_hosts
        self.alpha = ewma_alpha
        self.half_life_s = half_life_s
        self.z_threshold = z_threshold
        self.min_serve_samples = min_serve_samples
        self.min_population = min_population
        self.recompute_s = recompute_s
        # Probation: a flagged host stops getting handouts, so it stops
        # getting serve samples and its EWMA freezes. The flag therefore
        # only holds while samples are FRESH; past flag_ttl_s the host is
        # re-trialed (if it is still slow, the next samples re-flag it).
        self.flag_ttl_s = flag_ttl_s
        self._clock = clock
        self._hosts: dict[str, HostScore] = {}
        self._stragglers: set[str] = set()
        self._recomputed_at = -1e18

    def _score(self, host_id: str, now: float) -> HostScore:
        s = self._hosts.get(host_id)
        if s is None:
            if len(self._hosts) >= self.max_hosts:
                # Batch-evict the ~3% least-recently-seen cards in one
                # scan: a churning fleet admits new hosts constantly, and
                # a scan per admission would be O(cap) per event.
                import heapq

                k = max(1, self.max_hosts // 32)
                for victim in heapq.nsmallest(
                        k, self._hosts.values(),
                        key=lambda h: h.last_seen):
                    del self._hosts[victim.host_id]
            s = self._hosts[host_id] = HostScore(host_id)
        s.last_seen = now
        return s

    # -- hot path ----------------------------------------------------------

    def note_download(self, host_id: str, cost_ms: float,
                      timings: "dict | None",
                      now: "float | None" = None) -> None:
        """The downloading host's own piece time + phase split."""
        if now is None:
            now = self._clock()
        s = self._score(host_id, now)
        a = self.alpha
        if s.down_samples == 0:
            s.down_ewma_ms = float(cost_ms)
        else:
            s.down_ewma_ms += a * (cost_ms - s.down_ewma_ms)
        s.down_samples += 1
        if timings:
            b = 1.0 - a
            s.dcn_ms = b * s.dcn_ms + a * float(timings.get("dcn_ms", 0) or 0)
            s.stall_ms = b * s.stall_ms + a * float(
                timings.get("stall_ms", 0) or 0)
            s.store_ms = b * s.store_ms + a * float(
                timings.get("store_ms", 0) or 0)

    def note_serve(self, host_id: str, cost_ms: float,
                   now: "float | None" = None, count: int = 1) -> None:
        """A child reported ``count`` pieces served BY this host at a mean
        cost of ``cost_ms``: the parent's serving speed as experienced
        fleet-wide. ``count > 1`` applies the batch-equivalent EWMA step
        (effective alpha 1-(1-a)^k) so a coalesced report moves the
        estimate as far as k single reports at the same value would."""
        if now is None:
            now = self._clock()
        s = self._score(host_id, now)
        if s.serve_samples == 0:
            s.serve_ewma_ms = float(cost_ms)
        else:
            a = self.alpha if count == 1 else \
                1.0 - (1.0 - self.alpha) ** count
            s.serve_ewma_ms += a * (cost_ms - s.serve_ewma_ms)
        s.serve_samples += count
        s.uploads += count
        s.serve_stamp = now
        self.maybe_recompute(now)

    def note_failure(self, host_id: str, reason: str,
                     now: "float | None" = None) -> None:
        if now is None:
            now = self._clock()
        s = self._score(host_id, now)
        self._decay_failures(s, now)
        s.failures[reason] = s.failures.get(reason, 0.0) + 1.0

    def _decay_failures(self, s: HostScore, now: float) -> None:
        dt = now - s.fail_stamp
        if s.fail_stamp >= 0 and dt > 0 and s.failures:
            k = 0.5 ** (dt / self.half_life_s)
            for r in list(s.failures):
                v = s.failures[r] * k
                if v < 0.01:
                    del s.failures[r]
                else:
                    s.failures[r] = v
        s.fail_stamp = now

    # -- straggler flag ----------------------------------------------------

    def recompute_stragglers(self, now: "float | None" = None) -> set:
        if now is None:
            now = self._clock()
        self._recomputed_at = now
        sampled = [s for s in self._hosts.values()
                   if s.serve_samples >= self.min_serve_samples
                   and now - s.serve_stamp <= self.flag_ttl_s]
        flags: set[str] = set()
        if len(sampled) >= self.min_population:
            values = sorted(s.serve_ewma_ms for s in sampled)
            n = len(values)
            median = values[n // 2] if n % 2 else (
                values[n // 2 - 1] + values[n // 2]) / 2.0
            devs = sorted(abs(v - median) for v in values)
            mad = devs[n // 2] if n % 2 else (
                devs[n // 2 - 1] + devs[n // 2]) / 2.0
            # Scale floor: 5% of the median or 1 ms, so a perfectly
            # uniform fleet (MAD 0) still yields finite z-scores.
            scale = max(1.4826 * mad, 0.05 * median, 1.0)
            for s in sampled:
                if (s.serve_ewma_ms - median) / scale >= self.z_threshold:
                    flags.add(s.host_id)
        # In-place update: scheduling holds a direct reference to this
        # set (one truthiness check + lookup on its inner loop), so the
        # object must never be replaced.
        self._stragglers.clear()
        self._stragglers.update(flags)
        STRAGGLER_GAUGE.set(len(flags))
        return flags

    def is_straggler(self, host_id: str) -> bool:
        """Bare set lookup — called per candidate in the scheduling inner
        loop, so the recompute cadence rides the DATA paths (note_serve /
        note_piece, where a clock value is already in hand), not here."""
        return host_id in self._stragglers

    def maybe_recompute(self, now: float) -> None:
        if now - self._recomputed_at > self.recompute_s:
            self.recompute_stragglers(now)

    def zscore(self, host_id: str) -> float:
        """Robust z of this host's serve EWMA against the sampled fleet
        (report convenience; 0.0 when unscorable)."""
        sampled = [s.serve_ewma_ms for s in self._hosts.values()
                   if s.serve_samples >= self.min_serve_samples]
        s = self._hosts.get(host_id)
        if s is None or len(sampled) < self.min_population:
            return 0.0
        values = sorted(sampled)
        n = len(values)
        median = values[n // 2] if n % 2 else (
            values[n // 2 - 1] + values[n // 2]) / 2.0
        devs = sorted(abs(v - median) for v in values)
        mad = devs[n // 2] if n % 2 else (
            devs[n // 2 - 1] + devs[n // 2]) / 2.0
        scale = max(1.4826 * mad, 0.05 * median, 1.0)
        return round((s.serve_ewma_ms - median) / scale, 2)

    # -- export ------------------------------------------------------------

    def report(self, limit: int = 256, now: "float | None" = None) -> dict:
        if now is None:
            now = self._clock()
        if now - self._recomputed_at > self.recompute_s:
            self.recompute_stragglers(now)
        rows = []
        for s in self._hosts.values():
            self._decay_failures(s, now)
            rows.append({
                "host": s.host_id,
                "serve_ewma_ms": round(s.serve_ewma_ms, 2),
                "serve_samples": s.serve_samples,
                "down_ewma_ms": round(s.down_ewma_ms, 2),
                "down_samples": s.down_samples,
                "phase_ewma_ms": {"dcn": round(s.dcn_ms, 2),
                                  "stall": round(s.stall_ms, 2),
                                  "store": round(s.store_ms, 2)},
                "uploads": round(s.uploads, 1),
                "failures": {r: round(v, 2) for r, v in s.failures.items()},
                "straggler": s.host_id in self._stragglers,
                "zscore": self.zscore(s.host_id),
                "idle_s": round(max(0.0, now - s.last_seen), 1),
            })
        rows.sort(key=lambda r: (-r["straggler"], -r["serve_ewma_ms"]))
        return {
            "hosts": rows[:limit],
            "hosts_tracked": len(self._hosts),
            "hosts_truncated": len(rows) > limit,
            "stragglers": sorted(self._stragglers),
        }

    def resident_bytes(self) -> int:
        return _deep_bytes(self._hosts) + _deep_bytes(self._stragglers)


# --------------------------------------------------------------------- #
# Scheduling decision audit log
# --------------------------------------------------------------------- #

class DecisionLog:
    """Bounded ring of decision tuples (one tuple per decision, the
    flight-ring discipline). Query iterates newest-first."""

    __slots__ = ("cap", "_ring", "_n", "_kind_counts")

    def __init__(self, cap: int = 1024):
        self.cap = cap
        self._ring: list = [None] * cap
        self._n = 0
        # Lifetime per-kind counts: the cluster frame builder ships
        # deltas of these (pkg/cluster), which must not scan the ring
        # and must not read the process-global prometheus counter (it
        # aggregates every service in the process).
        self._kind_counts: dict = {}

    def record(self, kind: str, *, task: str = "", host: str = "",
               peer: str = "", reason: str = "",
               chosen: "tuple | None" = None,
               rejected: "tuple | None" = None,
               now: "float | None" = None) -> None:
        """``now`` is the entry's wall time (``time.time()`` by default)."""
        self._ring[self._n % self.cap] = (
            time.time() if now is None else now, kind, task, host, peer,
            reason, chosen, rejected)
        self._n += 1
        self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
        _decision_child(kind).inc()

    @property
    def recorded_total(self) -> int:
        return self._n

    @property
    def kind_counts(self) -> dict:
        return self._kind_counts

    def query(self, *, host: str = "", task: str = "", kind: str = "",
              limit: int = 256, since: float = 0.0,
              before: float = 0.0) -> dict:
        """Newest-first page. ``since``/``before`` are wall-clock bounds
        (half-open [since, before)); the ring is time-ordered, so
        ``since`` also terminates the scan early. ``truncated`` marks a
        page that hit ``limit`` with more matching entries behind it —
        the hard response cap that keeps this endpoint bounded at
        16k-host scale (page back with ``before=<oldest ts>``)."""
        out = []
        truncated = False
        newest = self._n - 1
        oldest = max(0, self._n - self.cap)
        i = newest
        while i >= oldest:
            e = self._ring[i % self.cap]
            i -= 1
            if e is None:
                continue
            ts, k, t, h, p, reason, chosen, rejected = e
            if since and ts < since:
                break          # ring is newest-first: nothing older matches
            if before and ts >= before:
                continue
            if kind and k != kind:
                continue
            if task and t != task:
                continue
            # A host filter matches the subject host OR a chosen/rejected
            # alternative — "why did host X (not) get parent Y".
            if host and h != host \
                    and not (chosen and host in chosen) \
                    and not (rejected and host in rejected):
                continue
            if len(out) >= limit:
                # One matching entry past the cap proves truncation; the
                # scan stops here either way.
                truncated = True
                break
            row = {"ts": round(ts, 3), "kind": k, "task": t, "host": h,
                   "peer": p, "reason": reason}
            if chosen:
                row["chosen"] = list(chosen)
            if rejected:
                row["rejected"] = list(rejected)
            out.append(row)
        return {"decisions": out, "recorded_total": self._n,
                "dropped": max(0, self._n - self.cap),
                "truncated": truncated}

    def resident_bytes(self) -> int:
        return _deep_bytes(self._ring)


# --------------------------------------------------------------------- #
# The observatory facade the service layer feeds
# --------------------------------------------------------------------- #

class FleetObservatory:
    """One instance per scheduler. The service layer calls the ``note_*``
    hooks from its existing report paths; the metrics server serves the
    read side. ``sampler`` (optional) returns the gauge dict
    ({name: value} for GAUGES) — called at bucket rotation + snapshot."""

    def __init__(self, *, bucket_s: float = 5.0, buckets: int = 720,
                 decision_cap: int = 4096, max_hosts: int = 1024,
                 straggler_z: float = 3.0, min_serve_samples: int = 8,
                 min_population: int = 8, sampler=None,
                 config_snapshot: "dict | None" = None):
        self.series = FleetTimeSeries(bucket_s, buckets, sampler=sampler)
        self.scorecards = HostScorecards(
            max_hosts=max_hosts, z_threshold=straggler_z,
            min_serve_samples=min_serve_samples,
            min_population=min_population)
        self.decisions = DecisionLog(decision_cap)
        self._sampler = sampler
        self.started_wall = time.time()
        self.config_snapshot = dict(config_snapshot or {})

    # -- service-layer hooks ----------------------------------------------

    def note_announce(self, now: "float | None" = None) -> None:
        self.series.inc(C_ANNOUNCES, now=now)

    def note_register(self, reconnect: bool = False,
                      now: "float | None" = None) -> None:
        self.series.inc(C_RECONNECTS if reconnect else C_REGISTERS, now=now)

    def note_piece(self, host_id: str, locality_col: int, nbytes: float,
                   cost_ms: float, parent_host: "str | None" = None,
                   timings: "dict | None" = None,
                   now: "float | None" = None) -> None:
        """Single piece-report feed — the scheduler's per-event hot path
        (``piece_finished``). Deliberately INLINED (no sub-calls beyond
        one clock read and the rare rotate/evict): fleet_bench pins the
        paired overhead of exactly this path."""
        s = self.series
        if now is None:
            now = s._clock()
        b = int(now / s.bucket_s)
        if b != s._cur:
            s._rotate(b)
        row = s._counts[b % s.n_buckets]
        row[C_PIECES] += 1.0
        row[locality_col] += nbytes
        sc = self.scorecards
        h = sc._hosts.get(host_id)
        if h is None:
            h = sc._score(host_id, now)
        h.last_seen = now
        a = sc.alpha
        if h.down_samples == 0:
            h.down_ewma_ms = cost_ms + 0.0
        else:
            h.down_ewma_ms += a * (cost_ms - h.down_ewma_ms)
        h.down_samples += 1
        if timings:
            d = 1.0 - a
            h.dcn_ms = d * h.dcn_ms + a * (timings.get("dcn_ms") or 0)
            h.stall_ms = d * h.stall_ms + a * (timings.get("stall_ms") or 0)
            h.store_ms = d * h.store_ms + a * (timings.get("store_ms") or 0)
        if parent_host is not None:
            p = sc._hosts.get(parent_host)
            if p is None:
                p = sc._score(parent_host, now)
            p.last_seen = now
            if p.serve_samples == 0:
                p.serve_ewma_ms = cost_ms + 0.0
            else:
                p.serve_ewma_ms += a * (cost_ms - p.serve_ewma_ms)
            p.serve_samples += 1
            p.uploads += 1.0
            p.serve_stamp = now
            # Straggler recompute cadence rides the serve feed only (the
            # flag is ABOUT serve EWMAs; pieces without a parent can't
            # change it and shouldn't pay the check).
            if now - sc._recomputed_at > sc.recompute_s:
                sc.recompute_stragglers(now)

    def note_pieces(self, host_id: str, n: int, cost_ms_total: float,
                    by_parent: "dict | None" = None,
                    timings: "dict | None" = None,
                    now: "float | None" = None) -> None:
        """Batch feed from a coalesced ``pieces_finished`` report: ``n``
        pieces landed by ``host_id``. ``by_parent`` maps parent host id
        ('' = unattributed) -> [count, cost_ms_sum, bytes, locality_col];
        one serve-EWMA step per DISTINCT parent, not per piece."""
        s = self.series
        if now is None:
            now = s._clock()
        b = int(now / s.bucket_s)
        if b != s._cur:
            s._rotate(b)
        row = s._counts[b % s.n_buckets]
        row[C_PIECES] += n
        sc = self.scorecards
        a = sc.alpha
        if n:
            h = sc._hosts.get(host_id)
            if h is None:
                h = sc._score(host_id, now)
            h.last_seen = now
            mean = cost_ms_total / n
            if h.down_samples == 0:
                h.down_ewma_ms = mean
            else:
                h.down_ewma_ms += a * (mean - h.down_ewma_ms)
            h.down_samples += n
            if timings:
                d = 1.0 - a
                h.dcn_ms = d * h.dcn_ms + a * (timings.get("dcn_ms") or 0)
                h.stall_ms = d * h.stall_ms + a * (
                    timings.get("stall_ms") or 0)
                h.store_ms = d * h.store_ms + a * (
                    timings.get("store_ms") or 0)
        if by_parent:
            for parent_host, agg in by_parent.items():
                k, cost_sum, nbytes, col = agg
                row[col] += nbytes
                if parent_host:
                    p = sc._hosts.get(parent_host)
                    if p is None:
                        p = sc._score(parent_host, now)
                    p.last_seen = now
                    mean = cost_sum / k
                    if p.serve_samples == 0:
                        p.serve_ewma_ms = mean
                    else:
                        # Batch-equivalent EWMA step: effective alpha
                        # 1-(1-a)^k, so k coalesced reports move the
                        # estimate as far as k singles at the same value.
                        ak = a if k == 1 else 1.0 - (1.0 - a) ** k
                        p.serve_ewma_ms += ak * (mean - p.serve_ewma_ms)
                    p.serve_samples += k
                    p.uploads += k
                    p.serve_stamp = now
            if now - sc._recomputed_at > sc.recompute_s:
                sc.recompute_stragglers(now)

    # ``now`` is the series' (monotonic) clock, ``wall`` a decision's
    # wall time; None reads each clock.

    def note_piece_failed(self, parent_host: str, reason: str,
                          now: "float | None" = None) -> None:
        self.series.inc(failed_col(reason), now=now)
        if parent_host:
            self.scorecards.note_failure(parent_host, reason, now=now)

    def note_quarantine(self, task: str, host: str, reason: str,
                        reporter: str = "", now: "float | None" = None,
                        wall: "float | None" = None) -> None:
        self.series.inc(C_QUARANTINES, now=now)
        self.decisions.record("quarantine", task=task, host=host,
                              peer=reporter, reason=reason, now=wall)

    def note_back_source(self, task: str, peer: str, host: str,
                         reason: str, now: "float | None" = None,
                         wall: "float | None" = None) -> None:
        self.series.inc(C_BACK_SOURCE, now=now)
        self.decisions.record("back_source", task=task, host=host,
                              peer=peer, reason=reason, now=wall)

    def note_handout(self, task: str, peer: str, host: str,
                     chosen: tuple, rejected: tuple,
                     now: "float | None" = None,
                     wall: "float | None" = None) -> None:
        self.series.inc(C_HANDOUTS, now=now)
        self.decisions.record("handout", task=task, host=host, peer=peer,
                              chosen=chosen, rejected=rejected, now=wall)

    def note_stripe(self, task: str, peer: str, host: str,
                    reshuffle: bool, now: "float | None" = None,
                    wall: "float | None" = None) -> None:
        if reshuffle:
            self.series.inc(C_STRIPE_RESHUFFLES, now=now)
            self.decisions.record("stripe_reshuffle", task=task, host=host,
                                  peer=peer, now=wall)
        else:
            self.series.inc(C_STRIPE_HANDOUTS, now=now)
            self.decisions.record("stripe_handout", task=task, host=host,
                                  peer=peer, now=wall)

    def note_straggler_filter(self, task: str, peer: str,
                              host: str, wall: "float | None" = None) -> None:
        self.decisions.record(
            "straggler_filter", task=task, host=host, peer=peer,
            reason="fleet scorecard flags this host as a straggler "
                   "(slow serve EWMA, robust z >= threshold)", now=wall)

    def note_schedule_failed(self, task: str, peer: str, host: str,
                             reason: str,
                             wall: "float | None" = None) -> None:
        self.decisions.record("schedule_failed", task=task, host=host,
                              peer=peer, reason=reason, now=wall)

    # -- tenant QoS plane (dragonfly2_tpu/qos) ----------------------------

    def note_admission(self, tenant: str, *, decision: str,
                       burn: float = 0.0, retry_after_s: float = 0.0,
                       source: str = "", wall: "float | None" = None) -> None:
        """QoS admission verdict with the TENANT as subject (the ``host``
        column — decision queries filter on it like any host id)."""
        self.decisions.record(
            "admission", host=tenant, peer=source,
            reason=f"{decision} (burn={burn:.2f}"
                   + (f", retry_after={retry_after_s:.1f}s" if retry_after_s
                      else "") + ")", now=wall)

    def note_throttle(self, tenant: str, *, task_id: str = "",
                      host_id: str = "", reason: str = "",
                      limit: int = 0, wall: "float | None" = None) -> None:
        """QoS handout deprioritization of a budget-burning tenant."""
        self.decisions.record(
            "throttle", task=task_id, host=tenant, peer=host_id,
            reason=reason + (f" (candidate_limit={limit})" if limit else ""),
            now=wall)

    # -- read side ---------------------------------------------------------

    def snapshot(self, window_s: float = 600.0, now: "float | None" = None,
                 wall: "float | None" = None) -> dict:
        gauges_now = {}
        if self._sampler is not None:
            try:
                gauges_now = dict(self._sampler() or {})
            except Exception:
                gauges_now = {}
        return {
            "uptime_s": round((time.time() if wall is None else wall)
                              - self.started_wall, 1),
            "window_s": window_s,
            "now": gauges_now,
            "series": self.series.window(window_s, now=now),
            "decisions_total": self.decisions.recorded_total,
            "resident_bytes": self.resident_bytes(),
        }

    def hosts_report(self, limit: int = 256,
                     now: "float | None" = None) -> dict:
        return self.scorecards.report(limit, now=now)

    def info(self, wall: "float | None" = None) -> dict:
        from dragonfly2_tpu_torch import __version__

        return {
            "component": "scheduler",
            "version": __version__,
            "python": sys.version.split()[0],
            "started_wall": round(self.started_wall, 3),
            "uptime_s": round((time.time() if wall is None else wall)
                              - self.started_wall, 1),
            "config": self.config_snapshot,
            "bounds": {
                "timeseries_buckets": self.series.n_buckets,
                "timeseries_bucket_s": self.series.bucket_s,
                "scorecard_max_hosts": self.scorecards.max_hosts,
                "decision_cap": self.decisions.cap,
            },
            "resident_bytes": self.resident_bytes(),
        }

    def resident_bytes(self) -> int:
        return (self.series.resident_bytes()
                + self.scorecards.resident_bytes()
                + self.decisions.resident_bytes())
