"""The continuous SLO / burn-rate engine: the port's copy of
``dragonfly2_tpu/pkg/slo.py``.

Declarative SLO specs are evaluated over sliding windows, the standard
multi-window burn-rate formulation:

    error_rate = bad_events / total_events          (per window)
    burn_rate  = error_rate / (1 - objective)       (1.0 = budget pace)
    state      = breach when burn_rate >= the window's threshold

Four SLI kinds, each reduced to a good/bad fraction over a window:

  * ``completion``: per-completion values (makespan, TTFB, stall
    fraction) of the flight digests daemons ship when a task ends
    (``pkg/podlens.completion_stats``); an event is bad above the spec's
    threshold. A bounded ring.
  * ``ratio``: bad/total counter columns of the fleet time-series.
  * ``gauge``: the fraction of time-series buckets whose sampled gauge
    is above the threshold.
  * ``probe``: a callable ``(window, threshold) -> (bad, total)`` under
    the spec's field. The runtime observatory (``pkg/prof``) feeds
    ``loop_lag`` so: wedged wall-seconds over observed wall-seconds.

Served at ``GET /debug/slo`` (the scheduler's full set; a daemon's
runtime-only engine) and exported as ``scheduler_slo_burn_rate{slo,
window}`` and ``scheduler_slo_breaches_total{slo}`` (one increment per
transition into breach). ``SLOSpec`` and ``TENANT_SLOS`` also back the
tenant burn book (``qos/admission.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("slo")

BURN_GAUGE = metrics.gauge(
    "scheduler_slo_burn_rate",
    "Error-budget burn rate per SLO and sliding window (1.0 = burning "
    "exactly the budget; the window's threshold marks a breach)",
    ("slo", "window"))

BREACH_COUNT = metrics.counter(
    "scheduler_slo_breaches_total",
    "Transitions of an SLO into the breached state (any window's burn "
    "rate crossing its threshold; edge-triggered, not per-scrape)",
    ("slo",))


@dataclass(frozen=True)
class SLOSpec:
    """One declarative service-level objective.

    ``windows`` and ``burn_thresholds`` align positionally: the classic
    fast/slow pair (5 m @ 14.4x, 1 h @ 6x) by default. ``objective`` is
    the good-event target (0.99 = 1% error budget); ``threshold`` is the
    per-event/per-bucket good/bad cut for completion and gauge kinds."""

    name: str
    kind: str                  # "completion" | "ratio" | "gauge" | "probe"
    description: str = ""
    field: str = ""            # completion value / gauge column
    bad_col: str = ""          # ratio: numerator counter column
    total_col: str = ""        # ratio: denominator counter column
    threshold: float = 0.0
    objective: float = 0.95
    windows: "tuple[float, ...]" = (300.0, 3600.0)
    burn_thresholds: "tuple[float, ...]" = (14.4, 6.0)
    min_events: int = 1


# The default spec set. Deployments override it by constructing the
# engine with their own list.
DEFAULT_SLOS = (
    SLOSpec("broadcast_makespan", "completion", field="makespan_s",
            threshold=60.0, objective=0.95,
            description="task completion wall time stays under 60 s for "
                        "95% of completions (the <60 s pod-broadcast "
                        "north star, per host)"),
    SLOSpec("host_ttfb", "completion", field="ttfb_s",
            threshold=5.0, objective=0.95,
            description="a downloading host sees its first byte within "
                        "5 s for 95% of completions"),
    SLOSpec("stall_fraction", "completion", field="stall_frac",
            threshold=0.25, objective=0.99,
            description="silent-parent stall time stays under 25% of a "
                        "task's wall for 99% of completions"),
    # Lower objectives cap the achievable burn at 1/(1-objective), so
    # their thresholds must sit below that ceiling or the breach state
    # is unreachable (SLOEngine rejects such specs at construction).
    SLOSpec("back_source_rate", "ratio", bad_col="back_source",
            total_col="registers", objective=0.75,
            burn_thresholds=(3.0, 2.0),
            description="origin demotions stay under 25% of peer "
                        "registrations (origin economy: ~one fetch per "
                        "task, not one per host)"),
    SLOSpec("straggler_hosts", "gauge", field="straggler_hosts",
            threshold=0.0, objective=0.9, burn_thresholds=(8.0, 4.0),
            description="no host is flagged a fleet-wide straggler in "
                        "90% of sampled buckets"),
    SLOSpec("loop_lag", "probe", field="loop_lag", threshold=0.25,
            objective=0.99,
            description="event-loop wedged time (heartbeat lag above "
                        "250 ms) stays under 1% of observed wall time — "
                        "the runtime observatory's loop probe feeds it; "
                        "no_data until pkg/prof is armed"),
)

# The daemon-side runtime engine evaluates just this subset (the rest
# need a scheduler's fleet series / completion feed).
RUNTIME_SLOS = tuple(s for s in DEFAULT_SLOS if s.kind == "probe")

# Per-tenant admission specs (qos.TenantBurnBook): the completion SLIs
# re-cut per tenant with a fast window tuned to admission latency — a
# tenant burning its budget should be throttled within a minute, not an
# hour. Deployments override via TenantBurnBook(specs=...).
TENANT_SLOS = (
    SLOSpec("tenant_makespan", "completion", field="makespan_s",
            threshold=60.0, objective=0.95,
            windows=(60.0, 300.0), burn_thresholds=(14.4, 6.0),
            description="per-tenant task completion wall time stays "
                        "under 60 s for 95% of the tenant's completions "
                        "— the admission ladder's primary signal"),
    SLOSpec("tenant_stall", "completion", field="stall_frac",
            threshold=0.25, objective=0.90,
            windows=(60.0, 300.0), burn_thresholds=(8.0, 4.0),
            description="per-tenant stall fraction stays under 25% of "
                        "task wall for 90% of the tenant's completions "
                        "(a tenant thrashing its parents burns here "
                        "before it hurts makespan)"),
)


@dataclass
class _WindowState:
    burn: float = 0.0
    state: str = "no_data"
    events: int = 0
    bad: float = 0.0


class SLOEngine:
    """Continuous evaluator. ``series`` is the scheduler's
    ``fleet.FleetTimeSeries`` (ratio/gauge SLIs report ``no_data``
    without one); completions arrive via ``note_completion``."""

    # Continuous means "every few seconds", not "every completion": the
    # windows are 5 m / 1 h, so a 5 s tick loses nothing while keeping
    # the engine invisible on the ingest path.
    def __init__(self, specs=DEFAULT_SLOS, *, series=None, probes=None,
                 max_completions: int = 4096,
                 min_eval_interval_s: float = 5.0,
                 clock=time.monotonic):
        self.specs = tuple(specs)
        for spec in self.specs:
            ceiling = 1.0 / max(1e-9, 1.0 - spec.objective)
            for bt in spec.burn_thresholds:
                if bt >= ceiling:
                    raise ValueError(
                        f"SLO {spec.name!r}: burn threshold {bt} is "
                        f"unreachable — a total outage burns at most "
                        f"{ceiling:.1f}x with objective {spec.objective}")
            if len(spec.windows) != len(spec.burn_thresholds):
                raise ValueError(
                    f"SLO {spec.name!r}: windows and burn_thresholds "
                    f"must align positionally")
        self.series = series
        # kind="probe" feeds: field -> callable(window, threshold) ->
        # (bad, total). Wired at construction or later (the scheduler
        # attaches the runtime observatory's probes when prof arms).
        self.probes: dict = dict(probes or {})
        self.max_completions = max_completions
        self.min_eval_interval_s = min_eval_interval_s
        self._clock = clock
        # Preallocated completion ring of (t, makespan, ttfb, stall_frac,
        # host) tuples — the flight-ring discipline.
        self._ring: list = [None] * max_completions
        self._n = 0
        self._evaluated_at = -1e18
        self._last: "dict | None" = None
        self._breached: dict[str, bool] = {s.name: False for s in self.specs}
        self._breaches: dict[str, int] = {s.name: 0 for s in self.specs}
        self._burn_children: dict = {}

    # -- feed --------------------------------------------------------------

    def note_completion(self, host: str, makespan_s: float,
                        ttfb_s: float = -1.0, stall_frac: float = 0.0,
                        now: "float | None" = None) -> None:
        if now is None:
            now = self._clock()
        self._ring[self._n % self.max_completions] = (
            now, makespan_s, ttfb_s, stall_frac, host)
        self._n += 1
        if now - self._evaluated_at >= self.min_eval_interval_s:
            self.evaluate(now)

    @property
    def completions_total(self) -> int:
        return self._n

    # -- evaluation --------------------------------------------------------

    _COMPLETION_FIELD = {"makespan_s": 1, "ttfb_s": 2, "stall_frac": 3}

    def _completion_counts(self, spec: SLOSpec, window: float,
                           now: float) -> "tuple[int, int]":
        idx = self._COMPLETION_FIELD.get(spec.field)
        if idx is None:
            return 0, 0
        total = bad = 0
        newest = self._n - 1
        oldest = max(0, self._n - self.max_completions)
        i = newest
        cutoff = now - window
        while i >= oldest:
            row = self._ring[i % self.max_completions]
            i -= 1
            if row is None:
                continue
            if row[0] < cutoff:
                break           # ring is time-ordered newest-first
            value = row[idx]
            if value is None or value < 0:
                continue        # unmeasurable (e.g. digest without ttfb)
            total += 1
            if value > spec.threshold:
                bad += 1
        return bad, total

    def _series_counts(self, spec: SLOSpec,
                       window: float) -> "tuple[float, float]":
        if self.series is None:
            return 0.0, 0.0
        if spec.kind == "ratio":
            totals = self.series.totals(window,
                                        (spec.bad_col, spec.total_col))
            return (float(totals.get(spec.bad_col, 0.0)),
                    float(totals.get(spec.total_col, 0.0)))
        values = self.series.gauge_column(spec.field, window)
        if not values:
            return 0.0, 0.0
        bad = sum(1.0 for v in values if v > spec.threshold)
        return bad, float(len(values))

    def _probe_counts(self, spec: SLOSpec,
                      window: float) -> "tuple[float, float]":
        fn = self.probes.get(spec.field or spec.name)
        if fn is None:
            return 0.0, 0.0
        try:
            bad, total = fn(window, spec.threshold)
        except Exception:
            log.warning("slo probe failed", slo=spec.name, exc_info=True)
            return 0.0, 0.0
        # Clamp: burn must never exceed the total-outage ceiling because
        # a probe returned bad > total.
        return min(float(bad), float(total)), float(total)

    def evaluate(self, now: "float | None" = None) -> dict:
        """Recompute every (slo, window) burn rate, update the exported
        gauges, edge-trigger breach counters, and cache the report."""
        if now is None:
            now = self._clock()
        self._evaluated_at = now
        slos = []
        for spec in self.specs:
            budget = max(1e-9, 1.0 - spec.objective)
            windows = []
            breached = False
            for window, burn_threshold in zip(spec.windows,
                                              spec.burn_thresholds):
                if spec.kind == "completion":
                    bad, total = self._completion_counts(spec, window, now)
                elif spec.kind == "probe":
                    bad, total = self._probe_counts(spec, window)
                else:
                    bad, total = self._series_counts(spec, window)
                if total < spec.min_events:
                    w = _WindowState(0.0, "no_data", int(total), bad)
                else:
                    error_rate = bad / total
                    burn = error_rate / budget
                    state = ("breach" if burn >= burn_threshold
                             else "warn" if burn >= 1.0 else "ok")
                    w = _WindowState(round(burn, 4), state, int(total),
                                     round(bad, 2))
                    breached = breached or state == "breach"
                self._burn_gauge(spec.name, window).set(w.burn)
                windows.append({
                    "window_s": window,
                    "burn_rate": w.burn,
                    "burn_threshold": burn_threshold,
                    "state": w.state,
                    "events": w.events,
                    "bad": w.bad,
                })
            if breached and not self._breached[spec.name]:
                self._breaches[spec.name] += 1
                BREACH_COUNT.labels(spec.name).inc()
                log.warning("slo breached", slo=spec.name)
            self._breached[spec.name] = breached
            slos.append({
                "name": spec.name,
                "kind": spec.kind,
                "description": spec.description,
                "objective": spec.objective,
                "threshold": spec.threshold,
                "state": "breach" if breached else (
                    "ok" if any(w["state"] != "no_data" for w in windows)
                    else "no_data"),
                "breaches_total": self._breaches[spec.name],
                "windows": windows,
            })
        self._last = {
            "slos": slos,
            "completions_total": self._n,
            "breached": sorted(n for n, b in self._breached.items() if b),
        }
        return self._last

    def _burn_gauge(self, name: str, window: float):
        # labels() does lock+lookup work; bind children once (the fleet
        # DecisionLog discipline).
        key = (name, window)
        child = self._burn_children.get(key)
        if child is None:
            child = self._burn_children[key] = BURN_GAUGE.labels(
                name, f"{int(window)}s")
        return child

    def report(self) -> dict:
        return self.evaluate()
