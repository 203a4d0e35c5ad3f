"""Burn-rate admission, both halves: the port's copy of
``TenantBurnBook`` and ``AdmissionController`` from
``dragonfly2_tpu/qos/admission.py``.

``TenantBurnBook`` (the scheduler's half): one completion ring per
tenant, fed from the flight digests that daemons ship on their terminal
announce message, evaluated against ``pkg/slo.TENANT_SLOS`` with the
burn formula ``error_rate / error_budget``. The scheduler narrows a
breaching tenant's parent handouts (``scheduling.Scheduling.wire_qos``),
and its ``snapshot()`` rides the scheduler's manager keepalive.

``AdmissionController`` (the manager's half): ingests those snapshots
and answers whether a tenant may submit a job now. ``ok`` and ``warn``
admit; ``breach`` throttles with a ``Retry-After`` that scales with the
burn, up to ``max_retry_after_s``. A view older than ``stale_after_s``
admits: a dead scheduler link must not stop job submission.
"""

from __future__ import annotations

import time
from collections import deque

from dragonfly2_tpu_torch import qos
from dragonfly2_tpu_torch.pkg import metrics, slo as slolib

TENANT_BURN = metrics.gauge(
    "qos_tenant_burn_rate",
    "Per-tenant error-budget burn rate (worst window across the "
    "TENANT_SLOS specs; 1.0 = burning exactly the budget)",
    ("tenant",))

ADMISSION_DECISIONS = metrics.counter(
    "qos_admission_decisions_total",
    "Manager admission verdicts per tenant (admit, or throttle with "
    "Retry-After, when the tenant's burn state is breached)",
    ("tenant", "decision"))


class TenantBurnBook:
    """Per-tenant burn evaluation over bounded completion rings.

    One ring per tenant (LRU-capped at ``max_tenants``); evaluation walks
    each spec's windows and reports the worst burn and state per tenant.
    """

    def __init__(self, specs=None, *, max_tenants: int = 64,
                 max_completions: int = 512, clock=time.monotonic):
        self.specs = tuple(specs if specs is not None
                           else slolib.TENANT_SLOS)
        for spec in self.specs:
            if spec.kind != "completion":
                raise ValueError(
                    f"TenantBurnBook only evaluates completion SLIs, "
                    f"got {spec.name!r} kind {spec.kind!r}")
        self.max_tenants = max_tenants
        self.max_completions = max_completions
        self._clock = clock
        self._rings: dict[str, deque] = {}
        self._burn_children = {}

    def note_completion(self, tenant: str, makespan_s: float,
                        ttfb_s: float = -1.0, stall_frac: float = 0.0,
                        now: "float | None" = None) -> None:
        t = qos.normalize_tenant(tenant)
        ring = self._rings.get(t)
        if ring is None:
            if len(self._rings) >= self.max_tenants:
                # Evict the tenant whose newest completion is oldest: the
                # one least likely to matter to current admission.
                evict = min(self._rings,
                            key=lambda k: self._rings[k][-1][0]
                            if self._rings[k] else -1e18)
                del self._rings[evict]
            ring = self._rings[t] = deque(maxlen=self.max_completions)
        ring.append((self._clock() if now is None else now,
                     makespan_s, ttfb_s, stall_frac))

    _FIELD = {"makespan_s": 1, "ttfb_s": 2, "stall_frac": 3}

    def _spec_burn(self, spec, ring, now) -> "tuple[float, str]":
        idx = self._FIELD.get(spec.field)
        if idx is None:
            return 0.0, "no_data"
        budget = max(1e-9, 1.0 - spec.objective)
        worst_burn, worst_state = 0.0, "no_data"
        for window, burn_threshold in zip(spec.windows,
                                          spec.burn_thresholds):
            cutoff = now - window
            total = bad = 0
            for row in reversed(ring):       # newest first, time-ordered
                if row[0] < cutoff:
                    break
                value = row[idx]
                if value is None or value < 0:
                    continue
                total += 1
                if value > spec.threshold:
                    bad += 1
            if total < spec.min_events:
                continue
            burn = (bad / total) / budget
            state = ("breach" if burn >= burn_threshold
                     else "warn" if burn >= 1.0 else "ok")
            if burn >= worst_burn:
                worst_burn = burn
            if _STATE_RANK[state] > _STATE_RANK[worst_state]:
                worst_state = state
        return worst_burn, worst_state

    def snapshot(self, now: "float | None" = None) -> dict:
        """``{tenant: {"burn": x, "state": s, "completions": n}}``."""
        if now is None:
            now = self._clock()
        out = {}
        for tenant, ring in self._rings.items():
            worst_burn, worst_state = 0.0, "no_data"
            for spec in self.specs:
                burn, state = self._spec_burn(spec, ring, now)
                worst_burn = max(worst_burn, burn)
                if _STATE_RANK[state] > _STATE_RANK[worst_state]:
                    worst_state = state
            out[tenant] = {"burn": round(worst_burn, 4),
                           "state": worst_state,
                           "completions": len(ring)}
            child = self._burn_children.get(tenant)
            if child is None:
                child = self._burn_children[tenant] = TENANT_BURN.labels(
                    tenant)
            child.set(worst_burn)
        return out

    def throttled(self, now: "float | None" = None) -> set:
        return {t for t, s in self.snapshot(now).items()
                if s["state"] == "breach"}


_STATE_RANK = {"no_data": 0, "ok": 1, "warn": 2, "breach": 3}


class AdmissionController:
    """The manager's admission ladder over ingested burn snapshots."""

    def __init__(self, *, stale_after_s: float = 60.0,
                 base_retry_after_s: float = 2.0,
                 max_retry_after_s: float = 30.0,
                 max_tenants: int = 256, clock=time.monotonic):
        self.stale_after_s = stale_after_s
        self.base_retry_after_s = base_retry_after_s
        self.max_retry_after_s = max_retry_after_s
        self.max_tenants = max_tenants
        self._clock = clock
        self._state: dict[str, dict] = {}
        self._decisions = {}

    def ingest(self, snapshot: dict, now: "float | None" = None) -> int:
        """Merge a scheduler's burn snapshot; returns tenants updated."""
        if not isinstance(snapshot, dict):
            return 0
        if now is None:
            now = self._clock()
        updated = 0
        for tenant, entry in snapshot.items():
            if not isinstance(entry, dict):
                continue
            t = qos.normalize_tenant(str(tenant))
            if t not in self._state and len(self._state) >= self.max_tenants:
                continue
            try:
                burn = float(entry.get("burn", 0.0))
            except (TypeError, ValueError):
                burn = 0.0
            state = str(entry.get("state", "no_data"))
            if state not in _STATE_RANK:
                state = "no_data"
            prev = self._state.get(t)
            if prev is not None and prev["ts"] == now:
                # Two schedulers reporting one tenant at one instant: the
                # hotter view stands.
                if burn < prev["burn"]:
                    continue
            self._state[t] = {"burn": burn, "state": state, "ts": now}
            updated += 1
        return updated

    def check(self, tenant: str,
              now: "float | None" = None) -> "tuple[bool, float, dict]":
        """``(admitted, retry_after_s, detail)`` for a job submission."""
        if now is None:
            now = self._clock()
        t = qos.normalize_tenant(tenant)
        entry = self._state.get(t)
        if entry is None or now - entry["ts"] > self.stale_after_s:
            return True, 0.0, {"tenant": t, "state": "no_data", "burn": 0.0}
        detail = {"tenant": t, "state": entry["state"],
                  "burn": entry["burn"]}
        if entry["state"] != "breach":
            self._count(t, "admit")
            return True, 0.0, detail
        # A marginal breach retries soon, a runaway one backs off hard.
        retry = min(self.max_retry_after_s,
                    self.base_retry_after_s * max(1.0, entry["burn"]))
        self._count(t, "throttle")
        return False, round(retry, 2), detail

    def _count(self, tenant: str, decision: str) -> None:
        key = (tenant, decision)
        child = self._decisions.get(key)
        if child is None:
            child = self._decisions[key] = ADMISSION_DECISIONS.labels(
                tenant, decision)
        child.inc()

    def report(self, now: "float | None" = None) -> dict:
        if now is None:
            now = self._clock()
        return {t: {**e, "age_s": round(now - e["ts"], 1),
                    "stale": now - e["ts"] > self.stale_after_s}
                for t, e in self._state.items()}
