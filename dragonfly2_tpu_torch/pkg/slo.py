"""Declarative service-level objectives: the port's copy of the part of
``dragonfly2_tpu/pkg/slo.py`` that the tenant burn book reads,
``SLOSpec`` and ``TENANT_SLOS``.

A spec's burn rate over a window is ``(bad / total) / (1 - objective)``
(1.0 burns exactly the error budget); the window's threshold marks a
breach. The JAX module's ``SLOEngine``, its default fleet specs and its
metric families are not here (``ROADMAP.md`` A7.4).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SLOSpec:
    """One declarative service-level objective.

    ``windows`` and ``burn_thresholds`` align by position. ``objective``
    is the good-event target (0.99 = a 1% error budget); ``threshold`` is
    the per-event good/bad cut of a completion SLI."""

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


# The per-tenant admission specs (qos.admission.TenantBurnBook): the
# completion SLIs cut per tenant, with a fast window tuned to admission
# latency, so a tenant burning its budget is throttled within a minute.
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
