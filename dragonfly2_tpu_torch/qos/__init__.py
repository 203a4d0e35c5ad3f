"""The tenant QoS plane: the port's copy of
``dragonfly2_tpu/qos/__init__.py``, less its re-export of the admission
classes (import them from ``qos/admission.py``).

- Class semantics: the ``Priority`` ladder (``pkg/types``) folds into
  three dispatch classes with DWRR weights (``class_of``, ``weight_of``),
  so an interactive pull goes ahead of a bulk sweep without starving it.
- ``qos/wfq.py``: ``WFQGate``, the deficit-weighted-round-robin gate the
  conductor's piece workers pass before each request, and
  ``TenantBuckets``, the upload cap split into per-tenant token buckets
  that the upload server's threads debit.

A tenant rides the wire as the ``tenant`` tag of a request's meta and as
the ``tenant=`` query of every piece request, so each served byte is
attributed (``peer_upload_bytes_total{tenant}``). The burn-rate
admission, the scheduler's ``TenantBurnBook`` and the manager's
``AdmissionController``, is ``qos/admission.py``.
"""

from __future__ import annotations

import re

from dragonfly2_tpu_torch.pkg.types import Priority

# The tenant every untagged request folds into: a real label, so metrics
# always have a subject.
DEFAULT_TENANT = "default"

# Tenant tags splice into piece request queries, so the charset is a
# plain identifier's: no CR/LF, no separators.
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")
_TENANT_STRIP = re.compile(r"[^A-Za-z0-9._-]+")

# Dispatch classes, highest weight first (the DWRR visit order). 16:4:1
# keeps background flows live while an interactive pull sees about 3/4
# of contended dispatch capacity.
CLASSES = ("interactive", "normal", "background")
WEIGHTS = {"interactive": 16, "normal": 4, "background": 1}


def normalize_tenant(tenant: str | None) -> str:
    """A wire tenant tag clamped to the safe charset: empty folds to
    ``DEFAULT_TENANT``, unsafe characters are stripped (and a tag with
    nothing left folds to ``DEFAULT_TENANT``)."""
    if not tenant:
        return DEFAULT_TENANT
    if _TENANT_RE.match(tenant):
        return tenant
    cleaned = _TENANT_STRIP.sub("", tenant)[:64].lstrip("._-")
    return cleaned or DEFAULT_TENANT


def class_of(priority: int) -> str:
    """LEVEL5/6 -> interactive, LEVEL3/4 -> normal, LEVEL2 and below
    (the forbidden floor too) -> background; a value that is not an
    integer counts as LEVEL3."""
    try:
        p = int(priority)
    except (TypeError, ValueError):
        p = int(Priority.LEVEL3)
    if p >= int(Priority.LEVEL5):
        return "interactive"
    if p >= int(Priority.LEVEL3):
        return "normal"
    return "background"


def weight_of(priority: int) -> int:
    return WEIGHTS[class_of(priority)]


from dragonfly2_tpu_torch.qos.wfq import TenantBuckets, WFQGate  # noqa: E402

__all__ = [
    "CLASSES",
    "DEFAULT_TENANT",
    "TenantBuckets",
    "WEIGHTS",
    "WFQGate",
    "class_of",
    "normalize_tenant",
    "weight_of",
]
