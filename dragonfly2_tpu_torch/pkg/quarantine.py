"""Bad-parent quarantine, a decaying-penalty blocklist: the port's copy of
``dragonfly2_tpu/pkg/quarantine.py``.

A parent that serves corrupt bytes, truncates bodies or stalls keeps
"succeeding" at the transport layer, where a dead one fails fast; each
child would burn its verify-reject-retry loop on it. So:

  * every data-plane failure adds a REASON-WEIGHTED penalty (corrupt >>
    truncated/stall >> transport; a 429 throttle or a missing piece adds
    nothing);
  * the score halves every ``half_life_s``, so an old incident does not
    haunt a recovered parent;
  * crossing the threshold quarantines the key for ``quarantine_s``, and
    while quarantined the parent is invisible to selection.

The daemon keys by ``ip:upload_port`` (``piece_dispatcher.parent_key``),
one registry for every conductor of the daemon and its PEX pulls, so a
parent that corrupted task A is not trusted for task B. The clock is
injectable (``clock=``), as in the JAX class.
"""

from __future__ import annotations

import time
from typing import Callable

# Reason → penalty weight. corrupt trips the default threshold in one
# strike: a crc32c mismatch is never noise (the transport already
# checksums), it is wrong bytes served with a straight face.
REASON_WEIGHTS: dict[str, float] = {
    "corrupt": 3.0,
    "truncated": 1.5,
    "stall": 1.5,
    "refused": 1.0,
    "transport": 1.0,
    "http5xx": 1.0,
    "not_found": 0.0,   # a warming parent legitimately lacks pieces
    "throttle": 0.0,    # 429 is backpressure, not misbehavior
}

DEFAULT_THRESHOLD = 3.0
DEFAULT_HALF_LIFE_S = 30.0
DEFAULT_QUARANTINE_S = 60.0


class DecayingPenalty:
    """One key's penalty state: exponentially-decaying score + the
    quarantine window it last earned."""

    __slots__ = ("score", "updated_at", "quarantined_until")

    def __init__(self):
        self.score = 0.0
        self.updated_at = 0.0
        self.quarantined_until = 0.0

    def current(self, now: float, half_life_s: float) -> float:
        if self.score <= 0.0:
            return 0.0
        dt = max(0.0, now - self.updated_at)
        return self.score * 0.5 ** (dt / half_life_s)

    def add(self, weight: float, now: float, half_life_s: float) -> float:
        self.score = self.current(now, half_life_s) + weight
        self.updated_at = now
        return self.score


def penalize_entry(entry: DecayingPenalty, reason: str, now: float, *,
                   threshold: float = DEFAULT_THRESHOLD,
                   half_life_s: float = DEFAULT_HALF_LIFE_S,
                   quarantine_s: float = DEFAULT_QUARANTINE_S) -> bool:
    """Apply one reason-weighted strike to ``entry``; returns True when it
    just ENTERED quarantine (callers report that edge, not every hit).
    The single penalty discipline both the daemon registry and the
    scheduler's per-host record use — they must never diverge."""
    weight = REASON_WEIGHTS.get(reason, 1.0)
    if weight <= 0.0:
        return False
    was = now < entry.quarantined_until
    score = entry.add(weight, now, half_life_s)
    if score >= threshold:
        # Repeat offenders extend the window from *now*: the bound is on
        # silence-after-last-offense, not first-offense age.
        entry.quarantined_until = now + quarantine_s
    return (now < entry.quarantined_until) and not was


class ParentQuarantine:
    """Keyed penalty registry. ``penalize`` returns True when the key just
    ENTERED quarantine (callers count/report that edge, not every hit)."""

    def __init__(self, *, threshold: float = DEFAULT_THRESHOLD,
                 half_life_s: float = DEFAULT_HALF_LIFE_S,
                 quarantine_s: float = DEFAULT_QUARANTINE_S,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.half_life_s = half_life_s
        self.quarantine_s = quarantine_s
        self._clock = clock
        self._entries: dict[str, DecayingPenalty] = {}

    def penalize(self, key: str, reason: str) -> bool:
        if not key:
            return False
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = DecayingPenalty()
        return penalize_entry(e, reason, self._clock(),
                              threshold=self.threshold,
                              half_life_s=self.half_life_s,
                              quarantine_s=self.quarantine_s)

    def is_quarantined(self, key: str) -> bool:
        e = self._entries.get(key)
        return e is not None and self._clock() < e.quarantined_until

    def score(self, key: str) -> float:
        e = self._entries.get(key)
        if e is None:
            return 0.0
        return e.current(self._clock(), self.half_life_s)

    def quarantined_keys(self) -> list[str]:
        now = self._clock()
        return [k for k, e in self._entries.items()
                if now < e.quarantined_until]

    def gc(self, max_entries: int = 4096) -> None:
        """Bound the registry: fully-decayed, unquarantined entries go
        first; called opportunistically by owners."""
        if len(self._entries) <= max_entries:
            return
        now = self._clock()
        for k in [k for k, e in self._entries.items()
                  if now >= e.quarantined_until
                  and e.current(now, self.half_life_s) < 0.05]:
            del self._entries[k]
