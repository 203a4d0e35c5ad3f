"""The port's parent quarantine against the JAX package's.

``dragonfly2_tpu_torch/pkg/quarantine.py`` is a copy of
``dragonfly2_tpu/pkg/quarantine.py``. The same seeded sequences of strikes
(a key, a typed reason, a step of an injected clock) go to both
registries, and every answer is compared: ``penalize``'s edge,
``is_quarantined``, ``score`` and ``quarantined_keys`` after each step,
and what ``gc`` keeps. Tolerance 0: both compute the same float
expressions in the same order.
"""

from __future__ import annotations

import numpy as np
import pytest

from dragonfly2_tpu.pkg import quarantine as jq
from dragonfly2_tpu_torch.pkg import quarantine as pq

REASONS = sorted(jq.REASON_WEIGHTS) + ["unknown-reason"]
KEYS = [f"10.0.0.{i}:6500{i}" for i in range(5)]


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _pair(**kw):
    jc, pc = Clock(), Clock()
    return (jq.ParentQuarantine(clock=jc, **kw), jc,
            pq.ParentQuarantine(clock=pc, **kw), pc)


def test_the_tables_are_the_jax_ones():
    assert pq.REASON_WEIGHTS == jq.REASON_WEIGHTS
    assert (pq.DEFAULT_THRESHOLD, pq.DEFAULT_HALF_LIFE_S,
            pq.DEFAULT_QUARANTINE_S) == (jq.DEFAULT_THRESHOLD,
                                         jq.DEFAULT_HALF_LIFE_S,
                                         jq.DEFAULT_QUARANTINE_S)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("knobs", [
    {}, {"threshold": 2.0, "half_life_s": 5.0, "quarantine_s": 7.5}],
    ids=["defaults", "tight"])
def test_the_same_strikes_give_the_same_decisions(seed, knobs):
    rng = np.random.RandomState(seed)
    jreg, jc, preg, pc = _pair(**knobs)
    for _ in range(200):
        step = float(rng.exponential(4.0))
        jc.now += step
        pc.now += step
        key = KEYS[rng.randint(len(KEYS))]
        reason = REASONS[rng.randint(len(REASONS))]
        assert preg.penalize(key, reason) == jreg.penalize(key, reason)
        for k in KEYS:
            assert preg.is_quarantined(k) == jreg.is_quarantined(k)
            assert preg.score(k) == jreg.score(k)
        assert preg.quarantined_keys() == jreg.quarantined_keys()
    # An empty key is never penalized.
    assert preg.penalize("", "corrupt") is jreg.penalize("", "corrupt") \
        is False


def test_a_corrupt_strike_quarantines_until_its_window_lapses():
    jreg, jc, preg, pc = _pair()
    for reg in (jreg, preg):
        assert reg.penalize(KEYS[0], "corrupt") is True
        assert reg.penalize(KEYS[0], "throttle") is False   # no weight
        assert reg.penalize(KEYS[0], "corrupt") is False    # already in
    for c in (jc, pc):
        c.now += jq.DEFAULT_QUARANTINE_S + 0.01
    assert preg.is_quarantined(KEYS[0]) is jreg.is_quarantined(KEYS[0]) \
        is False
    assert preg.score(KEYS[0]) == jreg.score(KEYS[0])


def test_gc_keeps_what_the_jax_gc_keeps():
    jreg, jc, preg, pc = _pair()
    rng = np.random.RandomState(7)
    keys = [f"h{i}:1" for i in range(40)]
    for k in keys:
        step = float(rng.uniform(0, 20))
        jc.now += step
        pc.now += step
        reason = REASONS[rng.randint(len(REASONS))]
        jreg.penalize(k, reason)
        preg.penalize(k, reason)
    for bound in (60, 20, 5):
        jc.now += 120.0
        pc.now += 120.0
        jreg.gc(max_entries=bound)
        preg.gc(max_entries=bound)
        assert sorted(preg._entries) == sorted(jreg._entries)
