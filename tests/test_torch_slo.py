"""The port's SLO engine (``dragonfly2_tpu_torch/pkg/slo.py``) against the
JAX one (``dragonfly2_tpu/pkg/slo.py``), exactly.

The same seeded completions (numpy, fixed seeds), fleet series (each
package's ``FleetTimeSeries`` on one fake clock, fed the same counts and
gauges) and probes go through both engines at injected ``now=``
instants: ``evaluate`` and ``report`` answer equal dicts (burn rates,
states, events, bad counts, breach totals, the breached list), the
exported burn gauges and breach counters carry equal values, and the
spec sets (``DEFAULT_SLOS``, ``RUNTIME_SLOS``, ``TENANT_SLOS``) are
field-for-field the same. The construction refusals raise alike. The
cases of ``tests/test_podlens.py``'s ``TestSLOEngine`` and
``tests/test_prof.py``'s ``TestLoopLagSLO`` run on both packages.
Tolerance 0: the same float operations in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from dragonfly2_tpu.pkg import fleet as jfleet
from dragonfly2_tpu.pkg import metrics as jmetrics
from dragonfly2_tpu.pkg import slo as jslo
from dragonfly2_tpu_torch.pkg import fleet as pfleet
from dragonfly2_tpu_torch.pkg import metrics as pmetrics
from dragonfly2_tpu_torch.pkg import slo as pslo

PKGS = {"jax": (jslo, jfleet), "port": (pslo, pfleet)}


def test_spec_sets_match():
    for name in ("DEFAULT_SLOS", "RUNTIME_SLOS", "TENANT_SLOS"):
        j, p = getattr(jslo, name), getattr(pslo, name)
        assert [dataclasses.asdict(s) for s in j] == [
            dataclasses.asdict(s) for s in p], name
    assert [s.name for s in pslo.RUNTIME_SLOS] == ["loop_lag"]
    assert {f.name for f in dataclasses.fields(jslo.SLOSpec)} == {
        f.name for f in dataclasses.fields(pslo.SLOSpec)}


@pytest.mark.parametrize("spec", [
    dict(objective=0.9, burn_thresholds=(12.0, 6.0)),     # unreachable
    dict(windows=(60.0,), burn_thresholds=(14.4, 6.0)),  # misaligned
], ids=["ceiling", "misaligned"])
def test_construction_refusals_match(spec):
    msgs = []
    for mod in (jslo, pslo):
        with pytest.raises(ValueError) as e:
            mod.SLOEngine((mod.SLOSpec("x", "completion", **spec),))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _engines(*, series=False, probes=None, **kw):
    clock = [1000.0]
    out = []
    for mod, fleet in ((jslo, jfleet), (pslo, pfleet)):
        s = None
        if series:
            s = fleet.FleetTimeSeries(
                clock=lambda: clock[0],
                sampler=lambda: {"straggler_hosts": float(clock[0] % 3)})
        out.append(mod.SLOEngine(series=s, probes=probes,
                                 clock=lambda: clock[0], **kw))
    return clock, out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_completions_series_and_probes_evaluate_alike(seed):
    """Seeded completions (some unmeasurable TTFBs), counter and gauge
    columns in the fleet series and a probe (a function of the clock);
    evaluated as the completions arrive (the engine's own rate-limited
    evaluation), at several instants as the windows slide, and through
    ``report``."""
    rng = np.random.default_rng(seed)
    clock, (j, p) = _engines(series=True, max_completions=64)
    calls = {id(j): [], id(p): []}

    def probe_for(eng):
        def probe(window, threshold):
            calls[id(eng)].append((window, threshold))
            return float(clock[0] % 7.0), 100.0
        return probe

    for eng in (j, p):
        eng.probes["loop_lag"] = probe_for(eng)
    for step in range(40):
        clock[0] += float(rng.uniform(0, 120))
        n_regs = int(rng.integers(0, 6))
        n_back = int(rng.integers(0, n_regs + 1))
        for eng, fleet in ((j, jfleet), (p, pfleet)):
            for _ in range(n_regs):
                eng.series.inc(fleet.C_REGISTERS)
            for _ in range(n_back):
                eng.series.inc(fleet.C_BACK_SOURCE)
        for _ in range(int(rng.integers(0, 5))):
            host = f"h{int(rng.integers(0, 4))}"
            vals = (float(rng.uniform(0, 90)),
                    float(rng.uniform(-1, 8)),
                    float(rng.uniform(0, 0.6)))
            for eng in (j, p):
                eng.note_completion(host, vals[0], ttfb_s=vals[1],
                                    stall_frac=vals[2], now=clock[0])
        if step % 5 == 4:
            assert j.evaluate(now=clock[0]) == p.evaluate(now=clock[0])
    assert j.report() == p.report()
    assert j.completions_total == p.completions_total
    assert calls[id(j)] == calls[id(p)] and calls[id(j)]


@pytest.mark.parametrize("pkg", PKGS)
def test_failing_probe_degrades_to_no_data(pkg):
    mod, _ = PKGS[pkg]

    def bad(window, threshold):
        raise RuntimeError("boom")

    eng = mod.SLOEngine(probes={"loop_lag": bad})
    ll = next(s for s in eng.evaluate()["slos"] if s["name"] == "loop_lag")
    assert ll["state"] == "no_data"


def test_exported_gauges_and_breach_counters_match():
    """The same breach through both engines sets each registry's
    ``scheduler_slo_burn_rate`` children and counts one
    ``scheduler_slo_breaches_total`` transition in each."""
    spec = dict(name="torch_slo_probe_spec", kind="completion",
                field="stall_frac", threshold=0.25, objective=0.99)
    engines = [mod.SLOEngine((mod.SLOSpec(**spec),), clock=lambda: 0.0)
               for mod in (jslo, pslo)]
    for eng in engines:
        eng.note_completion("h", 1.0, stall_frac=0.9, now=0.0)
        eng.evaluate(now=1.0)
        eng.evaluate(now=2.0)
    for text in (jmetrics.render()[0].decode(),
                 pmetrics.render()[0].decode()):
        lines = set(text.splitlines())
        for window in ("300s", "3600s"):
            assert any(line.endswith(
                f'slo_burn_rate{{slo="torch_slo_probe_spec",'
                f'window="{window}"}} 100.0') for line in lines), window
        assert any(line.endswith(
            'slo_breaches_total{slo="torch_slo_probe_spec"} 1.0')
            for line in lines)


# The cases of tests/test_podlens.py's TestSLOEngine and
# tests/test_prof.py's TestLoopLagSLO, on both packages.

@pytest.mark.parametrize("pkg", PKGS)
def test_seeded_degradation_flips_burn_over_threshold(pkg):
    mod, _ = PKGS[pkg]
    clock = [100.0]
    eng = mod.SLOEngine(clock=lambda: clock[0])
    for _ in range(6):
        eng.note_completion("h-ok", 2.0, ttfb_s=0.1, stall_frac=0.01)
    sf = next(s for s in eng.evaluate()["slos"]
              if s["name"] == "stall_fraction")
    assert sf["state"] == "ok"
    eng.note_completion("h-bad", 3.0, ttfb_s=0.2, stall_frac=0.8)
    rep = eng.evaluate()
    sf = next(s for s in rep["slos"] if s["name"] == "stall_fraction")
    assert sf["state"] == "breach" and "stall_fraction" in rep["breached"]


@pytest.mark.parametrize("pkg", PKGS)
def test_breach_counter_is_edge_triggered(pkg):
    mod, _ = PKGS[pkg]
    clock = [0.0]
    eng = mod.SLOEngine(clock=lambda: clock[0])
    eng.note_completion("h", 1.0, stall_frac=0.9)
    for _ in range(4):
        rep = eng.evaluate()
    sf = next(s for s in rep["slos"] if s["name"] == "stall_fraction")
    assert sf["breaches_total"] == 1
    clock[0] += 4000.0
    for _ in range(3):
        eng.note_completion("h", 1.0, stall_frac=0.0)
    eng.evaluate()
    eng.note_completion("h", 1.0, stall_frac=0.9)
    sf = next(s for s in eng.evaluate()["slos"]
              if s["name"] == "stall_fraction")
    assert sf["breaches_total"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_ratio_sli_reads_fleet_series(pkg):
    mod, fleet = PKGS[pkg]
    clock = [50.0]
    series = fleet.FleetTimeSeries(clock=lambda: clock[0])
    for _ in range(10):
        series.inc(fleet.C_REGISTERS)
    for _ in range(8):
        series.inc(fleet.C_BACK_SOURCE)
    eng = mod.SLOEngine(series=series, clock=lambda: clock[0])
    bs = next(s for s in eng.evaluate()["slos"]
              if s["name"] == "back_source_rate")
    w = bs["windows"][0]
    assert w["events"] == 10 and w["bad"] == 8
    assert w["burn_rate"] == pytest.approx(0.8 / 0.25, rel=1e-3)
    assert bs["state"] == "breach"


@pytest.mark.parametrize("pkg", PKGS)
def test_no_data_without_series_or_completions(pkg):
    mod, _ = PKGS[pkg]
    rep = mod.SLOEngine().evaluate()
    assert all(s["state"] == "no_data" for s in rep["slos"])


@pytest.mark.parametrize("pkg", PKGS)
def test_probe_kind_breaches_on_wedged_time(pkg):
    mod, _ = PKGS[pkg]
    eng = mod.SLOEngine(mod.RUNTIME_SLOS,
                        probes={"loop_lag": lambda w, t: (30.0, 100.0)})
    ll = eng.evaluate()["slos"][0]
    assert ll["name"] == "loop_lag" and ll["state"] == "breach"
    eng.probes["loop_lag"] = lambda w, t: (500.0, 100.0)   # clamped
    ll = eng.evaluate()["slos"][0]
    assert all(w["bad"] <= w["events"] for w in ll["windows"])
