"""Get-or-create counters, gauges and histograms with the JAX package's
family names, stdlib only.

The JAX package wraps ``prometheus_client`` (``dragonfly2_tpu/pkg/metrics.py``).
The port runs where that package is not installed, so it keeps a small
thread-safe registry of labeled counters, gauges and histograms with the
same family names (``device_sink_landed_bytes_total``,
``dataset_readahead_depth``, ``bufpool_retained_bytes{pool}``,
``peer_task_phase_seconds{phase}``). A histogram keeps the JAX
declaration's buckets, and ``render`` writes it as ``prometheus_client``
does: for each label set in the order it first appeared, cumulative
``_bucket{...,le=...}`` samples ending at ``+Inf``, then ``_count`` and
``_sum`` (no ``_created`` series), labels sorted by name. Declaring a family twice returns the
first declaration, as in the JAX package; declaring it again as another
kind or with other labels is a programming error. The registry is the
port's own: it never touches ``prometheus_client``'s, so a process that
imports both packages holds two families of one name, one in each.
"""

from __future__ import annotations

import math
import threading

_lock = threading.Lock()
_metrics: dict[str, "Counter | Gauge | Histogram"] = {}



class _Metric:
    """A family of float values keyed by label values."""

    def __init__(self, name: str, doc: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def labels(self, *values) -> "_Child":
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}")
        return _Child(self, tuple(str(v) for v in values))

    def _unlabeled(self) -> tuple[str, ...]:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call labels() first")
        return ()

    def _add(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *labelvalues) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in labelvalues), 0.0)


class Counter(_Metric):
    """A monotonically increasing counter, optionally labeled."""

    def inc(self, amount: float = 1.0) -> None:
        self._add(self._unlabeled(), amount)

    def _add(self, key: tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError("counters only increase")
        super()._add(key, amount)


class Gauge(_Metric):
    """A value that goes up and down, optionally labeled."""

    def set(self, value: float) -> None:
        self._set(self._unlabeled(), value)

    def inc(self, amount: float = 1.0) -> None:
        self._add(self._unlabeled(), amount)

    def dec(self, amount: float = 1.0) -> None:
        self._add(self._unlabeled(), -amount)

    def _set(self, key: tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
    """Labeled observations counted into buckets (``+Inf`` last).
    ``_values`` holds each label set's ``[counts per bucket..., sum]``."""

    def __init__(self, name: str, doc: str, labelnames: tuple[str, ...],
                 buckets):
        super().__init__(name, doc, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)

    def _observe(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0] * len(self.buckets) + [0.0]
            for i, bound in enumerate(self.buckets):
                if amount <= bound:
                    row[i] += 1
                    break
            row[-1] += amount

    def _samples(self, key: tuple[str, ...], row: list) -> list:
        labels = dict(zip(self.labelnames, key))
        out, cumulative = [], 0
        for bound, n in zip(self.buckets, row):
            cumulative += n
            out.append((f"{self.name}_bucket",
                        {**labels, "le": _go_float(bound)}, cumulative))
        out.append((f"{self.name}_count", labels, cumulative))
        out.append((f"{self.name}_sum", labels, row[-1]))
        return out


class _Child:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        if isinstance(self._metric, Histogram):
            raise ValueError(f"{self._metric.name}: a histogram observes")
        self._metric._add(self._key, amount)

    def observe(self, amount: float) -> None:
        if not isinstance(self._metric, Histogram):
            raise ValueError(f"{self._metric.name} is not a histogram")
        self._metric._observe(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        if not isinstance(self._metric, Gauge):
            raise ValueError(f"{self._metric.name}: counters only increase")
        self._metric._add(self._key, -amount)

    def set(self, value: float) -> None:
        if not isinstance(self._metric, Gauge):
            raise ValueError(f"{self._metric.name}: a counter cannot be set")
        self._metric._set(self._key, value)


def _get_or_create(kind: type, name: str, doc: str,
                   labels: tuple[str, ...], **kw):
    with _lock:
        existing = _metrics.get(name)
        if existing is not None:
            if type(existing) is not kind:
                raise ValueError(
                    f"metric {name!r} already registered as a "
                    f"{type(existing).__name__}")
            if existing.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{existing.labelnames}")
            return existing
        m = kind(name, doc, labels, **kw)
        _metrics[name] = m
        return m


def counter(name: str, doc: str, labels: tuple[str, ...] = ()) -> Counter:
    return _get_or_create(Counter, name, doc, labels)


def gauge(name: str, doc: str, labels: tuple[str, ...] = ()) -> Gauge:
    return _get_or_create(Gauge, name, doc, labels)


def histogram(name: str, doc: str, labels: tuple[str, ...],
              buckets) -> Histogram:
    """A labeled histogram family with the declaration's bucket bounds."""
    return _get_or_create(Histogram, name, doc, labels, buckets=buckets)


def _go_float(v: float) -> str:
    """A sample value or bucket bound as prometheus_client writes it
    (its ``floatToGoString``)."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def render() -> tuple[bytes, str]:
    """Every family in the Prometheus text format, and its content type
    (the upload server's ``/metrics``)."""
    lines = []
    with _lock:
        families = sorted(_metrics.items())
    for name, m in families:
        kind = {Counter: "counter", Gauge: "gauge",
                Histogram: "histogram"}[type(m)]
        lines += [f"# HELP {name} {m.doc}", f"# TYPE {name} {kind}"]
        with m._lock:
            # In the order the label sets first appeared, as
            # prometheus_client writes them.
            values = [(k, list(v) if isinstance(v, list) else v)
                      for k, v in m._values.items()]
        for key, value in values:
            samples = (m._samples(key, value) if isinstance(m, Histogram)
                       else [(name, dict(zip(m.labelnames, key)), value)])
            for sample, labels, v in samples:
                text = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
                lines.append(f"{sample}{{{text}}} {_go_float(v)}" if text
                             else f"{sample} {_go_float(v)}")
    return ("\n".join(lines) + "\n").encode(), \
        "text/plain; version=0.0.4; charset=utf-8"
