"""Get-or-create counters and gauges with the JAX package's family names,
stdlib only.

The JAX package wraps ``prometheus_client`` (``dragonfly2_tpu/pkg/metrics.py``).
The port runs where that package is not installed, so it keeps a small
thread-safe registry of labeled counters and gauges with the same family
names (``device_sink_landed_bytes_total``, ``dataset_readahead_depth``,
``bufpool_retained_bytes{pool}``). Declaring a family twice returns the
first declaration, as in the JAX package; declaring it again as another
kind or with other labels is a programming error. The registry is the
port's own: it never touches ``prometheus_client``'s, so a process that
imports both packages holds two families of one name, one in each.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_metrics: dict[str, "Counter | Gauge"] = {}


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


class _Child:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._add(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        if not isinstance(self._metric, Gauge):
            raise ValueError(f"{self._metric.name}: counters only increase")
        self._metric._add(self._key, -amount)

    def set(self, value: float) -> None:
        if not isinstance(self._metric, Gauge):
            raise ValueError(f"{self._metric.name}: a counter cannot be set")
        self._metric._set(self._key, value)


def _get_or_create(kind: type, name: str, doc: str,
                   labels: tuple[str, ...]):
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
        m = kind(name, doc, labels)
        _metrics[name] = m
        return m


def counter(name: str, doc: str, labels: tuple[str, ...] = ()) -> Counter:
    return _get_or_create(Counter, name, doc, labels)


def gauge(name: str, doc: str, labels: tuple[str, ...] = ()) -> Gauge:
    return _get_or_create(Gauge, name, doc, labels)


def render() -> tuple[bytes, str]:
    """Every family in the Prometheus text format, and its content type
    (the upload server's ``/metrics``)."""
    lines = []
    with _lock:
        families = sorted(_metrics.items())
    for name, m in families:
        kind = "counter" if isinstance(m, Counter) else "gauge"
        lines += [f"# HELP {name} {m.doc}", f"# TYPE {name} {kind}"]
        with m._lock:
            values = sorted(m._values.items())
        for key, value in values:
            labels = ",".join(f'{k}="{v}"' for k, v in zip(m.labelnames, key))
            lines.append(f"{name}{{{labels}}} {value}" if labels
                         else f"{name} {value}")
    return ("\n".join(lines) + "\n").encode(), \
        "text/plain; version=0.0.4; charset=utf-8"
