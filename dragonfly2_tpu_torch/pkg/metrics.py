"""Get-or-create counters with the JAX package's family names, stdlib only.

The JAX package wraps ``prometheus_client`` (``dragonfly2_tpu/pkg/metrics.py``).
The port runs where that package is not installed, so it keeps a small
thread-safe registry of labeled counters with the same family names
(``device_sink_landed_bytes_total``, ``device_sink_verify_total{result}``).
Declaring a family twice returns the first declaration, as in the JAX
package; declaring it with other labels is a programming error.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_metrics: dict[str, "Counter"] = {}


class Counter:
    """A monotonically increasing counter, optionally labeled."""

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

    def inc(self, amount: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call labels() first")
        self._add((), amount)

    def _add(self, key: tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError("counters only increase")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *labelvalues) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in labelvalues), 0.0)


class _Child:
    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: tuple[str, ...]):
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._counter._add(self._key, amount)


def counter(name: str, doc: str, labels: tuple[str, ...] = ()) -> Counter:
    with _lock:
        existing = _metrics.get(name)
        if existing is not None:
            if existing.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{existing.labelnames}")
            return existing
        c = Counter(name, doc, labels)
        _metrics[name] = c
        return c

