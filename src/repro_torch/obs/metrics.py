"""Lock-safe metrics registry: counters, gauges, histograms.

One ``MetricsRegistry`` per serving scheduler (and one per engine for
engine-lifetime counters).  Instruments are get-or-created by name +
labels — ``reg.counter("serve.calls", module="mini-vit")`` — and every
instrument mutation happens under the registry's lock, which each
instrument holds a reference to.  That invariant is enforced statically
by ``repro_torch.analysis.concurrency_lint``'s ``obs/unlocked-metric-mutation``
rule: any class declaring ``kind = "counter" | "gauge" | "histogram"``
must mutate its state only inside ``with self._lock`` blocks.

Histograms keep their raw samples (serving workloads here are
thousands of requests, not millions) so per-task p50/p99 and
SLO-attainment summaries (``obs.summary``) are exact, not bucketed.
The scheduler's legacy ``stats_dict()`` remains as a compatibility
view computed from these instruments.
"""

from __future__ import annotations

import threading
from typing import Any


def _key(name: str, labels: dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Instrument:
    """Base: name + labels + the registry lock all mutations hold."""

    kind = ""

    def __init__(self, name: str, labels: dict[str, Any],
                 lock: threading.RLock):
        self.name = name
        self.labels = dict(labels)
        self._lock = lock

    @property
    def key(self) -> str:
        return _key(self.name, self.labels)


class Counter(Instrument):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        with self._lock:
            self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key}: cannot inc by {n}")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(Instrument):
    """Point-in-time value (``set``) with a running-max helper."""

    kind = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        with self._lock:
            self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def track_max(self, v) -> None:
        with self._lock:
            self._value = max(self._value, v)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(Instrument):
    """Exact distribution: raw samples plus count/sum/min/max."""

    kind = "histogram"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        with self._lock:
            self._samples: list[float] = []
            self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return (self._sum / len(self._samples)) if self._samples else 0.0

    @property
    def max(self) -> float:
        with self._lock:
            return max(self._samples, default=0.0)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the raw samples (0 when empty)."""
        with self._lock:
            if not self._samples:
                return 0.0
            xs = sorted(self._samples)
        rank = max(0, min(len(xs) - 1,
                          round(p / 100.0 * (len(xs) - 1))))
        return xs[int(rank)]

    def summary(self) -> dict[str, float]:
        return {"count": self.count, "sum": round(self.sum, 6),
                "mean": round(self.mean, 6),
                "p50": round(self.percentile(50), 6),
                "p99": round(self.percentile(99), 6),
                "max": round(self.max, 6)}


class MetricsRegistry:
    """Get-or-create instrument store; one lock guards every mutation."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: dict[str, Instrument] = {}

    def _get_or_create(self, cls, name: str, labels: dict[str, Any]):
        key = _key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, self._lock)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {key!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels)

    # -- queries --------------------------------------------------------
    def get(self, name: str, **labels) -> Instrument | None:
        with self._lock:
            return self._instruments.get(_key(name, labels))

    def value(self, name: str, default=0, **labels):
        inst = self.get(name, **labels)
        return default if inst is None else inst.value

    def instruments(self, name: str | None = None) -> list[Instrument]:
        with self._lock:
            out = list(self._instruments.values())
        return out if name is None else [i for i in out if i.name == name]

    def total(self, name: str) -> float:
        """Sum of a counter/gauge family's values across all label sets."""
        return sum(i.value for i in self.instruments(name)
                   if not isinstance(i, Histogram))

    def label_values(self, name: str, label: str) -> list[str]:
        return sorted({str(i.labels[label]) for i in self.instruments(name)
                       if label in i.labels})

    def snapshot(self) -> dict[str, Any]:
        """Flat ``{key: value}`` view; histograms render their summary."""
        out: dict[str, Any] = {}
        for inst in self.instruments():
            out[inst.key] = (inst.summary()
                             if isinstance(inst, Histogram) else inst.value)
        return out
