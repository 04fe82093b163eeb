"""Metrics registry: counters / gauges / histograms keyed by labels, with
sim-time snapshots (docs/observability.md §1).

Metrics are identified by ``name`` + key-sorted labels (e.g.
``batches_folded{node=3}``), so collection order is deterministic and two
same-seed runs collect byte-identical values.  ``snapshot(t_ms)`` appends the
current values to an in-memory timeseries on **simulated** timestamps — the
registry never reads the wall clock, so metrics cannot perturb a run or
conflate sim-time with wall-time (that split lives in obs/timing.py).

Histograms use fixed power-of-two bucket edges: observation is O(log B) with
no allocation, percentiles are bucket-resolution approximations (exact
percentiles for benchmark headline numbers come from :func:`summary` over the
raw values — the one shared implementation behind ``Consumer.latency_stats``
and the ``benchmarks/common.py`` helpers).
"""
from __future__ import annotations

import bisect
import math
from typing import Iterable

# bucket upper edges: 1, 2, 4, … 2^19 ms (~8.7 min), then +inf
_EDGES = tuple(float(1 << i) for i in range(20))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def collect(self) -> dict[str, float]:
        return {"": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def collect(self) -> dict[str, float]:
        return {"": self.value}


class Histogram:
    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets = [0] * (len(_EDGES) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[bisect.bisect_left(_EDGES, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile (upper edge of the q-quantile
        bucket, clamped to the observed max) — cheap, deterministic, good
        enough for per-phase breakdown rows."""
        if not self.count:
            return float("nan")
        rank = q / 100.0 * self.count
        acc = 0
        for i, n in enumerate(self.buckets):
            acc += n
            if acc >= rank and n:
                edge = _EDGES[i] if i < len(_EDGES) else self.max
                return float(min(edge, self.max))
        return float(self.max)

    def collect(self) -> dict[str, float]:
        return {".count": self.count, ".sum": self.sum}


class MetricsRegistry:
    """All metrics of one deployment.  ``counter``/``gauge``/``histogram``
    get-or-create; ``collect`` returns a key-sorted flat mapping; ``snapshot``
    appends it to the sim-time ``series``."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self.series: list[tuple[float, dict[str, float]]] = []

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        return f"{name}{{{inner}}}"

    def _get(self, ctor, name: str, labels: dict):
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = ctor()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def collect(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for key in sorted(self._metrics):
            for suffix, v in self._metrics[key].collect().items():
                out[key + suffix] = v
        return out

    def snapshot(self, t_ms: float) -> None:
        self.series.append((float(t_ms), self.collect()))

    def histograms(self, name: str) -> dict[str, Histogram]:
        """All histograms whose metric name matches ``name`` (any labels)."""
        return {
            k: m
            for k, m in self._metrics.items()
            if isinstance(m, Histogram) and (k == name or k.startswith(name + "{"))
        }


def summary(values: Iterable[float]) -> dict[str, float]:
    """Exact latency summary — THE shared percentile implementation: both
    ``Consumer.latency_stats`` and the benchmark row helpers call this, so
    avg/p50/p99 can never drift between reports."""
    import numpy as np

    xs = np.asarray(list(values), dtype=np.float64)
    if xs.size == 0:
        return {"avg": float("nan"), "p50": float("nan"), "p99": float("nan"),
                "max": float("nan"), "n": 0}
    return {
        "avg": float(np.mean(xs)),
        "p50": float(np.percentile(xs, 50)),
        "p99": float(np.percentile(xs, 99)),
        "max": float(np.max(xs)),
        "n": int(xs.size),
    }
