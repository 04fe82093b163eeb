"""Output-stream consumer: dedup + end-to-end latency / throughput metrics.

The paper considers duplicated outputs exactly-once because a consumer can
deduplicate by (partition, window) tags (§3.3).  This consumer implements
exactly that and doubles as the measurement probe: end-to-end latency of a
window = first emission sim-time − window-close event-time (the analogue of
the paper's Kafka-insertion-timestamp latency).

With telemetry attached (docs/observability.md §1) every accepted/duplicate
emission also feeds the metrics registry (``windows_emitted`` /
``windows_duplicate`` counters, ``emit_lag_ms`` phase histogram); the
percentile summaries behind ``latency_stats`` are the shared
:func:`repro_torch.obs.registry.summary` implementation, so benchmark rows and
consumer probes can never disagree on how a p99 is computed.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.obs.registry import summary


@dataclasses.dataclass
class WindowRecord:
    partition: int
    window: int
    value: Any
    emit_time: float
    latency: float
    duplicates: int = 0


class Consumer:
    def __init__(self, window_len: float, assigner=None, telemetry=None):
        # ``assigner`` (core.window.WindowAssigner) supplies window extents;
        # None keeps the tumbling arithmetic for legacy callers.
        self.window_len = window_len
        self.assigner = assigner
        self.obs = telemetry  # Telemetry or None (docs/observability.md §1)
        self.records: dict[tuple[int, int], WindowRecord] = {}
        self.events_consumed: list[tuple[float, int]] = []  # (time, count)
        self.duplicates = 0
        # sync-bandwidth probe, filled by the runtime at end of run:
        # bytes actually shipped (delta or full) vs the full-state cost
        self.sync_msgs = 0
        self.sync_nacks = 0
        self.sync_bytes = 0.0
        self.sync_bytes_full = 0.0
        # per-message-class fabric meters ({cls: {msgs, bytes, dropped,
        # retries}}), filled from NetworkFabric.class_stats() at end of run
        self.net_stats: dict[str, dict] = {}

    # -- output path --------------------------------------------------------
    def emit(self, t: float, partition: int, window: int, value) -> bool:
        """Returns True if this was a new (non-duplicate) output."""
        key = (partition, window)
        if key in self.records:
            self.records[key].duplicates += 1
            self.duplicates += 1
            if self.obs is not None and self.obs.on:
                self.obs.registry.counter("windows_duplicate").inc()
            return False
        close_ts = self._close_ts(window)
        lag = max(0.0, t - close_ts)
        self.records[key] = WindowRecord(
            partition=partition,
            window=window,
            value=value,
            emit_time=t,
            latency=lag,
        )
        if self.obs is not None and self.obs.on:
            self.obs.registry.counter("windows_emitted").inc()
            self.obs.registry.histogram("phase_ms", phase="emit").observe(lag)
        return True

    def count_events(self, t: float, n: int) -> None:
        self.events_consumed.append((t, n))

    def _close_ts(self, window: int) -> float:
        """Event-time close of a window — the latency zero point."""
        if self.assigner is not None:
            return float(self.assigner.end_ts(window))
        return (window + 1) * self.window_len

    # -- metrics -------------------------------------------------------------
    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.records.values()], dtype=np.float64)

    def latency_series(self) -> tuple[np.ndarray, np.ndarray]:
        """(window close time, latency) sorted by time — Fig 6 style."""
        recs = sorted(self.records.values(), key=lambda r: (r.window, r.partition))
        t = np.array([self._close_ts(r.window) for r in recs])
        lat = np.array([r.latency for r in recs])
        return t, lat

    def latency_stats(self) -> dict[str, float]:
        # the one shared summary implementation (repro_torch.obs.registry.summary):
        # benchmark rows, the auditor, and this probe all agree on percentiles
        return summary(self.latencies())

    def throughput_series(self, bucket_ms: float = 1000.0) -> tuple[np.ndarray, np.ndarray]:
        if not self.events_consumed:
            return np.array([]), np.array([])
        ts = np.array([t for t, _ in self.events_consumed])
        ns = np.array([n for _, n in self.events_consumed], dtype=np.float64)
        t_end = ts.max() + bucket_ms
        edges = np.arange(0.0, t_end + bucket_ms, bucket_ms)
        idx = np.digitize(ts, edges) - 1
        out = np.zeros(len(edges) - 1)
        np.add.at(out, idx, ns)
        return edges[:-1], out / (bucket_ms / 1000.0)  # events/sec

    def sensitivity(self, baseline: "Consumer") -> float:
        """Paper §5.1 (Stabl [19]): area between the latency curve under
        failures and the failure-free baseline curve, per common window."""
        base = {k: r.latency for k, r in baseline.records.items()}
        delta = 0.0
        for k, r in self.records.items():
            if k in base:
                delta += max(0.0, r.latency - base[k]) * 1e-3  # ms * window -> s
        return delta
