"""Holoscope, the port of ``repro.obs``: deterministic telemetry for the
Holon runtimes (docs/observability.md).

Every layer is host Python over the trace records, strictly passive (no RNG
draws, no wall-clock reads in sim paths, no simulator events, no device
reads), so a run on the card and the same run on the host export the same
bytes:

* **metrics registry** (obs/registry.py) and **structured span tracing**
  (obs/records.py, obs/telemetry.py), exported to JSONL and Chrome
  trace-event format;
* **protocol auditor** (obs/audit.py): replays a trace and asserts the
  paper's invariants (exactly-once, monotone frontiers, causal domination,
  acked merges, bounded recovery), extracting time-to-recover and
  time-to-settle;
* **critical-path analyzer** (obs/critpath.py): per emitted window, the
  causal chain that gated the emission, attributed to phases;
* **online monitor** (obs/monitor.py): the auditor's invariants plus health
  alerts, incrementally over the live telemetry stream
  (``SimConfig.obs_monitor``);
* the wall-clock and sim-time timers (obs/timing.py).
"""
from repro_torch.obs.audit import AuditReport, audit, audit_harness
from repro_torch.obs.critpath import (
    CritPath,
    CritPathReport,
    WatermarkTracker,
    analyze,
    analyze_harness,
)
from repro_torch.obs.monitor import Alert, OnlineMonitor, replay
from repro_torch.obs.records import (
    TraceBuffer,
    TraceEvent,
    event_json,
    from_jsonl,
    mkargs,
    to_chrome,
    to_jsonl,
)
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry, summary
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.timing import SimTimer, WallTimer

__all__ = [
    "AuditReport",
    "audit",
    "audit_harness",
    "CritPath",
    "CritPathReport",
    "WatermarkTracker",
    "analyze",
    "analyze_harness",
    "Alert",
    "OnlineMonitor",
    "replay",
    "TraceBuffer",
    "TraceEvent",
    "event_json",
    "from_jsonl",
    "mkargs",
    "to_chrome",
    "to_jsonl",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "summary",
    "Telemetry",
    "SimTimer",
    "WallTimer",
]
