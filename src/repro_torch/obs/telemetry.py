"""Telemetry facade: one object carrying a deployment's trace buffer and
metrics registry through both runtimes (docs/observability.md §1).

A :class:`Telemetry` is created per harness from ``SimConfig`` and threaded
into the network fabric, checkpoint storage, consumer, and every node — the
single owner of the bounded :class:`~repro_torch.obs.records.TraceBuffer` and the
:class:`~repro_torch.obs.registry.MetricsRegistry`, so net records and protocol
spans land in ONE time-ordered stream the auditor can replay.

Two independent switches:

* ``trace_net`` (``SimConfig.net_trace`` or ``obs``) — record one
  ``net.msg`` per fabric send attempt;
* ``on`` (``SimConfig.obs``) — record protocol spans/events and registry
  metrics (implies net records: the auditor's ack cross-check needs them).

Both default off.  Recording never draws RNG, never reads the wall clock,
and never schedules simulator events, so with telemetry off the runtimes are
bit-identical to a build without this module, and with it on the same seed
exports byte-identical traces (tests/test_obs.py).
"""
from __future__ import annotations

from repro_torch.obs.records import TraceBuffer, TraceEvent, mkargs, to_chrome, to_jsonl
from repro_torch.obs.registry import MetricsRegistry


class Telemetry:
    __slots__ = ("sim", "on", "trace_net", "buf", "registry", "snapshot_ms",
                 "_subs")

    def __init__(self, sim, on: bool = False, trace_net: bool = False,
                 cap: int = 1 << 16, snapshot_ms: float = 500.0,
                 spill_path: str = ""):
        self.sim = sim
        self.on = bool(on)
        self.trace_net = bool(trace_net) or self.on
        self.buf = TraceBuffer(cap, spill_path=spill_path)
        self.registry = MetricsRegistry()
        self.snapshot_ms = float(snapshot_ms)
        # passive subscribers (obs/monitor.py): each appended record is also
        # handed to every subscriber, in append order.  Subscribers must be
        # passive too — no RNG, no sim events — so subscribing cannot perturb
        # the run; with none registered the append path is unchanged.
        self._subs: tuple = ()

    @classmethod
    def from_config(cls, sim, cfg) -> "Telemetry":
        """The one place SimConfig's obs knobs become a telemetry instance —
        both runtimes build theirs here, mirroring NetworkFabric.from_config.
        ``obs_monitor`` implies ``obs``: the online monitor consumes the
        record stream, so enabling it turns recording on."""
        return cls(
            sim,
            on=cfg.obs or getattr(cfg, "obs_monitor", False),
            trace_net=cfg.net_trace,
            cap=cfg.obs_trace_cap,
            snapshot_ms=cfg.obs_snapshot_ms,
            spill_path=getattr(cfg, "obs_spill_path", ""),
        )

    # ---- subscription ------------------------------------------------------
    def subscribe(self, fn) -> None:
        """Register ``fn(event)`` to observe every appended record (net and
        protocol), in append order — the online monitor's feed."""
        self._subs = self._subs + (fn,)

    def unsubscribe(self, fn) -> None:
        # equality, not identity: a bound method like ``monitor.feed`` is a
        # fresh object on every attribute access, but compares equal
        self._subs = tuple(f for f in self._subs if f != fn)

    # ---- recording ---------------------------------------------------------
    def net_msg(self, src, dst, cls: str, nbytes: float, status: str,
                t_deliver: float = -1.0, retries: int = 0) -> None:
        if self.trace_net:
            ev = TraceEvent(
                t_ms=self.sim.now, kind="net.msg", src=src, dst=dst, cls=cls,
                nbytes=nbytes, status=status, t_end_ms=t_deliver,
                args=(("retries", retries),) if retries else (),
            )
            self.buf.append(ev)
            if self._subs:
                for fn in self._subs:
                    fn(ev)

    def event(self, kind: str, node=None, partition: int = -1,
              window: int = -1, src=None, dst=None, status: str = "",
              t_end_ms: float = -1.0, **args) -> None:
        """Protocol span/event (gated on ``on``; call sites in hot paths
        guard with ``if obs.on`` themselves to skip building kwargs)."""
        if self.on:
            ev = TraceEvent(
                t_ms=self.sim.now, kind=kind, node=node, partition=partition,
                window=window, src=src, dst=dst, status=status,
                t_end_ms=t_end_ms, args=mkargs(**args) if args else (),
            )
            self.buf.append(ev)
            if self._subs:
                for fn in self._subs:
                    fn(ev)

    # ---- scheduling --------------------------------------------------------
    def start_snapshots(self) -> None:
        """Periodic registry snapshots on sim-time (no-op when ``on`` is
        False).  Snapshots only read state — they cannot affect the run."""
        if not self.on:
            return

        def snap():
            self.registry.snapshot(self.sim.now)
            self.sim.after(self.snapshot_ms, snap)

        self.sim.after(self.snapshot_ms, snap)

    # ---- access / export ---------------------------------------------------
    def events(self) -> tuple[TraceEvent, ...]:
        return self.buf.events()

    def all_events(self) -> list[TraceEvent]:
        """Spill spool + resident ring: the complete record stream (equal to
        ``events()`` when no spill is configured or nothing spilled)."""
        return self.buf.all_events()

    def net_events(self) -> list[TraceEvent]:
        return [ev for ev in self.buf if ev.kind == "net.msg"]

    def export_jsonl(self) -> str:
        return to_jsonl(self.buf, dropped=self.buf.dropped)

    def export_chrome(self) -> dict:
        return to_chrome(self.buf)
