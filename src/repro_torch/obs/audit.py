"""Trace-driven protocol auditor (docs/observability.md §4).

The runtime is deterministic, so a trace of every protocol event is itself
replayable and checkable: the auditor walks the time-ordered records and
asserts the paper's invariants on what *actually happened*, turning the
suite's oracle-diff-only verification into invariant checking on every
traced run.

Invariants (violation ids in brackets):

* **[exactly-once]** — per (partition, window) exactly one ``emit`` with
  status ``accepted``; re-emissions must be ``duplicate`` and carry the same
  value digest (the consumer-dedup contract of paper §3.3).
* **[frontier-regression]** — the checkpoint store's applied frontier
  (``ckpt.apply`` → stored ``nxt_idx``) is monotone per partition:
  merge-on-put may never regress a checkpoint (Algorithm 2's lattice rule).
* **[domination]** — every applied delta merge (``sync.recv`` status
  ``delta_merge``) had a dominated baseline, and every non-dominated
  delivery was nacked — the causal delta-merging condition.
* **[unacked-merge]** — every merge that carried a marker is matched by a
  ``sync_ack`` send from the merging node to the sender at the same instant
  (cross-checked against the fabric's ``net.msg`` records, not the node's
  own claim); a missing ack would silently pin the sender's baseline.
* **[recovery-bound]** — after a crash, every partition the dead node owned
  is re-adopted by a live node within detection + steal + fetch time
  (requires ``cfg``; crashes overlapping a network partition are exempt —
  recovery then legitimately waits for storage/steal races to settle, and
  partitions a live node *already* co-owned at crash time need no
  re-adoption — sparse dissemination topologies, docs/protocol.md §5, can
  transiently duplicate ownership, which consumer dedup makes benign).
* **[truncated]** — the ring buffer dropped records: the auditor refuses to
  certify invariants it could not see.

Besides pass/fail the auditor extracts first-class timeline metrics:
``time_to_recover_ms`` per crash (crash → last owned-partition adoption) and
``time_to_settle_ms`` (first fault → last spiked-latency window), the
numbers behind the paper's 11x-under-failure claim.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

from repro_torch.obs.records import TraceBuffer, TraceEvent

# audit slack on the recovery bound: scheduling quantization (poll loops,
# rebalance running on the heartbeat period) + one extra storage round trip
RECOVERY_SLACK_MS = 250.0


@dataclasses.dataclass
class AuditReport:
    ok: bool
    violations: list[str]
    metrics: dict

    def __str__(self) -> str:
        head = "AUDIT OK" if self.ok else f"AUDIT FAILED ({len(self.violations)})"
        lines = [head] + [f"  - {v}" for v in self.violations]
        for k in sorted(self.metrics):
            lines.append(f"  {k} = {self.metrics[k]}")
        return "\n".join(lines)


def _fault_windows(events: list[TraceEvent]) -> list[tuple[float, float]]:
    """[start, end) spans during which the fabric was partitioned."""
    spans, start = [], None
    for ev in events:
        if ev.kind == "net.partition" and start is None:
            start = ev.t_ms
        elif ev.kind == "net.heal" and start is not None:
            spans.append((start, ev.t_ms))
            start = None
    if start is not None:
        spans.append((start, float("inf")))
    return spans


def _overlaps(spans: list[tuple[float, float]], a: float, b: float) -> bool:
    return any(s < b and a < e for s, e in spans)


def audit(
    events: "Iterable[TraceEvent] | TraceBuffer",
    cfg=None,
    dropped: int = 0,
    spike_factor: float = 3.0,
) -> AuditReport:
    """Replay a trace and check every invariant above.  ``cfg`` (a
    ``SimConfig``) enables the recovery-bound check; ``dropped`` (taken from
    the buffer when one is passed) flags truncation."""
    if isinstance(events, TraceBuffer):
        dropped = events.dropped
        # spool + resident ring: a spill-configured buffer still certifies
        # long runs — spilled records are on disk, not dropped
        events = events.all_events() if events.spilled else events.events()
    evs = sorted(events, key=lambda e: e.t_ms)
    v: list[str] = []
    metrics: dict = {}

    if dropped:
        v.append(f"[truncated] trace ring dropped {dropped} records — "
                 "grow SimConfig.obs_trace_cap to certify this run")

    # ---- [exactly-once] ----------------------------------------------------
    accepted: dict[tuple[int, int], TraceEvent] = {}
    emits = [e for e in evs if e.kind == "emit"]
    for e in emits:
        key = (e.partition, e.window)
        if e.status == "accepted":
            if key in accepted:
                v.append(f"[exactly-once] window {key} accepted twice "
                         f"(t={accepted[key].t_ms:.1f} and t={e.t_ms:.1f})")
            else:
                accepted[key] = e
        elif e.status == "duplicate":
            first = accepted.get(key)
            if first is None:
                v.append(f"[exactly-once] window {key} duplicate at "
                         f"t={e.t_ms:.1f} precedes any accepted emission")
            elif e.arg("digest") != first.arg("digest"):
                v.append(f"[exactly-once] window {key} re-emitted with a "
                         f"different value digest at t={e.t_ms:.1f} "
                         "(non-deterministic replay)")
    metrics["windows_accepted"] = len(accepted)
    metrics["windows_duplicate"] = sum(1 for e in emits if e.status == "duplicate")
    metrics["windows_evicted"] = sum(1 for e in emits if e.status == "evicted")

    # ---- [frontier-regression] ---------------------------------------------
    frontier: dict[int, tuple[float, int]] = {}
    for e in evs:
        if e.kind != "ckpt.apply":
            continue
        nxt = int(e.arg("nxt_idx", 0))
        prev = frontier.get(e.partition)
        if prev is not None and nxt < prev[1]:
            v.append(f"[frontier-regression] partition {e.partition} stored "
                     f"frontier went {prev[1]} -> {nxt} at t={e.t_ms:.1f} "
                     f"(previous apply t={prev[0]:.1f})")
        frontier[e.partition] = (e.t_ms, max(nxt, prev[1] if prev else nxt))

    # ---- [domination] + [unacked-merge] ------------------------------------
    # multiset of fabric-recorded ack send attempts, keyed (t, from, to):
    # a merge and its ack are issued at the same sim instant
    acks: dict[tuple[float, object, object], int] = defaultdict(int)
    for e in evs:
        if e.kind == "net.msg" and e.cls == "sync_ack":
            acks[(e.t_ms, e.src, e.dst)] += 1
    merges = nacks = 0
    for e in evs:
        if e.kind != "sync.recv":
            continue
        dominated = bool(e.arg("dominated", 1))
        if e.status == "delta_merge":
            merges += 1
            if not dominated:
                v.append(f"[domination] node {e.node} merged a delta from "
                         f"{e.src} at t={e.t_ms:.1f} without dominating its "
                         "baseline (coverage gap would be silently lost)")
        elif e.status == "full_merge":
            merges += 1
        elif e.status == "nack":
            nacks += 1
            if dominated:
                v.append(f"[domination] node {e.node} nacked a dominated "
                         f"delta from {e.src} at t={e.t_ms:.1f}")
        if e.status in ("delta_merge", "full_merge") and e.arg("marker", 0):
            key = (e.t_ms, e.node, e.src)
            if acks[key] > 0:
                acks[key] -= 1
            else:
                v.append(f"[unacked-merge] node {e.node} merged from {e.src} "
                         f"at t={e.t_ms:.1f} but the fabric shows no sync_ack "
                         "send — the sender's baseline would stay pinned")
    metrics["sync_merges"] = merges
    metrics["sync_nacks"] = nacks

    # ---- [recovery-bound] + time-to-recover --------------------------------
    part_spans = _fault_windows(evs)
    adopts = [e for e in evs if e.kind == "steal.adopt"]
    # Ownership replay: under a sparse dissemination topology
    # (docs/protocol.md §5) a node's partial early view can make it adopt a
    # partition whose rendezvous owner is alive elsewhere — the partition is
    # then held (and processed) by both until the duplicate is handed off.
    # If the duplicating node crashes, no re-adoption is needed: the live
    # owner never stopped.  Replay boot/adopt/handoff/drain to know, at each
    # crash, which of the dead node's partitions were already live-covered.
    owners: dict[int, set] = defaultdict(set)
    alive: set = set()
    covered_at_crash: dict[int, set] = {}  # id(crash event) -> covered pids
    for e in evs:
        if e.kind == "node.boot":
            alive.add(e.node)
            for pid in e.arg("pids", ()):
                owners[int(pid)].add(e.node)
        elif e.kind == "steal.adopt":
            owners[e.partition].add(e.node)
        elif e.kind == "part.handoff":
            owners[e.partition].discard(e.node)
        elif e.kind == "node.drain":
            alive.discard(e.node)
            for pid in e.arg("owned", ()):
                owners[int(pid)].discard(e.node)
        elif e.kind == "node.crash":
            alive.discard(e.node)
            covered_at_crash[id(e)] = {
                int(pid) for pid in e.arg("owned", ())
                if owners[int(pid)] & alive
            }
            for pid in e.arg("owned", ()):
                owners[int(pid)].discard(e.node)
    ttr: dict[int, float] = {}
    for e in evs:
        if e.kind != "node.crash":
            continue
        owned = e.arg("owned", ())
        if not owned:
            continue
        bound = float("inf")
        if cfg is not None:
            # detection (timeout + up to 2 control periods) + steal handshake
            # + checkpoint fetch over the storage link + scheduling slack
            bound = (cfg.hb_timeout_ms + 2.0 * cfg.hb_interval_ms
                     + cfg.steal_delay_ms + 2.0 * cfg.storage_rtt_ms
                     + RECOVERY_SLACK_MS)
        deadline = e.t_ms + bound
        last = e.t_ms
        for pid in owned:
            if int(pid) in covered_at_crash.get(id(e), ()):
                # a live node already held this partition at crash time
                # (duplicate ownership from a sparse-view steal) — recovery
                # is instantaneous, nothing to re-adopt
                continue
            took = [a for a in adopts
                    if a.partition == pid and a.t_ms > e.t_ms and a.node != e.node]
            if not took:
                # the crashed node may have restarted and re-adopted its own
                # partitions, or the run ended first — only flag when a bound
                # is checkable and no partition overlapped the interval
                if (cfg is not None
                        and not _overlaps(part_spans, e.t_ms, deadline)
                        and any(a.t_ms > deadline for a in evs[-1:])):
                    v.append(f"[recovery-bound] partition {pid} of crashed "
                             f"node {e.node} (t={e.t_ms:.1f}) was never "
                             "re-adopted by a live node")
                continue
            t_adopt = min(a.t_ms for a in took)
            last = max(last, t_adopt)
            if (cfg is not None and t_adopt > deadline
                    and not _overlaps(part_spans, e.t_ms, t_adopt)):
                v.append(f"[recovery-bound] partition {pid} of crashed node "
                         f"{e.node} re-adopted {t_adopt - e.t_ms:.0f}ms after "
                         f"the crash (bound {bound:.0f}ms)")
        ttr[e.node] = last - e.t_ms
    if ttr:
        metrics["time_to_recover_ms"] = {n: round(t, 3) for n, t in sorted(ttr.items())}

    # centralized-baseline downtime (flink.down -> first flink.recover after)
    downs = [e.t_ms for e in evs if e.kind == "flink.down"]
    recovers = [e.t_ms for e in evs if e.kind == "flink.recover"]
    if downs:
        spans = []
        for d in downs:
            after = [r for r in recovers if r >= d]
            spans.append(round((after[0] - d), 3) if after else float("inf"))
        metrics["flink_downtime_ms"] = spans

    # ---- time-to-settle ----------------------------------------------------
    faults = [e.t_ms for e in evs
              if e.kind in ("node.crash", "net.partition", "net.degrade")]
    if faults:
        t0 = min(faults)
        pre = [float(e.arg("latency_ms", 0.0)) for e in emits
               if e.status == "accepted" and e.t_ms < t0]
        if pre:
            pre.sort()
            thr = spike_factor * max(pre[len(pre) // 2], 1.0)
            spiked = [e.t_ms for e in emits
                      if e.status == "accepted" and e.t_ms >= t0
                      and float(e.arg("latency_ms", 0.0)) > thr]
            metrics["time_to_settle_ms"] = (
                round(max(spiked) - t0, 3) if spiked else 0.0
            )
    return AuditReport(ok=not v, violations=v, metrics=metrics)


def audit_harness(harness, cfg=None) -> AuditReport:
    """Audit a finished harness run (Holon or Flink) via its telemetry."""
    return audit(harness.obs.buf, cfg=cfg if cfg is not None else harness.cfg)
