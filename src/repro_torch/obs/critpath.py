"""Causal critical-path analysis over Holoscope traces
(docs/observability.md §5).

The paper's latency claim is a claim about *paths*: "the end-to-end latency
is determined by the slowest path in the tree."  End-to-end percentiles
measure that; this module *explains* it.  For every accepted window emission
it reconstructs the causal chain of trace records that actually gated the
emission and attributes the chain's length to phases, so all-to-all vs
ring/hypercube vs the Flink tree can be compared causally, not just by
output percentiles.

**DAG construction (Holon).**  A window (pid, wid) emits when the emitting
node's global watermark — ``min`` over its per-partition ``progress``
lattice — passes the window end.  The :class:`WatermarkTracker` replays that
lattice exactly from trace records:

* ``exec.batch`` (with its ``wm`` arg) raises the folding node's own lane to
  the batch watermark — a **fold** chain element anchored at the batch's
  availability time;
* every ``net.msg`` ``cls="sync"`` send snapshots the sender's lane map
  (deltas always ship the full ``progress`` vector), keyed by the scheduled
  delivery time;
* ``sync.recv`` joins the matched snapshot in, elementwise max; a lane the
  delivery *advanced* gets a **merge** element whose causal parent is the
  sender's element — the last-arriving dominated delta is the parent at each
  merge, exactly the protocol's rule;
* ``ckpt.apply`` (with its stored ``wm`` vector) tracks the durable
  snapshot per partition; ``steal.adopt`` from a checkpoint joins it in as
  **adopt** elements parented on the apply — the recovery edge;
* ``node.restart`` resets the node's lanes (volatile state wiped).

At an accepted ``emit`` the **binding lane** is the laggard: the lane with
the minimum reconstructed watermark at that instant (lowest lane id on
ties).  Its chain, walked parent-to-root, is the critical path.  Because the
replay mirrors the real lattice exactly, the binding value is ``>=`` the
window end, and every chain element's event time is ``>=`` its watermark
value (event time and sim time advance together), so the path anchor is
``>=`` the window close — **path length <= end-to-end latency**, property-
tested in tests/test_torch_obs_analysis.py.

**Phase taxonomy.**  Walking emit -> root partitions the path interval
exactly (segments telescope, so the phase sums equal the path length):

* ``queue``    — batch wait before dequeue + emission/poll lag after the
                 gating event;
* ``compute``  — modeled fold cost ahead of the root batch (executor busy
                 on other batches between availability and dequeue);
* ``sync_wait``— value ready at the sender, waiting for the next sync round
                 to schedule this link;
* ``loss_stall``— sent but lost: gap between the first send attempt
                 carrying the value and the transmission that survived
                 (plus reliable-tier RTO retransmits and partition parking);
* ``wire``     — in flight on the surviving transmission;
* ``recovery`` — checkpoint-apply -> adoption edges after a crash (and, for
                 the baseline, job-down overlap).

**Flink baseline.**  The tree's slowest path is reconstructed from
``shuffle.fwd`` / ``shuffle.arrive`` pairs: the binding arrival is the last
one per window (the root emits at that instant); its leaf fold anchors the
path, and the reliable-tier ``retries`` arg on the matched ``net.msg``
splits delivery into wire vs RTO stalls.

Everything here is a pure function of the trace: same seed => byte-identical
reports (``CritPathReport.to_json``).
"""
from __future__ import annotations

import dataclasses
import json
from bisect import bisect_left
from collections import deque
from typing import Iterable

from repro_torch.obs.records import TraceBuffer, TraceEvent
from repro_torch.obs.registry import summary

PHASES = ("queue", "compute", "sync_wait", "loss_stall", "wire", "recovery")

# chain-walk safety bound: no real chain approaches this (each hop strictly
# advances sim time by at least one sync delivery)
_MAX_HOPS = 4096
# pending sync-snapshot bound per link (monitor mode keeps memory bounded;
# entries are matched at delivery, so steady state holds a round or two)
_PENDING_CAP = 4096


class _Elem:
    """One causal chain element: how a lane's watermark value became known
    at a node.  Immutable once created; ``parent`` links form the DAG."""

    __slots__ = ("kind", "t_ms", "node", "parent", "avail", "send_t", "link")

    def __init__(self, kind, t_ms, node, parent=None, avail=0.0,
                 send_t=0.0, link=None):
        self.kind = kind  # "init" | "fold" | "merge" | "ckpt" | "adopt"
        self.t_ms = t_ms  # when the value became known at ``node``
        self.node = node
        self.parent = parent
        self.avail = avail  # fold: batch availability time
        self.send_t = send_t  # merge: surviving transmission's send time
        self.link = link  # merge: (src, dst)

    def root(self, max_hops: int = _MAX_HOPS) -> "_Elem":
        e = self
        for _ in range(max_hops):
            if e.parent is None:
                return e
            e = e.parent
        return e


_INIT = _Elem("init", 0.0, None)


class WatermarkTracker:
    """Incremental replay of the per-node progress lattice from trace
    records (shared by the post-hoc analyzer and the online monitor).

    Bounded memory: per-node lane maps are O(P); pending sync snapshots are
    bounded per link and pruned by delivery-time staleness.  Feeding is
    passive — pure bookkeeping, no RNG, no sim interaction."""

    def __init__(self, num_partitions: int = 0, track_attempts: bool = False,
                 pending_cap: int = _PENDING_CAP):
        self.P = int(num_partitions)
        self.track_attempts = track_attempts
        self.pending_cap = int(pending_cap)
        # node -> {lane: (value, elem)}; missing lane = (0, init)
        self.lanes: dict = {}
        # (src, dst) -> deque[(deliver_t, snapshot dict)]
        self.pending: dict = {}
        # (src, dst) -> sorted send-attempt times of cls="sync" (incl. lost)
        self.attempts: dict = {}
        # pid -> (wm tuple, ckpt elem) of the stored checkpoint
        self.store: dict = {}
        self.shared_seen = False  # any sync traffic observed yet

    # ---- lattice access ----------------------------------------------------
    def _lane(self, node, lane) -> tuple:
        return self.lanes.get(node, {}).get(lane, (0, _INIT))

    def binding(self, node, pid: int) -> tuple:
        """(lane, value, elem) gating an emit at ``node`` for ``pid``: the
        laggard lane under sync'd state, the partition's own lane otherwise
        (local-only queries have per-partition watermarks)."""
        if not self.shared_seen:
            v, e = self._lane(node, pid)
            return pid, v, e
        best = None
        for lane in range(self.P):
            v, e = self._lane(node, lane)
            if best is None or v < best[1]:
                best = (lane, v, e)
        return best if best is not None else (pid, *self._lane(node, pid))

    # ---- record feed -------------------------------------------------------
    def feed(self, ev: TraceEvent) -> None:
        kind = ev.kind
        if kind == "exec.batch":
            wm = ev.arg("wm")
            if wm is None:
                return  # baseline exec records carry no lattice provenance
            self.P = max(self.P, ev.partition + 1)
            node = self.lanes.setdefault(ev.node, {})
            cur = node.get(ev.partition, (0, _INIT))
            if wm > cur[0]:
                node[ev.partition] = (wm, _Elem(
                    "fold", ev.t_ms, ev.node,
                    avail=ev.t_ms - float(ev.arg("queue_ms", 0.0)),
                ))
        elif kind == "net.msg" and ev.cls == "sync":
            self.shared_seen = True
            link = (ev.src, ev.dst)
            if self.track_attempts:
                self.attempts.setdefault(link, []).append(ev.t_ms)
            if ev.status == "ok":
                q = self.pending.get(link)
                if q is None:
                    q = self.pending[link] = deque(maxlen=self.pending_cap)
                # snapshot the sender's lane map at send time: this IS the
                # progress vector the delta ships (deltas always carry full
                # progress), keyed by the scheduled delivery time
                q.append((ev.t_end_ms, ev.t_ms,
                          dict(self.lanes.get(ev.src, {}))))
        elif kind == "sync.recv":
            self.shared_seen = True
            hit = self._match(ev.src, ev.node, ev.t_ms)
            if hit is None or ev.status not in ("delta_merge", "full_merge"):
                return
            t_send, snap = hit
            node = self.lanes.setdefault(ev.node, {})
            for lane, (v, e) in snap.items():
                self.P = max(self.P, lane + 1)
                if v > node.get(lane, (0, _INIT))[0]:
                    node[lane] = (v, _Elem(
                        "merge", ev.t_ms, ev.node, parent=e,
                        send_t=t_send, link=(ev.src, ev.node),
                    ))
        elif kind == "ckpt.apply":
            if ev.status == "applied":
                wm = ev.arg("wm")
                if wm:
                    self.P = max(self.P, len(wm))
                    self.store[ev.partition] = (
                        wm, _Elem("ckpt", ev.t_ms, ev.node))
        elif kind == "steal.adopt":
            if ev.status == "ckpt":
                stored = self.store.get(ev.partition)
                if stored is None:
                    return
                wm, ck_elem = stored
                node = self.lanes.setdefault(ev.node, {})
                for lane, v in enumerate(wm):
                    if v > node.get(lane, (0, _INIT))[0]:
                        node[lane] = (v, _Elem(
                            "adopt", ev.t_ms, ev.node, parent=ck_elem))
        elif kind == "node.restart":
            self.lanes.pop(ev.node, None)  # volatile state wiped

    def _match(self, src, dst, t_recv: float):
        """Pop the pending ``(send time, snapshot)`` whose scheduled delivery
        is ``t_recv`` (delivery times are exact floats shared by record and
        callback); prunes stale undelivered entries (receiver was dead)."""
        q = self.pending.get((src, dst))
        if not q:
            return None
        horizon = t_recv - 60_000.0
        for i, (t_del, t_send, snap) in enumerate(q):
            if t_del == t_recv:
                del q[i]
                return t_send, snap
        while q and q[0][0] < horizon:
            q.popleft()
        return None

    def _send_t(self, elem: _Elem) -> float:
        return elem.send_t

    def first_attempt(self, link, t_lo: float, t_hi: float) -> float:
        """Earliest sync send attempt on ``link`` in [t_lo, t_hi] — when the
        value first had a chance to ship (post-hoc only)."""
        at = self.attempts.get(link)
        if at:
            i = bisect_left(at, t_lo)
            if i < len(at) and at[i] <= t_hi:
                return at[i]
        return t_hi


# ---------------------------------------------------------------------------
# post-hoc analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CritPath:
    """The critical path of one accepted window emission."""

    partition: int
    window: int
    node: object  # emitting node
    origin: object  # root chain element's node (the causal source)
    t_emit_ms: float
    latency_ms: float  # consumer-visible end-to-end latency
    path_ms: float  # anchor -> emit along the causal chain (<= latency)
    hops: int  # merge/adopt edges on the path
    phases: dict  # phase -> ms; sums to path_ms exactly

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["phases"] = {k: round(v, 3) for k, v in sorted(d["phases"].items())}
        for k in ("t_emit_ms", "latency_ms", "path_ms"):
            d[k] = round(d[k], 3)
        return d


@dataclasses.dataclass
class CritPathReport:
    system: str  # "holon" | "flink"
    topology: str  # gossip topology name, or "tree" for the baseline
    paths: list

    def summary(self) -> dict:
        """Deterministic distribution summary: hop counts, path lengths, and
        per-phase attribution (avg ms + fraction of total path time)."""
        out: dict = {"system": self.system, "topology": self.topology,
                     "n": len(self.paths)}
        if not self.paths:
            return out
        out["hops"] = summary([float(p.hops) for p in self.paths])
        out["path_ms"] = summary([p.path_ms for p in self.paths])
        out["latency_ms"] = summary([p.latency_ms for p in self.paths])
        total = sum(p.path_ms for p in self.paths)
        out["phase_ms"] = {
            ph: round(sum(p.phases[ph] for p in self.paths) / len(self.paths), 6)
            for ph in PHASES
        }
        out["phase_frac"] = {
            ph: round(sum(p.phases[ph] for p in self.paths) / total, 6)
            if total > 0 else 0.0
            for ph in PHASES
        }
        return out

    def to_json(self) -> str:
        """Byte-stable serialization (same seed => identical string)."""
        return json.dumps(
            {
                "meta": "holon-critpath-v1",
                "system": self.system,
                "topology": self.topology,
                "summary": self.summary(),
                "paths": [p.as_dict() for p in self.paths],
            },
            sort_keys=True,
        )


def _overlap(spans: list, lo: float, hi: float) -> float:
    """Total overlap of sorted (start, end) spans with [lo, hi]."""
    if hi <= lo:
        return 0.0
    total = 0.0
    for s, e in spans:
        if s >= hi:
            break
        if e > lo:
            total += min(e, hi) - max(s, lo)
    return total


def _zero_phases() -> dict:
    return {ph: 0.0 for ph in PHASES}


def analyze(events: "Iterable[TraceEvent] | TraceBuffer",
            cfg=None) -> CritPathReport:
    """Reconstruct the critical path of every accepted emission in a trace.

    ``events`` must be a complete record stream in append order (pass the
    harness's ``TraceBuffer`` — spilled records are included).  ``cfg``
    (a ``SimConfig``) enables the reliable-tier RTO split for the baseline;
    everything else is self-contained in the trace."""
    if isinstance(events, TraceBuffer):
        events = events.all_events() if events.spilled else events.events()
    evs = list(events)
    flink = any(e.kind in ("shuffle.fwd", "shuffle.arrive", "flink.down",
                           "flink.barrier") for e in evs)
    return (_analyze_flink if flink else _analyze_holon)(evs, cfg)


def analyze_harness(harness) -> CritPathReport:
    """Analyze a finished harness run (Holon or Flink) via its telemetry."""
    return analyze(harness.obs.buf, cfg=harness.cfg)


def _exec_spans(evs: list) -> dict:
    """node -> sorted [(t, t_end)] modeled-compute spans."""
    spans: dict = {}
    for e in evs:
        if e.kind == "exec.batch" and e.t_end_ms > e.t_ms:
            spans.setdefault(e.node, []).append((e.t_ms, e.t_end_ms))
    for v in spans.values():
        v.sort()
    return spans


def _analyze_holon(evs: list, cfg) -> CritPathReport:
    tracker = WatermarkTracker(
        num_partitions=getattr(cfg, "num_partitions", 0) or 0,
        track_attempts=True,
    )
    topology = "local"
    bindings = []  # (emit event, value, elem)
    for ev in evs:
        tracker.feed(ev)
        if ev.kind == "sync.publish" and topology == "local":
            topology = str(ev.arg("topology", "all"))
        elif ev.kind == "emit" and ev.status == "accepted":
            lane, value, elem = tracker.binding(ev.node, ev.partition)
            bindings.append((ev, value, elem))
    spans = _exec_spans(evs)
    paths = []
    for ev, value, elem in bindings:
        phases = _zero_phases()
        t_hi = ev.t_ms
        e, hops, anchor = elem, 0, 0.0
        for _ in range(_MAX_HOPS):
            if e.kind == "fold":
                # emission/poll lag above the fold, then [avail, dequeue)
                # split into executor-busy (compute) vs idle batch wait
                phases["queue"] += t_hi - e.t_ms
                busy = _overlap(spans.get(e.node, ()), e.avail, e.t_ms)
                phases["compute"] += busy
                phases["queue"] += (e.t_ms - e.avail) - busy
                anchor = e.avail
                break
            if e.kind == "merge":
                phases["queue"] += t_hi - e.t_ms
                t_p = e.parent.t_ms
                att = tracker.first_attempt(e.link, t_p, e.send_t)
                att = min(max(att, t_p), e.send_t)
                phases["sync_wait"] += att - t_p
                phases["loss_stall"] += e.send_t - att
                phases["wire"] += e.t_ms - e.send_t
                hops += 1
                t_hi, e = t_p, e.parent
                continue
            if e.kind == "adopt":
                phases["queue"] += t_hi - e.t_ms
                phases["recovery"] += e.t_ms - e.parent.t_ms
                hops += 1
                t_hi, e = e.parent.t_ms, e.parent
                continue
            if e.kind == "ckpt":
                anchor = e.t_ms
                break
            # init root: nothing known before t=0
            anchor = 0.0
            break
        paths.append(CritPath(
            partition=ev.partition, window=ev.window, node=ev.node,
            origin=elem.root().node, t_emit_ms=ev.t_ms,
            latency_ms=float(ev.arg("latency_ms", 0.0)),
            path_ms=ev.t_ms - anchor, hops=hops, phases=phases,
        ))
    return CritPathReport(system="holon", topology=topology, paths=paths)


def _analyze_flink(evs: list, cfg) -> CritPathReport:
    rto = float(getattr(cfg, "net_rto_ms", 0.0) or 0.0)
    # (wid, pid) -> fwd times; shuffle net.msg ok sends FIFO per src link;
    # down spans for replay/recovery overlap
    fwds: dict = {}
    sends: dict = {}  # src -> deque[(t_send, t_deliver, retries)]
    downs: list = []
    down_start = None
    execs: dict = {}  # pid -> sorted [(t_fold, queue_ms)]
    for e in evs:
        if e.kind == "shuffle.fwd":
            fwds.setdefault((e.window, e.partition), []).append(
                (e.t_ms, e.node))
        elif e.kind == "net.msg" and e.cls == "shuffle" and e.status == "ok":
            sends.setdefault(e.src, deque()).append(
                (e.t_ms, e.t_end_ms, int(e.arg("retries", 0))))
        elif e.kind == "flink.down" and down_start is None:
            down_start = e.t_ms
        elif e.kind == "flink.recover" and down_start is not None:
            downs.append((down_start, e.t_ms))
            down_start = None
        elif e.kind == "exec.batch":
            execs.setdefault(e.partition, []).append(
                (e.t_ms, float(e.arg("queue_ms", 0.0))))
    if down_start is not None:
        downs.append((down_start, float("inf")))
    spans = _exec_spans(evs)
    # last arrival per window before its emit = the slowest (binding) path
    last_arrive: dict = {}
    paths = []
    for e in evs:
        if e.kind == "shuffle.arrive":
            last_arrive[e.window] = e
        elif e.kind == "emit" and e.status == "accepted":
            arr = last_arrive.get(e.window)
            if arr is None:
                continue
            phases = _zero_phases()
            pid = arr.partition
            # the forward that produced this arrival: latest fwd <= arrive
            cand = [f for f in fwds.get((e.window, pid), ()) if f[0] <= arr.t_ms]
            if not cand:
                continue
            t_fwd, leaf = cand[-1]
            # surviving transmission: pop the send delivering at arrive time
            t_send, retries = t_fwd, 0
            q = sends.get(leaf)
            if q:
                for i, (ts, td, r) in enumerate(q):
                    if td == arr.t_ms:
                        t_send, retries = ts, r
                        del q[i]
                        break
            stall = min(retries * rto, arr.t_ms - t_send) if rto else 0.0
            phases["loss_stall"] += (t_send - t_fwd)  # partition parking
            phases["loss_stall"] += stall  # RTO retransmits
            phases["wire"] += (arr.t_ms - t_send) - stall
            phases["queue"] += e.t_ms - arr.t_ms  # 0: root emits on arrival
            # leaf fold: availability -> dequeue, minus executor-busy overlap
            # and job-down (replay) overlap
            rec = execs.get(pid, ())
            qms = next((qm for tf, qm in reversed(rec) if tf == t_fwd), 0.0)
            avail = t_fwd - qms
            busy = _overlap(spans.get(leaf, ()), avail, t_fwd)
            down = _overlap(sorted(downs), avail, t_fwd)
            phases["compute"] += busy
            phases["recovery"] += max(0.0, min(down, (t_fwd - avail) - busy))
            phases["queue"] += (t_fwd - avail) - busy - phases["recovery"]
            paths.append(CritPath(
                partition=pid, window=e.window, node=e.node, origin=leaf,
                t_emit_ms=e.t_ms,
                latency_ms=float(e.arg("latency_ms", 0.0)),
                path_ms=e.t_ms - avail, hops=1, phases=phases,
            ))
    return CritPathReport(system="flink", topology="tree", paths=paths)
