"""Online protocol monitor (docs/observability.md §6).

The post-hoc auditor (obs/audit.py) certifies a finished trace; the
:class:`OnlineMonitor` runs the same invariant checks *while the run is in
flight*, in bounded memory, by subscribing to the telemetry append stream
(``Telemetry.subscribe``).  It is strictly passive: it draws no randomness,
schedules no simulator events, and touches nothing the runtimes read — a run
with the monitor on is byte-identical to the same seed with it off
(A/B-tested in tests/test_torch_obs_analysis.py).

Alerts come in two severities:

* ``violation`` — protocol invariants, same ids as the auditor so the two
  can be diffed one-to-one (equivalence-tested on every tier-1 scenario
  family):

  - ``[exactly-once]``   duplicate/conflicting emission of a (pid, wid);
  - ``[frontier-regression]`` a checkpoint apply regressed the stored
    ``nxt_idx`` frontier;
  - ``[domination]``     a merged delta was not dominated (or a nack was);
  - ``[unacked-merge]``  a merge was applied but never acknowledged.

* ``warn`` — operational health, thresholds from ``SimConfig``:

  - ``[frontier-stall]`` no fold or emission progressed for
    ``obs_stall_ms`` of sim time (stuck pipeline / dead quorum);
  - ``[straggler]``      one node persistently *originates* the critical
    path of other nodes' emissions (its folds arrive last and gate
    everyone — the causal signature of a degraded peer);
  - ``[sync-burn]``      sync-plane bytes/sec exceeded
    ``obs_sync_budget`` over a 1 s bucket;
  - ``[slo-burn]``       more than ``obs_slo_frac`` of recent emissions
    missed the ``obs_slo_ms`` latency SLO.

State is bounded: recent-window dedup maps, fixed-depth deques, and the
:class:`~repro_torch.obs.critpath.WatermarkTracker`'s O(nodes x partitions) lane
maps.  Alerts are capped (oldest kept) with a drop counter.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque

from repro_torch.obs.critpath import WatermarkTracker
from repro_torch.obs.records import TraceEvent

#: invariant ids shared verbatim with the post-hoc auditor — the
#: monitor/auditor equivalence tests compare violation sets over these
AUDIT_IDS = ("exactly-once", "frontier-regression", "domination",
             "unacked-merge")

_ALERT_CAP = 1024  # alerts kept (oldest first; overflow counted)
_RECENT_WINDOWS = 1 << 14  # (pid, wid) emission memory for exactly-once
_ORIGIN_WINDOW = 64  # emissions per straggler vote
_SLO_WINDOW = 32  # emissions per SLO burn vote
_BURN_BUCKET_MS = 1000.0  # sync-burn accounting bucket
# record kinds the invariant/health state actually reads; anything else is
# clock-only for the monitor (see the fast path in ``feed``)
_FEED_KINDS = frozenset((
    "emit", "sync.recv", "ckpt.apply", "net.msg", "exec.batch",
    "steal.adopt", "node.restart",
))


@dataclasses.dataclass(frozen=True)
class Alert:
    t_ms: float
    id: str  # catalog id, e.g. "exactly-once", "frontier-stall"
    severity: str  # "violation" | "warn"
    msg: str

    def __str__(self) -> str:
        return f"[{self.id}] t={self.t_ms:.1f} {self.msg}"


class OnlineMonitor:
    """Incremental protocol auditor over the live telemetry stream."""

    def __init__(self, num_partitions: int = 0, stall_ms: float = 5000.0,
                 slo_ms: float = 0.0, slo_frac: float = 0.5,
                 sync_budget: float = 0.0, straggler_frac: float = 0.5):
        self.stall_ms = float(stall_ms)
        self.slo_ms = float(slo_ms)
        self.slo_frac = float(slo_frac)
        self.sync_budget = float(sync_budget)
        self.straggler_frac = float(straggler_frac)
        self.alerts: deque[Alert] = deque(maxlen=_ALERT_CAP)
        self.alerts_dropped = 0
        self.fed = 0
        # --- invariant state (mirrors obs/audit.py, windowed) ---
        self._digests: dict = {}  # (pid, wid) -> digest of accepted emit
        self._digest_order: deque = deque()
        self._frontier: dict = {}  # pid -> max applied nxt_idx
        self._unacked: list = []  # (t, node, src) merges awaiting ack
        self._acks: Counter = Counter()  # (t, from, to) ack sends seen
        # --- health state ---
        self.tracker = WatermarkTracker(num_partitions=num_partitions)
        self._last_progress = None  # t of last fold/emit, None before first
        self._stalled = False
        self._origins: deque = deque(maxlen=_ORIGIN_WINDOW)
        self._lat: deque = deque(maxlen=_SLO_WINDOW)
        self._slo_hot = False
        self._bucket = 0  # current sync-burn bucket index
        self._bucket_bytes = 0.0
        self._burn_hot = False

    @classmethod
    def from_config(cls, cfg) -> "OnlineMonitor":
        return cls(
            num_partitions=cfg.num_partitions,
            stall_ms=getattr(cfg, "obs_stall_ms", 5000.0),
            slo_ms=getattr(cfg, "obs_slo_ms", 0.0),
            slo_frac=getattr(cfg, "obs_slo_frac", 0.5),
            sync_budget=getattr(cfg, "obs_sync_budget", 0.0),
        )

    def attach(self, telemetry) -> None:
        telemetry.subscribe(self.feed)

    # ------------------------------------------------------------------
    def _alert(self, t_ms: float, id: str, severity: str, msg: str) -> None:
        if len(self.alerts) == self.alerts.maxlen:
            self.alerts_dropped += 1
        self.alerts.append(Alert(t_ms=t_ms, id=id, severity=severity, msg=msg))

    def violations(self) -> list[Alert]:
        self._settle(float("inf"))
        return [a for a in self.alerts if a.severity == "violation"]

    def violation_ids(self) -> set:
        return {a.id for a in self.violations()}

    def warning_ids(self) -> set:
        return {a.id for a in self.alerts if a.severity == "warn"}

    def finish(self) -> None:
        """Flush end-of-run state (pending unacked merges)."""
        self._settle(float("inf"))

    # ------------------------------------------------------------------
    def feed(self, ev: TraceEvent) -> None:
        self.fed += 1
        t = ev.t_ms
        kind = ev.kind
        if kind not in _FEED_KINDS:
            # hot fast path: most records (spans, heartbeats, shuffle hops)
            # carry nothing the invariants read — they only advance the
            # clock for ack settlement and the stall detector.  This keeps
            # the monitor's overhead inside the documented budget on the
            # baseline's record mix too.
            if self._unacked:
                self._settle(t)
            lp = self._last_progress
            if (lp is not None and not self._stalled
                    and t - lp > self.stall_ms):
                self._stalled = True
                self._alert(t, "frontier-stall", "warn",
                            f"no fold/emission progress for {t - lp:.0f} ms")
            return
        if self._unacked:
            self._settle(t)
        self._check_stall(ev)
        if kind != "net.msg" or ev.cls == "sync":
            self.tracker.feed(ev)
        if kind == "emit":
            self._on_emit(ev)
        elif kind == "sync.recv":
            # merge applied with ack-expected marker: an ack send must show
            # up at the same instant (the receiver replies in the same
            # callback) — settled when sim time first advances past t
            if (ev.status in ("delta_merge", "full_merge")
                    and ev.arg("marker", 0)):
                self._unacked.append((t, ev.node, ev.src))
        elif kind == "ckpt.apply":
            nxt = int(ev.arg("nxt_idx", 0))
            prev = self._frontier.get(ev.partition)
            if prev is not None and nxt < prev:
                self._alert(
                    t, "frontier-regression", "violation",
                    f"p{ev.partition} applied nxt_idx {nxt} < {prev}")
            self._frontier[ev.partition] = max(
                nxt, prev if prev is not None else nxt)
        elif kind == "net.msg":
            if ev.cls == "sync_ack":
                # the *send attempt* acknowledges — delivery may be lossy
                self._acks[(t, ev.src, ev.dst)] += 1
            if ev.cls.startswith("sync"):
                self._account_sync(t, ev.nbytes)
        if kind == "sync.recv":
            dominated = bool(ev.arg("dominated", 1))
            if ev.status == "delta_merge" and not dominated:
                self._alert(t, "domination", "violation",
                            f"node {ev.node} merged a non-dominated delta "
                            f"from {ev.src}")
            elif ev.status == "nack" and dominated:
                self._alert(t, "domination", "violation",
                            f"node {ev.node} nacked a dominated delta "
                            f"from {ev.src}")

    # ------------------------------------------------------------------
    def _settle(self, now: float) -> None:
        """Match merges against same-instant acks once time moves on."""
        if not self._unacked:
            if now == float("inf"):
                self._acks.clear()
            return
        keep = []
        for (t, node, src) in self._unacked:
            if t >= now:
                keep.append((t, node, src))
                continue
            key = (t, node, src)  # ack goes merge-node -> delta sender
            if self._acks[key] > 0:
                self._acks[key] -= 1
            else:
                self._alert(t, "unacked-merge", "violation",
                            f"merge at node {node} from {src} never acked")
        self._unacked = keep
        if not keep:
            self._acks.clear()

    def _check_stall(self, ev: TraceEvent) -> None:
        progressed = (ev.kind == "exec.batch"
                      or (ev.kind == "emit" and ev.status == "accepted"))
        if self._last_progress is None:
            if progressed:
                self._last_progress = ev.t_ms
            return
        gap = ev.t_ms - self._last_progress
        if gap > self.stall_ms and not self._stalled:
            self._stalled = True
            self._alert(ev.t_ms, "frontier-stall", "warn",
                        f"no fold/emission progress for {gap:.0f} ms")
        if progressed:
            self._last_progress = ev.t_ms
            self._stalled = False

    def _on_emit(self, ev: TraceEvent) -> None:
        pid, wid, t = ev.partition, ev.window, ev.t_ms
        key = (pid, wid)
        digest = ev.arg("digest")
        if ev.status == "accepted":
            if key in self._digests:
                self._alert(t, "exactly-once", "violation",
                            f"window (p{pid}, w{wid}) accepted twice")
            else:
                self._digests[key] = digest
                self._digest_order.append(key)
                if len(self._digest_order) > _RECENT_WINDOWS:
                    self._digests.pop(self._digest_order.popleft(), None)
            # health votes ride accepted emissions only
            self._vote_slo(t, float(ev.arg("latency_ms", 0.0)))
            self._vote_straggler(t, ev)
        elif ev.status == "duplicate":
            if key not in self._digests:
                self._alert(t, "exactly-once", "violation",
                            f"window (p{pid}, w{wid}) deduped before any "
                            f"accepted emission")
            elif digest != self._digests[key]:
                self._alert(t, "exactly-once", "violation",
                            f"window (p{pid}, w{wid}) re-emitted with a "
                            f"different digest")

    def _vote_slo(self, t: float, latency_ms: float) -> None:
        if self.slo_ms <= 0:
            return
        self._lat.append(latency_ms)
        if len(self._lat) < self._lat.maxlen:
            return
        frac = sum(1 for x in self._lat if x > self.slo_ms) / len(self._lat)
        if frac > self.slo_frac:
            if not self._slo_hot:
                self._slo_hot = True
                self._alert(t, "slo-burn", "warn",
                            f"{frac:.0%} of last {len(self._lat)} emissions "
                            f"over the {self.slo_ms:.0f} ms SLO")
        else:
            self._slo_hot = False

    def _vote_straggler(self, t: float, ev: TraceEvent) -> None:
        _, _, elem = self.tracker.binding(ev.node, ev.partition)
        origin = elem.root().node
        if origin is None:
            return
        self._origins.append((origin, ev.node))
        if len(self._origins) < self._origins.maxlen:
            return
        # a *remote* origin persistently gating emissions = straggler peer
        remote = Counter(o for o, n in self._origins if o != n)
        if remote:
            node, cnt = remote.most_common(1)[0]
            if cnt / len(self._origins) >= self.straggler_frac:
                self._alert(t, "straggler", "warn",
                            f"node {node} originates {cnt}/"
                            f"{len(self._origins)} recent critical paths")
                self._origins.clear()

    def _account_sync(self, t: float, nbytes: float) -> None:
        if self.sync_budget <= 0:
            return
        bucket = int(t // _BURN_BUCKET_MS)
        if bucket != self._bucket:
            self._close_bucket()
            self._bucket, self._bucket_bytes = bucket, 0.0
        self._bucket_bytes += nbytes

    def _close_bucket(self) -> None:
        rate = self._bucket_bytes / (_BURN_BUCKET_MS / 1000.0)
        if rate > self.sync_budget:
            if not self._burn_hot:
                self._burn_hot = True
                self._alert(self._bucket * _BURN_BUCKET_MS, "sync-burn",
                            "warn",
                            f"sync plane burned {rate:.0f} B/s against a "
                            f"{self.sync_budget:.0f} B/s budget")
        else:
            self._burn_hot = False


def replay(events, cfg=None) -> OnlineMonitor:
    """Feed a recorded stream through a fresh monitor (testing/offline use:
    the monitor/auditor equivalence tests replay mutated traces this way)."""
    mon = OnlineMonitor.from_config(cfg) if cfg is not None else OnlineMonitor()
    for ev in events:
        mon.feed(ev)
    mon.finish()
    return mon
