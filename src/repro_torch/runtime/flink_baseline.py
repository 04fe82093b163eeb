"""Centralized stream-processing baseline ("Flink-like", paper §5.1; port of
``repro.runtime.flink_baseline``).

Models the architecture the paper compares against:

* global aggregation via a **static aggregation tree** (fan-in
  ``flink_tree_fanin``): partitions pre-aggregate locally, forward partials
  up the tree when their local watermark passes the window; the root emits
  once ALL leaves contributed — end-to-end latency is the *slowest path*.
  Each hop pays network latency + the output-buffer flush timeout (Flink's
  default 100 ms execution.buffer-timeout is the dominant term).
* **aligned checkpoints with centralized 2PC** every ``flink_ckpt_interval``:
  a barrier pause for every node.
* **centralized recovery**: heartbeat detection (paper config: 4 s interval /
  6 s timeout) then full-job stop → restore from last completed global
  checkpoint → replay.  Without spare slots a crash leaves the job down
  (Fig. 6 bottom-right); with spare slots failover still pays
  detect + restart + restore.

What differs from Holon is purely the coordination structure — which is the
paper's point: same logs, same windows, same per-batch compute cost.  Both
runtimes also share the same :class:`~repro_torch.runtime.net.NetworkFabric`
(docs/protocol.md §4), so chaos comparisons are apples-to-apples: the tree's
shuffle partials ride the *reliable* tier — a real Flink job runs on TCP, so
message loss surfaces as retransmit latency (one ``net_rto_ms`` per lost
transmission per hop) rather than silent drops, and a network partition
parks partials until heal.  A partition that separates TaskManagers from the
JobManager side (the group holding node 0) is detected like a node failure —
after ``flink_hb_timeout_ms`` the job goes down globally, and recovery can
only start once the fabric heals.

Telemetry (docs/observability.md) mirrors the Holon harness so the auditor
runs over both traces: ``exec.batch`` spans, ``emit`` records with latency
and digest, ``flink.barrier`` per aligned checkpoint, ``node.crash`` /
``node.restart``, and the centralized-specific ``flink.down`` /
``flink.recover`` pair the auditor turns into downtime intervals.

On the port the log is made on ``device`` (the card unless the caller passes
``device="cpu"``; a CUDA device without a card raises); the baseline folds
nothing, so one host copy of the log's ``valid`` lanes is all it reads.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.obs.monitor import OnlineMonitor
from repro_torch.obs.telemetry import Telemetry
from repro_torch.runtime.config import FailureScenario, Scenario, SimConfig, as_scenario
from repro_torch.runtime.consumer import Consumer
from repro_torch.runtime.harness import runtime_device
from repro_torch.runtime.net import NetworkFabric
from repro_torch.runtime.sim import Sim
from repro_torch.streaming.events import EventBatch
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from repro_torch.streaming.queries import Query

# Flink's default execution.buffer-timeout — dominates small-record latency.
BUFFER_TIMEOUT_MS = 100.0
# nominal wire size of one pre-aggregated window partial sent up the tree
PARTIAL_BYTES = 256.0


class FlinkHarness:
    def __init__(self, cfg: SimConfig, query: Query, log: EventBatch | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.query = query
        dev = runtime_device(device)
        nx = NexmarkConfig(
            num_partitions=cfg.num_partitions,
            num_batches=cfg.num_batches,
            events_per_batch=cfg.events_per_batch,
            rate_per_partition=cfg.rate_per_partition,
            seed=cfg.seed,
            skew=cfg.skew,
        )
        self.log = (log if log is not None else generate_log(nx, dev)).map(lambda x: x.to(dev))
        # same load-proportional batch cost as the Holon runtime, so skewed
        # logs keep the A/B cost models apples-to-apples
        self.valid_frac = np.asarray(self.log.valid.cpu().numpy(), np.float64).mean(axis=-1)
        self.sim = Sim()
        # shared telemetry hub, exactly as in the Holon harness — one ring,
        # one registry, so traces from both runtimes audit identically
        self.obs = Telemetry.from_config(self.sim, cfg)
        # same fabric profile as the Holon runtime (docs/protocol.md §4);
        # the baseline's traffic rides the reliable tier (TCP semantics)
        self.net = NetworkFabric.from_config(self.sim, cfg, telemetry=self.obs)
        self.consumer = Consumer(
            window_len=cfg.window_len, assigner=query.assigner, telemetry=self.obs
        )
        self.tree_depth = max(
            1, math.ceil(math.log(max(cfg.num_partitions, 2), cfg.flink_tree_fanin))
        )

        P = cfg.num_partitions
        self.idx = [0] * P  # next batch per partition
        self.forwarded: set[tuple[int, int]] = set()  # (wid, pid) sent up-tree
        self.arrived: dict[int, set[int]] = {}  # wid -> pids at root
        self.emitted: set[int] = set()
        self.down = False  # global stop flag
        self.job_dead = False
        self.paused_until = 0.0  # checkpoint barrier pause
        self.last_ckpt_idx = [0] * P
        self.node_of = [p % cfg.num_nodes for p in range(P)]
        self.node_alive = [True] * cfg.num_nodes
        # online protocol monitor — same passive subscription as the Holon
        # harness, so both runtimes alert through one code path
        self.monitor = None
        if cfg.obs_monitor:
            self.monitor = OnlineMonitor.from_config(cfg)
            self.monitor.attach(self.obs)

    # ---- per-partition processing loop -------------------------------------
    def _loop_part(self, pid: int):
        cfg = self.cfg
        if self.job_dead or self.down or not self.node_alive[self.node_of[pid]]:
            return
        if self.idx[pid] >= cfg.num_batches:
            return
        if self.sim.now < self.paused_until:  # aligned-barrier stall
            self.sim.at(self.paused_until, lambda: self._loop_part(pid))
            return
        avail = (self.idx[pid] + 1) * cfg.batch_span_ms
        if self.sim.now < avail:
            self.sim.at(avail, lambda: self._loop_part(pid))
            return
        b = self.idx[pid]
        self.idx[pid] += 1
        frac = float(self.valid_frac[pid, b])
        n_events = int(round(frac * cfg.events_per_batch))
        self.consumer.count_events(self.sim.now, n_events)
        proc = max(cfg.batch_proc_ms * frac, cfg.batch_proc_ms / cfg.events_per_batch)
        if self.obs.on:
            nid = self.node_of[pid]
            queue_ms = self.sim.now - (b + 1) * cfg.batch_span_ms
            self.obs.event(
                "exec.batch", node=nid, partition=pid, status="ok",
                t_end_ms=self.sim.now + proc, idx=b, queue_ms=queue_ms,
            )
            reg = self.obs.registry
            reg.counter("batches_folded", node=nid).inc()
            reg.counter("events_folded", node=nid).inc(n_events)
            reg.histogram("phase_ms", phase="queue").observe(queue_ms)
            reg.histogram("phase_ms", phase="process").observe(proc)
        # local watermark after this batch = end of batch span; a leaf
        # forwards every window whose assigner-provided end it has passed
        # (wid < first_dirty_wid(wm) — under tumbling, wm // window_len)
        wm = (b + 1) * cfg.batch_span_ms
        closed = int(self.query.assigner.first_dirty_wid(wm))
        for wid in range(closed):
            if (wid, pid) not in self.forwarded:
                self.forwarded.add((wid, pid))
                if self.obs.on:
                    # up-tree forward: the leaf half of the slowest-path
                    # causality critical-path analysis reconstructs
                    # (obs/critpath.py pairs it with shuffle.arrive)
                    self.obs.event(
                        "shuffle.fwd", node=self.node_of[pid], partition=pid,
                        window=wid, dst=0, hops=self.tree_depth,
                    )
                # tree_depth reliable hops toward the root (node 0): each
                # hop pays network latency + the output-buffer flush, plus
                # one RTO per lost transmission; a partition parks the
                # partial at the fabric until heal
                self.net.send_reliable(
                    self.node_of[pid], 0, "shuffle", PARTIAL_BYTES,
                    lambda w=wid, p=pid: self._arrive(w, p),
                    latency_ms=cfg.shuffle_hop_ms + BUFFER_TIMEOUT_MS,
                    hops=self.tree_depth,
                )
        self.sim.after(proc, lambda: self._loop_part(pid))

    def _arrive(self, wid: int, pid: int):
        if self.job_dead or self.down:
            return
        s = self.arrived.setdefault(wid, set())
        s.add(pid)
        if self.obs.on:
            # root-side arrival: the LAST arrive per window is the slowest
            # path the paper's latency claim is about (obs/critpath.py)
            self.obs.event("shuffle.arrive", node=0, partition=pid, window=wid,
                           src=self.node_of[pid])
        if len(s) >= self.cfg.num_partitions and wid not in self.emitted:
            self.emitted.add(wid)
            fresh = self.consumer.emit(self.sim.now, 0, wid, None)
            if self.obs.on:
                # root emission: value digest is 0 — the modeled tree ships
                # partials, not materialized values (latency is the metric)
                self.obs.event(
                    "emit", node=0, partition=0, window=wid,
                    status="accepted" if fresh else "duplicate",
                    latency_ms=max(
                        0.0,
                        self.sim.now - float(self.query.assigner.end_ts(wid)),
                    ),
                    digest=0,
                )

    # ---- checkpoint barrier -------------------------------------------------
    def _loop_ckpt(self):
        if self.job_dead:
            return
        cfg = self.cfg
        if not self.down:
            self.last_ckpt_idx = list(self.idx)
            self.paused_until = self.sim.now + cfg.flink_barrier_pause_ms
            if self.obs.on:
                self.obs.event(
                    "flink.barrier", node=0, t_end_ms=self.paused_until,
                    frontier=tuple(self.last_ckpt_idx),
                )
                self.obs.registry.counter("ckpt_barriers").inc()
        self.sim.after(cfg.flink_ckpt_interval_ms, self._loop_ckpt)

    # ---- failure handling -----------------------------------------------------
    def fail_node(self, nid: int):
        if self.obs.on:
            # owned=() — centralized recovery has no per-partition steal, so
            # the auditor tracks downtime via flink.down/flink.recover instead
            self.obs.event("node.crash", node=nid, owned=())
        self.node_alive[nid] = False
        self.sim.after(self.cfg.flink_hb_timeout_ms, lambda: self._detect())

    def restart_node(self, nid: int):
        if self.obs.on:
            self.obs.event("node.restart", node=nid)
        self.node_alive[nid] = True
        if self.down and not self.job_dead:
            self._recover()

    def _detect(self):
        if self.job_dead or self.down:
            return
        self.down = True
        if self.obs.on:
            self.obs.event("flink.down", node=0, status="node_failure")
        if all(self.node_alive) or self.cfg.flink_spare_slots:
            self._recover()
        # else: job stays down until a node restarts (or forever — Fig. 6)

    # ---- network partitions (docs/protocol.md §4) --------------------------
    def _jm_separated(self) -> bool:
        """Is any alive TaskManager unreachable from the JobManager side
        (the partition group holding node 0)?"""
        return self.net.partitioned() and any(
            self.node_alive[n] and not self.net.reachable(n, 0)
            for n in range(self.cfg.num_nodes)
        )

    def _on_partition(self, groups):
        self.net.set_partition(*groups)
        self.sim.after(self.cfg.flink_hb_timeout_ms, self._detect_partition)

    def _detect_partition(self):
        # JM heartbeats time out across the cut: global stop, like a crash —
        # but recovery cannot complete until the fabric heals
        if not self.job_dead and not self.down and self._jm_separated():
            self.down = True
            if self.obs.on:
                self.obs.event("flink.down", node=0, status="jm_partition")

    def _on_heal(self):
        self.net.heal()
        if self.down and not self.job_dead:
            self._recover()

    def _recover(self):
        cfg = self.cfg

        def up():
            if self.job_dead or not self.down:
                return
            if not (all(self.node_alive) or cfg.flink_spare_slots):
                return
            if self._jm_separated():
                return  # still partitioned; the heal event retries recovery
            self.down = False
            if self.obs.on:
                self.obs.event("flink.recover", node=0,
                               frontier=tuple(self.last_ckpt_idx))
            # spare slots: reassign dead nodes' partitions to live nodes
            live = [n for n in range(cfg.num_nodes) if self.node_alive[n]]
            for pid in range(cfg.num_partitions):
                if not self.node_alive[self.node_of[pid]]:
                    self.node_of[pid] = live[pid % len(live)]
            self.idx = list(self.last_ckpt_idx)
            # partials not yet emitted are lost with operator state -> replayed
            self.forwarded = {(w, p) for (w, p) in self.forwarded if w in self.emitted}
            self.arrived = {w: s for w, s in self.arrived.items() if w in self.emitted}
            for pid in range(cfg.num_partitions):
                self.sim.after(0.0, lambda p=pid: self._loop_part(p))

        self.sim.after(cfg.flink_restart_ms + cfg.flink_restore_ms, up)

    # ---- driver ---------------------------------------------------------------
    def run(
        self,
        scenario: Scenario | FailureScenario | None = None,
        horizon_ms: float | None = None,
    ):
        scenario = as_scenario(scenario)
        cfg = self.cfg
        for pid in range(cfg.num_partitions):
            self.sim.after(0.0, lambda p=pid: self._loop_part(p))
        self.sim.after(cfg.flink_ckpt_interval_ms, self._loop_ckpt)
        for ev in scenario.events:
            if ev.kind == "crash":
                for nid in ev.nodes:
                    self.sim.at(ev.t_ms, lambda n=nid: self.fail_node(n))
            elif ev.kind == "restart":
                for nid in ev.nodes:
                    self.sim.at(ev.t_ms, lambda n=nid: self.restart_node(n))
            elif ev.kind == "partition":
                self.sim.at(ev.t_ms, lambda gs=ev.groups: self._on_partition(gs))
            elif ev.kind == "heal":
                self.sim.at(ev.t_ms, self._on_heal)
            elif ev.kind == "degrade":
                self.sim.at(
                    ev.t_ms,
                    lambda e=ev: self.net.degrade(
                        e.nodes, loss=e.loss, jitter_ms=e.jitter_ms
                    ),
                )
            else:
                raise ValueError(
                    f"Flink baseline is fixed-membership; {ev.kind!r} events "
                    "only apply to the Holon runtime"
                )
        horizon = horizon_ms if horizon_ms is not None else cfg.horizon_ms + 5000.0
        self.obs.start_snapshots()
        self.sim.run(until=horizon)
        self.obs.buf.flush_spill()
        self.consumer.net_stats = self.net.class_stats()
        return self.consumer


def run_flink(
    cfg: SimConfig, query: Query, scenario: Scenario | FailureScenario | None = None,
    horizon_ms: float | None = None, log: EventBatch | None = None, device="cuda",
) -> Consumer:
    h = FlinkHarness(cfg, query, log=log, device=device)
    return h.run(scenario, horizon_ms)
