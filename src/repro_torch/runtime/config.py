"""Simulation cost model + scenario DSL (failures and elastic reconfiguration).

Constants mirror the paper's experimental setup (§5.1/§5.2) where stated, and
conservative GCP-like values elsewhere.  All times in milliseconds of
simulated time.  Scenarios are sequences of timed control-plane events
(crash / restart / scale_out / scale_in); the membership-change events are
specified in docs/protocol.md §3.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # --- workload ---
    num_nodes: int = 5
    num_partitions: int = 10
    window_len: int = 1000  # ms, tumbling (Nexmark Q7 uses seconds-scale)
    num_slots: int = 64  # WCRDT ring size
    events_per_batch: int = 1024
    rate_per_partition: float = 10_000.0  # events/s
    num_batches: int = 400  # ~41 s of event time per partition
    seed: int = 0
    skew: float = 0.0  # zipf exponent of per-partition load (0 = uniform)

    # --- node execution ---
    batch_proc_ms: float = 2.0  # fold+emit compute per batch (2vCPU node)
    poll_idle_ms: float = 2.0  # executor re-poll when no batch available

    # --- Holon decentralized coordination (paper §4) ---
    delta_sync: bool = True  # ship delta_since(peer baseline), not replicas
    sync_interval_ms: float = 100.0  # background CRDT broadcast period
    # dissemination topology of the gossip plane (docs/protocol.md §5):
    # "all" (oracle, O(N^2) msgs/round) | "ring[:k]" | "hypercube" |
    # "partial[:fanout]" — sparse graphs trade propagation hops for
    # sub-quadratic sync traffic, never correctness (runtime/topology.py)
    topology: str = "all"
    # age out per-peer ack baselines not refreshed within this window (an
    # aged-out peer falls back to zero_base, i.e. one full-state round);
    # 0 disables aging — baselines are always *valid*, aging only bounds
    # staleness/memory under sparse fanout (docs/protocol.md §5)
    baseline_ttl_ms: float = 0.0
    broadcast_delay_ms: float = 5.0  # one-way broadcast-stream latency
    hb_interval_ms: float = 250.0  # decentralized liveness beacon
    hb_timeout_ms: float = 1000.0  # peer declared failed after this silence
    ckpt_interval_ms: float = 1000.0  # "sometimes do storage.put" period
    storage_rtt_ms: float = 50.0  # remote checkpoint read/write RTT
    steal_delay_ms: float = 20.0  # control-plane work-steal handshake

    # --- network fabric (runtime/net.py, docs/protocol.md §4) ---
    # Defaults model the perfect wire the runtime always assumed: zero loss,
    # fixed latency (broadcast_delay_ms / storage_rtt_ms above), no reorder —
    # under which the fabric schedules exactly the pre-fabric event sequence.
    net_loss: float = 0.0  # gossip message-loss probability per send
    net_jitter: str = "fixed"  # per-link latency dist: fixed|uniform|lognormal
    net_jitter_ms: float = 0.0  # jitter scale added to the base latency
    net_reorder_prob: float = 0.0  # chance of an extra bounded-reorder delay
    net_reorder_ms: float = 0.0  # size of that extra delay window
    net_seed: int = -1  # fabric RNG seed; -1 reuses the workload seed
    net_rto_ms: float = 200.0  # reliable-tier retransmit timeout
    storage_loss: float = 0.0  # loss on node<->storage RPC legs
    storage_retry_ms: float = 100.0  # RPC re-issue delay after a lost leg
    net_trace: bool = False  # record the per-message delivery trace

    # --- observability (repro/obs, docs/observability.md) ---
    # Off by default: with ``obs=False`` (and ``net_trace=False``) the
    # runtimes make zero telemetry records and stay bit-identical to a
    # build without the obs layer.  ``obs=True`` records protocol
    # spans/events + registry metrics (and implies net records — the
    # auditor's ack cross-check needs them); recording is passive, so
    # same-seed runs export byte-identical traces either way.
    obs: bool = False  # structured span tracing + metrics registry
    obs_trace_cap: int = 1 << 16  # bounded trace ring size (records)
    obs_snapshot_ms: float = 500.0  # registry snapshot period (sim-time)
    # stream ring-evicted records to this JSONL spool instead of dropping
    # them: memory stays bounded at obs_trace_cap while the full stream
    # stays auditable ("" = no spill, evictions count as dropped)
    obs_spill_path: str = ""
    # --- online protocol monitor (obs/monitor.py, docs/observability.md §6) —
    # a passive Telemetry subscriber checking invariants + health signals as
    # records are appended.  Implies ``obs``; monitoring never draws RNG or
    # schedules sim events, so runs stay byte-identical with it on or off.
    obs_monitor: bool = False
    obs_stall_ms: float = 5000.0  # [frontier-stall] alert after this quiet gap
    obs_slo_ms: float = 0.0  # emit-latency SLO; 0 disables [slo-burn]
    obs_slo_frac: float = 0.5  # [slo-burn] when > this frac of recent emits miss
    obs_sync_budget: float = 0.0  # sync bytes/s budget; 0 disables [sync-burn]

    # --- Flink-like centralized baseline (paper §5.1 config) ---
    flink_hb_interval_ms: float = 4000.0  # paper: 4 s
    flink_hb_timeout_ms: float = 6000.0  # paper: 6 s
    flink_ckpt_interval_ms: float = 5000.0  # paper: 5 s checkpoints
    flink_restart_ms: float = 8000.0  # job restart + state redistribute
    flink_restore_ms: float = 4000.0  # RocksDB restore from remote
    flink_barrier_pause_ms: float = 30.0  # per-checkpoint alignment stall
    flink_tree_fanin: int = 2  # static aggregation tree fan-in
    shuffle_hop_ms: float = 5.0  # per network hop in the agg tree
    flink_spare_slots: bool = False  # spare TaskManager slots for failover

    @property
    def batch_span_ms(self) -> float:
        return 1000.0 * self.events_per_batch / self.rate_per_partition

    @property
    def horizon_ms(self) -> float:
        return self.num_batches * self.batch_span_ms

    @property
    def initial_membership(self) -> tuple[int, ...]:
        """Node ids present at t=0.  Scenarios reference membership through
        this (not raw ``range(num_nodes)``) so scale events stay valid."""
        return tuple(range(self.num_nodes))


EVENT_KINDS = (
    "crash", "restart", "scale_out", "scale_in",
    # network-fabric events (runtime/net.py, docs/protocol.md §4)
    "partition", "heal", "degrade",
)


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One timed control-plane action over a set of node ids.

    ``partition`` carries ``groups`` (node-id sets that stay mutually
    connected) instead of ``nodes``; ``degrade`` carries the affected
    ``nodes`` plus the ``loss``/``jitter_ms`` overrides to apply (both None
    clears the nodes' degradation)."""

    t_ms: float
    kind: str  # one of EVENT_KINDS
    nodes: tuple[int, ...]
    groups: tuple[tuple[int, ...], ...] = ()
    loss: float | None = None
    jitter_ms: float | None = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown scenario event kind {self.kind!r}")
        if self.kind == "partition" and len(self.groups) < 2:
            raise ValueError("partition needs at least two groups")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """General timed control-plane script: crashes, restarts, elastic
    membership changes (docs/protocol.md §3), and network-fabric faults
    (docs/protocol.md §4).  Build fluently:

        Scenario("elastic").scale_out(4000, 4, 5).scale_in(9000, 4, 5)
        Scenario("split").partition(8000, (0, 1), (2, 3, 4)).heal(16000)

    ``crash``/``restart`` model unplanned failure + recovery of an existing
    node; ``scale_out`` adds brand-new nodes (or revives drained ones) that
    bootstrap from a live peer; ``scale_in`` drains nodes gracefully — final
    delta flush + handoff checkpoints before departure.  ``partition``
    splits the network into mutually unreachable groups until ``heal``;
    ``degrade`` worsens (or, with no overrides, restores) the links touching
    a set of nodes.
    """

    name: str = "baseline"
    events: tuple[ScenarioEvent, ...] = ()

    def _add(self, ev: ScenarioEvent) -> "Scenario":
        return dataclasses.replace(self, events=self.events + (ev,))

    def at(self, t_ms: float, kind: str, *nodes: int) -> "Scenario":
        return self._add(ScenarioEvent(float(t_ms), kind, tuple(int(n) for n in nodes)))

    def crash(self, t_ms: float, *nodes: int) -> "Scenario":
        return self.at(t_ms, "crash", *nodes)

    def restart(self, t_ms: float, *nodes: int) -> "Scenario":
        return self.at(t_ms, "restart", *nodes)

    def scale_out(self, t_ms: float, *nodes: int) -> "Scenario":
        return self.at(t_ms, "scale_out", *nodes)

    def scale_in(self, t_ms: float, *nodes: int) -> "Scenario":
        return self.at(t_ms, "scale_in", *nodes)

    def partition(self, t_ms: float, *groups) -> "Scenario":
        """Split the fabric into ``groups`` (iterables of node ids) that can
        only talk within themselves; nodes in no group form one residual
        side, and checkpoint storage stays reachable from everyone."""
        gs = tuple(tuple(int(n) for n in g) for g in groups)
        return self._add(ScenarioEvent(float(t_ms), "partition", (), groups=gs))

    def heal(self, t_ms: float) -> "Scenario":
        return self._add(ScenarioEvent(float(t_ms), "heal", ()))

    def degrade(
        self, t_ms: float, nodes, loss: float | None = None,
        jitter_ms: float | None = None,
    ) -> "Scenario":
        """Worsen every link touching ``nodes`` (loss and/or uniform jitter
        on top of the configured profile); with both overrides None the
        nodes' degradation is cleared."""
        ns = tuple(int(n) for n in nodes)
        return self._add(
            ScenarioEvent(float(t_ms), "degrade", ns, loss=loss, jitter_ms=jitter_ms)
        )

    @classmethod
    def baseline(cls) -> "Scenario":
        return cls()


@dataclasses.dataclass(frozen=True)
class FailureScenario:
    """When nodes fail and (optionally) restart, in simulated ms.

    The crash/restart-only ancestor of :class:`Scenario`, kept as the
    ergonomic spelling of the paper's three scenarios (§5.2):
      concurrent: two nodes at t, restart t+10s
      subsequent: two nodes at t, t+5s; each restarts 10s after its failure
      crash:      two nodes at t, never restarted
    """

    name: str = "baseline"
    fail_times_ms: tuple[float, ...] = ()
    fail_nodes: tuple[int, ...] = ()
    restart_times_ms: tuple[float, ...] = ()  # -1 = never

    def to_scenario(self) -> Scenario:
        s = Scenario(name=self.name)
        for t, nid, rt in zip(self.fail_times_ms, self.fail_nodes, self.restart_times_ms):
            s = s.crash(t, nid)
            if rt >= 0:
                s = s.restart(rt, nid)
        return s

    @classmethod
    def baseline(cls):
        return cls()

    @classmethod
    def concurrent(cls, t: float = 8000.0, nodes: tuple[int, int] = (0, 1)):
        return cls(
            name="concurrent",
            fail_times_ms=(t, t),
            fail_nodes=tuple(nodes),
            restart_times_ms=(t + 10_000, t + 10_000),
        )

    @classmethod
    def subsequent(cls, t: float = 8000.0, nodes: tuple[int, int] = (0, 1)):
        return cls(
            name="subsequent",
            fail_times_ms=(t, t + 5_000),
            fail_nodes=tuple(nodes),
            restart_times_ms=(t + 10_000, t + 15_000),
        )

    @classmethod
    def crash(cls, t: float = 8000.0, nodes: tuple[int, int] = (0, 1)):
        return cls(
            name="crash",
            fail_times_ms=(t, t),
            fail_nodes=tuple(nodes),
            restart_times_ms=(-1.0, -1.0),
        )


def as_scenario(scenario: "Scenario | FailureScenario | None") -> Scenario:
    """Normalize any scenario spelling (or None) to the event-list form."""
    if scenario is None:
        return Scenario()
    if isinstance(scenario, FailureScenario):
        return scenario.to_scenario()
    return scenario
