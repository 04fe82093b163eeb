"""Holon Streaming runtime — Algorithm 2 with decentralized coordination,
driven by the discrete-event simulator (port of ``repro.runtime.harness``).

Every node runs four independent loops (no global coordination anywhere):

  executor   : round-robin over owned partitions; read next available input
               batch; fold it into the node replica (the port's dataplane,
               on the harness's device);
               emit every newly-completed window (gated by the global
               watermark, so emissions are deterministic and idempotent).
  sync       : every ``sync_interval`` publish a per-peer *delta*
               (``delta_since`` the peer's acked baseline) on the broadcast
               stream; peers lattice-join it on delivery.  A peer applies a
               delta only when its replica dominates the delta's baseline
               (the causal delta-merging condition) and acks the sender's
               marker; otherwise it nacks, the sender drops the baseline,
               and the next round ships the full resident state.  With
               ``cfg.delta_sync=False`` the loop broadcasts whole replicas
               (the paper's original protocol, kept for comparison).
               *Which* peers a round contacts is the pluggable dissemination
               topology (``cfg.topology``, runtime/topology.py): the
               all-to-all oracle, or a sparse graph — rotating k-ring,
               hypercube, seeded partial view — whose multi-hop relay keeps
               outputs byte-identical at sub-quadratic per-round traffic
               (docs/protocol.md §5).
               Message-sequence walkthrough: docs/protocol.md §2.
  checkpoint : every ``ckpt_interval`` put each owned partition's
               (nxt_idx, nxt_odx, emitted_upto, replica, local) to storage —
               unsynchronized, local decision ("sometimes do").  Snapshots
               carry their delta-coverage baseline and the membership epoch.
  control    : heartbeat peers (beacons carry the membership epoch; a
               ``leaving`` beacon announces graceful departure; under a
               sparse topology they also piggyback a bounded liveness
               digest, so sightings spread transitively — docs/protocol.md
               §5); on silence > ``hb_timeout`` — or on a leaving beacon —
               recompute the deterministic rendezvous assignment over the
               live membership and *steal* orphaned partitions by fetching
               their checkpoints (Recover).  Walkthrough: docs/protocol.md §3.

Membership is fully dynamic: ``HolonHarness.reconfigure(add=…, remove=…)`` is
the operator control-plane event.  New nodes bootstrap by requesting a
full-state sync from the first live peer they hear (docs/protocol.md §3.1);
removed nodes drain — final delta flush, fresh per-partition handoff
checkpoints, then a leaving beacon (docs/protocol.md §3.2) — so planned
scale-in pays no replay, unlike a crash.  Partition placement is rendezvous
hashing over the live view: any two converged views agree on every owner,
and membership churn only moves the partitions it must.

Failure injection flips ``alive``; restart wipes volatile state and rejoins —
recovery is work stealing like any other reconfiguration (paper §4.3).
Exactly-once: deterministic replay from checkpoints + consumer dedup by
(partition, window); property-tested against a failure-free oracle.

Every message above rides the :class:`~repro_torch.runtime.net.NetworkFabric`
(docs/protocol.md §4): gossip (heartbeats, sync deltas, acks/nacks) on the
lossy fire-and-forget tier — convergence only needs at-least-once *eventual*
delivery, because a lost delta is subsumed by the next round's
delta-since-unmoved-baseline — while checkpoint put/get and the joiner's
state request use retried request-response over idempotent handlers.
Scenarios can partition, heal, and degrade links (``Scenario.partition`` /
``heal`` / ``degrade``); with the default lossless zero-jitter profile the
fabric reproduces the pre-fabric event schedule bit-for-bit.

On the port: the fold, the merges and the reads run on ``device`` (the card
unless the caller passes ``device="cpu"``; without a card a CUDA device
raises, and nothing falls back to the host).  A node's replica is a stack of
one (``WSpec.zero(1)``): batches are ``[1, B]`` slices of the log on the
device, and a read's ``[1, out_width]`` row reaches the consumer as the JAX
package's f32 ``(out_width,)`` array, so trace digests match byte for byte.
The protocol's bookkeeping stays on the host, as numpy: the ``(folded,
progress)`` coverage markers (``marker_of``, one device-to-host copy a spec),
the per-batch valid fraction and watermark (one copy of the log's ``valid``
and ``ts``).  Modelled bytes come from ``wcrdt.state_nbytes`` /
``delta_nbytes`` alone, which charge 4 bytes an int64-carried u32 id.  The
core is functional (no state tensor is written in place), so a checkpoint or
a sync payload that holds a replica is a snapshot, as a JAX array is.  The
dataplane runs eagerly, with no stand-in for the JAX package's ``jit``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core import wcrdt as W
from repro_torch.obs.monitor import OnlineMonitor
from repro_torch.obs.telemetry import Telemetry
from repro_torch.runtime.config import FailureScenario, Scenario, SimConfig, as_scenario
from repro_torch.runtime.consumer import Consumer
from repro_torch.runtime.net import (
    CTRL_BYTES,
    GOSSIP_ENTRY_BYTES,
    HB_BYTES,
    STORAGE,
    NetworkFabric,
)
from repro_torch.runtime.sim import Sim
from repro_torch.runtime.topology import topology_from_spec
from repro_torch.runtime.storage import CheckpointStorage, PartitionCheckpoint
from repro_torch.streaming.events import EventBatch
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from repro_torch.streaming.queries import Query

_M64 = (1 << 64) - 1


def _hrw_score(pid: int, nid: int) -> int:
    """Deterministic 64-bit mix of (partition, node) — splitmix64 finalizer,
    so placement is identical across processes (no Python hash salt)."""
    x = (pid * 0x9E3779B97F4A7C15 + (nid + 1) * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def assignment(pid: int, live_nodes: Iterable[int]) -> int:
    """Deterministic partition→node rule over the live membership set:
    rendezvous (highest-random-weight) hashing.  Two nodes with converged
    views agree on every owner, and a membership change moves only the
    partitions whose winner joined or left (tests/test_reconfig.py)."""
    best, best_score = -1, -1
    for n in live_nodes:
        s = _hrw_score(pid, n)
        if s > best_score or (s == best_score and n > best):
            best, best_score = n, s
    return best


@dataclasses.dataclass
class PartitionMeta:
    idx: int = 0  # next input-log batch index
    odx: int = 0  # next output index
    emitted_upto: int = 0  # first window id not yet emitted


class HolonNode:
    def __init__(self, nid: int, harness: "HolonHarness"):
        self.nid = nid
        self.h = harness
        self.alive = True
        self.owned: list[int] = []
        self.meta: dict[int, PartitionMeta] = {}
        self.locals: dict[int, Any] = {}
        self.replica = harness.init_shared()
        self.last_hb: dict[int, float] = {}
        self._rr = 0  # round-robin cursor over owned partitions
        self.generation = 0  # bumped on restart; stale callbacks check it
        # delta sync: per-peer acked (folded, progress) baseline per shared
        # spec — what the peer is known to hold; absent = ship full state
        self.peer_baseline: dict[int, tuple] = {}
        self._baseline_t: dict[int, float] = {}  # last ack time per peer
        # dynamic membership (docs/protocol.md §3)
        self.epoch = 0  # highest membership epoch seen (gossiped in beacons)
        self.departing = False  # set while draining for scale-in
        self._bootstrap_pending = False  # joiner: request state on first hb
        # graceful departures seen (nid -> leaving-beacon time): guards
        # transitive liveness gossip against resurrecting a drained peer
        # from a stale relayed sighting (docs/protocol.md §5); a sighting
        # newer than the departure (scale-out revival) clears the entry
        self.departed: dict[int, float] = {}
        # subscription-versioned peer-list cache (rebuilding the full list
        # per beacon/sync round is O(N) x every round x every node)
        self._peers_cache: tuple | None = None

    # ---- lifecycle ---------------------------------------------------------
    def boot(self, initial_pids: list[int]):
        obs = self.h.obs
        if obs.on:
            obs.event(
                "node.boot", node=self.nid,
                status="joiner" if self._bootstrap_pending else "member",
                pids=tuple(sorted(initial_pids)), epoch=self.epoch,
            )
        for pid in sorted(initial_pids):
            self._adopt(pid, ckpt=None)
        sim = self.h.sim
        gen = self.generation
        sim.after(0.0, lambda: self._loop_exec(gen))
        sim.after(self.h.cfg.sync_interval_ms, lambda: self._loop_sync(gen))
        sim.after(self.h.cfg.hb_interval_ms, lambda: self._loop_control(gen))
        sim.after(self.h.cfg.ckpt_interval_ms, lambda: self._loop_ckpt(gen))
        self._broadcast_hb()

    def fail(self):
        if self.h.obs.on:
            # the owned-partition snapshot is what the auditor's
            # recovery-bound invariant checks adoption against
            self.h.obs.event("node.crash", node=self.nid, owned=tuple(self.owned))
        self.alive = False

    def restart(self):
        """Rejoin with empty volatile state; recover owned work from storage."""
        if self.h.obs.on:
            self.h.obs.event("node.restart", node=self.nid,
                             generation=self.generation + 1)
        self.generation += 1
        self.alive = True
        self.owned = []
        self.meta = {}
        self.locals = {}
        self.replica = self.h.init_shared()
        self.last_hb = {}
        self._rr = 0
        self.peer_baseline = {}
        self._baseline_t = {}
        self.departing = False
        self._bootstrap_pending = False
        self.departed = {}
        self.h._subscribe(self.nid)  # rejoin the broadcast stream
        self.boot([])
        # control loop will steal this node's assigned partitions

    def drain(self):
        """Graceful scale-in (docs/protocol.md §3.2): flush a final delta to
        every peer, write fresh handoff checkpoints for every owned
        partition, announce departure, leave.  The flush is scheduled before
        the leaving beacon, and the simulator delivers FIFO per timestamp,
        so peers rebalance only after our state is on the wire — takeover
        reads a checkpoint at the exact input frontier (no replay).

        The flush and the leaving beacon go to *every* subscribed peer even
        under a sparse topology (docs/protocol.md §5): departure is a rare
        one-shot control event, and telling everyone directly is what lets
        peers drop our baselines and rebalance without waiting for the
        gossip graph to carry the news."""
        if not self.alive or self.departing:
            return
        if self.h.obs.on:
            self.h.obs.event("node.drain", node=self.nid, owned=tuple(self.owned))
        self.departing = True
        self._publish_sync(flush=True)
        for pid in list(self.owned):
            self._handoff(pid)
        self._broadcast_hb(leaving=True)
        self.h._unsubscribe(self.nid)  # close our broadcast subscription
        self.alive = False

    # ---- helpers -----------------------------------------------------------
    def _adopt(self, pid: int, ckpt: PartitionCheckpoint | None):
        if pid in self.meta:
            return
        q = self.h.query
        if ckpt is None:
            self.meta[pid] = PartitionMeta()
            self.locals[pid] = self.h.init_local()
        else:
            self.meta[pid] = PartitionMeta(ckpt.nxt_idx, ckpt.nxt_odx, ckpt.emitted_upto)
            self.locals[pid] = ckpt.local
            if q.shared_specs:
                self.replica = self.h.merge_fn(self.replica, ckpt.shared)
        self.owned = sorted(set(self.owned) | {pid})
        if self.h.obs.on:
            self.h.obs.registry.gauge("owned_partitions", node=self.nid).set(
                len(self.owned)
            )

    def _drop(self, pid: int):
        if pid in self.meta:
            self.owned.remove(pid)
            del self.meta[pid]
            del self.locals[pid]
            if self.h.obs.on:
                self.h.obs.registry.gauge("owned_partitions", node=self.nid).set(
                    len(self.owned)
                )

    def _put_ckpt(self, pid: int, ck: PartitionCheckpoint):
        """Ship one checkpoint over the retried storage tier, recording the
        node-side request (the storage side records ``ckpt.apply`` with the
        frontier that actually stuck — docs/observability.md §2)."""
        if self.h.obs.on:
            self.h.obs.event(
                "ckpt.put", node=self.nid, partition=pid, nxt_idx=ck.nxt_idx,
                emitted_upto=ck.emitted_upto, epoch=ck.epoch,
            )
        self.h.net.rpc(
            self.nid, STORAGE, "ckpt_put", self.h.ckpt_nbytes,
            lambda p=pid, c=ck: self.h.storage.put(p, c),
        )

    def _handoff(self, pid: int):
        """Planned ownership release: put a checkpoint at the *current*
        frontier, then drop.  The next owner resumes from nxt_idx instead of
        replaying from the last periodic snapshot — this is what makes
        scale-in / rebalance nearly free relative to crash recovery."""
        m = self.meta[pid]
        if self.h.obs.on:
            self.h.obs.event("part.handoff", node=self.nid, partition=pid,
                             nxt_idx=m.idx)
        self._put_ckpt(pid, self._checkpoint_of(pid, m))
        self._drop(pid)

    def _checkpoint_of(self, pid: int, m: PartitionMeta) -> PartitionCheckpoint:
        return PartitionCheckpoint(
            nxt_idx=m.idx,
            nxt_odx=m.odx,
            emitted_upto=m.emitted_upto,
            shared=self.replica,
            local=self.locals[pid],
            # coverage marker of the shared snapshot: recovery knows
            # exactly which deltas the checkpoint subsumes, and peers'
            # domination checks replay deterministically from it
            baseline=self.h.marker_of(self.replica),
            epoch=self.epoch,
        )

    def _live_view(self) -> list[int]:
        now = self.h.sim.now
        live = [self.nid]
        for nid, t in self.last_hb.items():
            if now - t <= self.h.cfg.hb_timeout_ms:
                live.append(nid)
        return sorted(set(live))

    def _peers(self) -> list["HolonNode"]:
        """Everyone else still subscribed to the broadcast stream (drained
        nodes closed their subscription, so nobody pays to publish to them —
        restart/scale_out re-subscribes).  Cached against the harness's
        subscription version: the list only changes on node registration,
        drain/decommission, or restart, so the per-round rebuild collapses
        to a version check (verified byte-identical pre/post)."""
        cache = self._peers_cache
        ver = self.h._sub_version
        if cache is None or cache[0] != ver:
            nodes = [
                n
                for n in self.h.nodes.values()
                if n.nid != self.nid and n.nid not in self.h.unsubscribed
            ]
            cache = (ver, nodes, [n.nid for n in nodes])
            self._peers_cache = cache
        return cache[1]

    def _peer_nids(self) -> list[int]:
        self._peers()  # refresh the versioned cache
        return self._peers_cache[2]

    # bounded liveness digest piggybacked on sparse-topology beacons: big
    # enough to flood fresh sightings in O(log N) rounds, small enough to
    # keep heartbeats O(1) — docs/protocol.md §5
    GOSSIP_DIGEST = 16

    def _gossip_digest(self) -> tuple:
        """The freshest sightings we hold, newest first (nid tie-break), so
        a relayed entry always carries the *original* beacon send-time —
        transitive liveness never claims more than a direct beacon did."""
        items = sorted(self.last_hb.items(), key=lambda kv: (-kv[1], kv[0]))
        return tuple(items[: self.GOSSIP_DIGEST])

    def _broadcast_hb(self, leaving: bool = False):
        if not self.alive and not leaving:
            return
        t, ep, joining = self.h.sim.now, self.epoch, self._bootstrap_pending
        topo = self.h.topology
        peers = self._peers()
        if leaving or not topo.sparse:
            # all-to-all, and every leaving beacon: direct to everyone,
            # no digest (transitive gossip is provably redundant when each
            # beacon already reaches each peer — docs/protocol.md §5)
            targets, view, gone = peers, (), ()
        else:
            rnd = int(t // max(self.h.cfg.hb_interval_ms, 1.0))
            sel = set(topo.peers_of(self.nid, rnd, self._peer_nids()))
            targets = [p for p in peers if p.nid in sel]
            view = self._gossip_digest()
            gone = tuple(
                sorted(self.departed.items(), key=lambda kv: (-kv[1], kv[0]))
                [: self.GOSSIP_DIGEST]
            )
        nbytes = HB_BYTES + GOSSIP_ENTRY_BYTES * (len(view) + len(gone))
        for other in targets:
            self.h.net.send(
                self.nid, other.nid, "hb", nbytes,
                lambda o=other, s=self.nid, tt=t, e=ep, lv=leaving, jn=joining,
                       vw=view, gn=gone:
                    o._on_hb(s, tt, e, lv, jn, vw, gn),
            )

    def _note_sighting(self, nid: int, t: float):
        """Record a liveness sighting (direct beacon or relayed digest
        entry), guarded against stale news about a departed peer: only a
        sighting strictly newer than the departure revives it (that is a
        scale-out re-join, whose fresh beacons postdate the drain)."""
        dep = self.departed.get(nid)
        if dep is not None:
            if t <= dep:
                return
            del self.departed[nid]
        cur = self.last_hb.get(nid, -1.0)
        if t > cur:
            self.last_hb[nid] = t

    def _note_departed(self, nid: int, t: float):
        """Record a graceful departure (direct leaving beacon or relayed
        entry).  Ignored when we have already seen the peer alive *after*
        ``t`` — the departure news is stale and the peer is back."""
        if self.last_hb.get(nid, -1.0) > t:
            return
        self.departed[nid] = max(self.departed.get(nid, -1.0), t)
        known = self.last_hb.pop(nid, None) is not None
        self.peer_baseline.pop(nid, None)
        self._baseline_t.pop(nid, None)
        if known:
            # newly learned departure via gossip: rebalance like a direct
            # leaving beacon would have (docs/protocol.md §3.2)
            self._rebalance(self.generation)

    def _on_hb(self, sender: int, t: float, epoch: int, leaving: bool,
               joining: bool = False, view: tuple = (), gone: tuple = ()):
        if not self.alive:
            return
        self.epoch = max(self.epoch, epoch)
        if leaving:
            # graceful departure: drop the peer from the live view *now*
            # (no hb_timeout wait) and take over its partitions promptly
            self.departed[sender] = max(self.departed.get(sender, -1.0), t)
            self.last_hb.pop(sender, None)
            self.peer_baseline.pop(sender, None)
            self._baseline_t.pop(sender, None)
            self._rebalance(self.generation)
            return
        self._note_sighting(sender, t)
        for nid, tn in view:
            if nid != self.nid:
                self._note_sighting(nid, tn)
        for nid, tn in gone:
            if nid != self.nid:
                self._note_departed(nid, tn)
        if self._bootstrap_pending and not joining:
            # joiner bootstrap (docs/protocol.md §3.1): ask the first
            # *settled* peer we hear for its full state (a co-joiner's beacon
            # carries joining=True — its empty replica would waste the
            # one-shot handshake); the request rides the fabric's reliable
            # tier (docs/protocol.md §4) and the reply the ordinary sync
            # path with no baseline, so it merges unconditionally — a lost
            # reply is absorbed because our unseeded baseline makes the
            # server's next delta round ship its full resident state
            self._bootstrap_pending = False
            self.h.net.send_reliable(
                self.nid, sender, "state_req", CTRL_BYTES,
                lambda s=sender, me=self.nid:
                    self.h.nodes[s]._on_state_request(me),
            )

    # ---- loops ---------------------------------------------------------------
    def _loop_exec(self, gen: int):
        if not self.alive or gen != self.generation:
            return
        cfg = self.h.cfg
        delay = cfg.poll_idle_ms
        if self.owned:
            # round-robin over owned partitions ("sometimes do" in Alg. 2 —
            # deterministic for reproducibility)
            for _ in range(len(self.owned)):
                pid = self.owned[self._rr % len(self.owned)]
                self._rr += 1
                cost = self._try_process(pid)
                if cost is not None:
                    delay = cost
                    break
        self.h.sim.after(delay, lambda: self._loop_exec(gen))

    def _try_process(self, pid: int) -> float | None:
        """Fold the next available batch; returns its processing cost in ms
        (scaled by the batch's valid-event fraction, so skewed loads cost
        what they carry), or None when nothing was processed."""
        cfg, q = self.h.cfg, self.h.query
        m = self.meta[pid]
        if m.idx >= cfg.num_batches:
            self._emit_ready(pid)  # drain tail windows as gwm advances
            return None
        # batch b becomes available once the producer has written it
        avail = (m.idx + 1) * cfg.batch_span_ms
        if self.h.sim.now < avail:
            self._emit_ready(pid)
            return None
        batch = self.h.batch(pid, m.idx)
        frac = float(self.h.valid_frac[pid, m.idx])
        self.replica, self.locals[pid] = self.h.fold_fn(
            self.replica, self.locals[pid], batch, pid, m.idx
        )
        m.idx += 1
        n_events = int(round(frac * cfg.events_per_batch))
        self.h.consumer.count_events(self.h.sim.now, n_events)
        cost = max(cfg.batch_proc_ms * frac, cfg.batch_proc_ms / cfg.events_per_batch)
        obs = self.h.obs
        if obs.on:
            now = self.h.sim.now
            queue_ms = now - avail  # batch availability -> dequeue
            obs.event(
                "exec.batch", node=self.nid, partition=pid, status="ok",
                t_end_ms=now + cost, idx=m.idx - 1, queue_ms=queue_ms,
                # the batch watermark this fold raised progress[pid] to —
                # the provenance critical-path analysis replays the global
                # watermark lattice from (obs/critpath.py)
                wm=int(self.h.batch_wm[pid, m.idx - 1]),
            )
            reg = obs.registry
            reg.counter("batches_folded", node=self.nid).inc()
            reg.counter("events_folded", node=self.nid).inc(n_events)
            reg.histogram("phase_ms", phase="queue").observe(queue_ms)
            reg.histogram("phase_ms", phase="process").observe(cost)
        self._emit_ready(pid)
        return cost

    def _emit_ready(self, pid: int):
        """Emit every window completed under the current global watermark.

        Iterates assigner-complete windows (``gwm >= end_ts(wid)``): window
        ends are monotone in wid for any assigner, so completeness is
        prefix-closed and ``emitted_upto`` advances exactly as for tumbling
        — overlapping windows emit in wid order, each deduplicated by the
        consumer under crash/restart/reconfigure like any other window."""
        q = self.h.query
        m = self.meta[pid]
        gwm = int(q.global_watermark(self.replica, self.locals[pid]))
        obs = self.h.obs
        while q.assigner.complete(m.emitted_upto, gwm):
            wid = m.emitted_upto
            val, ok = self.h.read_fn(self.replica, self.locals[pid], wid)
            if not bool(ok):
                # complete but no longer ring-resident (emission lagged more
                # than num_slots windows) — skip and count; sized-away in cfg
                self.h.evicted_windows += 1
                if obs.on:
                    obs.event("emit", node=self.nid, partition=pid, window=wid,
                              status="evicted")
                m.emitted_upto = wid + 1
                continue
            # the replica's row as the JAX package's f32 (out_width,) array
            arr = val[0].cpu().numpy()
            fresh = self.h.consumer.emit(self.h.sim.now, pid, wid, arr)
            if obs.on:
                # digest lets the auditor tell benign duplicates (same value,
                # exactly-once by dedup) from genuine divergence
                obs.event(
                    "emit", node=self.nid, partition=pid, window=wid,
                    status="accepted" if fresh else "duplicate",
                    latency_ms=max(
                        0.0, self.h.sim.now - float(q.assigner.end_ts(wid))
                    ),
                    digest=zlib.crc32(arr.tobytes()),
                )
            m.odx += 1
            m.emitted_upto = wid + 1

    def _loop_sync(self, gen: int):
        if not self.alive or gen != self.generation:
            return
        self._publish_sync()
        self.h.sim.after(self.h.cfg.sync_interval_ms, lambda: self._loop_sync(gen))

    def _publish_sync(self, flush: bool = False):
        """One background sync round: a delta (or full replica) to each peer
        the dissemination topology schedules for this round — every peer
        under the all-to-all oracle, a sparse subset otherwise; multi-hop
        relay through intermediate replicas carries the rest
        (docs/protocol.md §5).  ``flush=True`` (drain) bypasses the
        topology and contacts everyone one last time.

        Identical baselines ship identical deltas, so the (deterministic)
        ``delta_fn`` runs once per *distinct* baseline, not once per peer —
        in the converged steady state that is one call per round."""
        if not self.h.query.shared_specs:
            return
        snap = self.replica
        marker = self.h.marker_of(snap)
        peers = self._peers()
        self.h.note_counterfactual_round(len(peers))
        topo = self.h.topology
        if flush or not topo.sparse:
            targets = peers
        else:
            rnd = int(self.h.sim.now // max(self.h.cfg.sync_interval_ms, 1.0))
            sel = set(topo.peers_of(self.nid, rnd, self._peer_nids()))
            targets = [p for p in peers if p.nid in sel]
        shipped_total = 0.0
        if self.h.cfg.delta_sync:
            ttl = self.h.cfg.baseline_ttl_ms
            if ttl > 0.0:
                self._age_baselines(ttl)
            by_base: dict = {}
            for other in targets:
                base = self.peer_baseline.get(other.nid, self.h.zero_base)
                key = tuple((bf.tobytes(), bp.tobytes()) for bf, bp in base)
                ent = by_base.get(key)
                if ent is None:
                    payload = self.h.delta_fn(snap, base)
                    ent = by_base[key] = (base, payload, self.h.delta_bytes(payload))
                base, payload, shipped = ent
                shipped_total += shipped
                self.h.net.send(
                    self.nid, other.nid, "sync", shipped,
                    lambda o=other, pay=payload, b=base, mk=marker: o._on_sync(
                        pay, self.nid, b, mk
                    ),
                )
        else:
            for other in targets:
                shipped_total += self.h.full_state_bytes
                self.h.net.send(
                    self.nid, other.nid, "sync", self.h.full_state_bytes,
                    lambda o=other, mk=marker: o._on_sync(
                        snap, self.nid, None, mk
                    ),
                )
        obs = self.h.obs
        if obs.on and targets:
            obs.event(
                "sync.publish", node=self.nid,
                status="delta" if self.h.cfg.delta_sync else "full",
                peers=tuple(o.nid for o in targets), shipped=shipped_total,
                topology=topo.name, fanout=len(targets),
            )
            obs.registry.counter("sync_rounds", node=self.nid).inc()

    def _age_baselines(self, ttl_ms: float):
        """Drop ack baselines not refreshed within ``ttl_ms``: the peer
        falls back to ``zero_base`` (one full-state round re-seeds it).
        Baselines are always *valid* — a peer acked what it holds and
        replicas only grow — so aging bounds staleness and memory under
        sparse fanout, never correctness (docs/protocol.md §5)."""
        cut = self.h.sim.now - ttl_ms
        for nid in [n for n, t in self._baseline_t.items() if t < cut]:
            del self._baseline_t[nid]
            self.peer_baseline.pop(nid, None)

    def _on_state_request(self, requester: int):
        """Serve a joiner's bootstrap: reply with the full replica and its
        marker, no baseline — the joiner merges unconditionally and acks,
        which also seeds our delta baseline for it.  The fabric meters the
        reply's real bytes; it deliberately does NOT count toward
        ``sync_bytes_full``, which models only periodic sync rounds."""
        if not self.alive or not self.h.query.shared_specs:
            return
        snap = self.replica
        marker = self.h.marker_of(snap)
        self.h.bootstrap_served.append((requester, self.nid))
        if self.h.obs.on:
            self.h.obs.event("sync.bootstrap", node=self.nid, dst=requester,
                             shipped=self.h.full_state_bytes)
        self.h.net.send(
            self.nid, requester, "sync", self.h.full_state_bytes,
            lambda r=requester, s=snap, mk=marker: self.h.nodes[r]._on_sync(
                s, self.nid, None, mk
            ),
        )

    def _on_sync(self, snap, src: int | None = None, base=None, marker=None):
        if not self.alive:
            return
        obs = self.h.obs
        if base is not None and not self._dominates(base):
            # our replica (e.g. freshly recovered from an older checkpoint)
            # does not cover the delta's baseline — applying it would lose
            # the gap.  Nack so the sender resets to a full-state round.
            self.h.sync_nacks += 1
            if obs.on:
                obs.event("sync.recv", node=self.nid, src=src, status="nack",
                          dominated=0)
                obs.registry.counter("sync_nacks", node=self.nid).inc()
            if src is not None:
                self.h.net.send(
                    self.nid, src, "sync_nack", CTRL_BYTES,
                    lambda s=src: self.h.nodes[s]._on_sync_nack(self.nid),
                )
            return
        if base is not None:
            self.replica = self.h.delta_merge_fn(self.replica, snap)
        else:
            self.replica = self.h.merge_fn(self.replica, snap)
        if obs.on:
            # recorded before the emit sweep so merge-then-emit causality
            # reads in order; marker=1 iff an ack will go back this instant
            obs.event(
                "sync.recv", node=self.nid, src=src,
                status="delta_merge" if base is not None else "full_merge",
                dominated=1, marker=1 if marker is not None and src is not None else 0,
            )
        # merged watermark may complete windows for our partitions
        for pid in self.owned:
            self._emit_ready(pid)
        if marker is not None and src is not None:
            self.h.net.send(
                self.nid, src, "sync_ack", self.h.marker_nbytes,
                lambda s=src, mk=marker: self.h.nodes[s]._on_sync_ack(self.nid, mk),
            )

    def _dominates(self, base) -> bool:
        """Causal delta-merging condition: do we already hold everything the
        sender assumed (per-spec folded & progress at or past the baseline)?"""
        for (f, p), (bf, bp) in zip(self.h.marker_of(self.replica), base):
            if np.any(f < bf) or np.any(p < bp):
                return False
        return True

    def _on_sync_ack(self, peer: int, marker):
        if not self.alive:
            return
        self._baseline_t[peer] = self.h.sim.now  # refresh the aging clock
        cur = self.peer_baseline.get(peer)
        if cur is None:
            self.peer_baseline[peer] = marker
        else:  # acks may arrive out of order; the baseline only grows
            self.peer_baseline[peer] = tuple(
                (np.maximum(cf, mf), np.maximum(cp, mp))
                for (cf, cp), (mf, mp) in zip(cur, marker)
            )

    def _on_sync_nack(self, peer: int):
        if self.alive:
            self.peer_baseline.pop(peer, None)
            self._baseline_t.pop(peer, None)

    def _loop_control(self, gen: int):
        if not self.alive or gen != self.generation:
            return
        self._broadcast_hb()
        self._rebalance(gen)
        self.h.sim.after(self.h.cfg.hb_interval_ms, lambda: self._loop_control(gen))

    def _rebalance(self, gen: int):
        """Steal partitions the rendezvous rule assigns to me that I don't
        own; hand off ones whose owner is now someone else.  A joiner still
        bootstrapping skips the sweep: under sparse dissemination its live
        view is one or two beacons old, and rendezvous over that sliver
        would steal partitions it must immediately hand back — the next
        control tick (post-bootstrap, view converging) rebalances for real."""
        if not self.alive or gen != self.generation or self._bootstrap_pending:
            return
        live = self._live_view()
        owners = self.h.owners_of(tuple(live))
        for pid, tgt in enumerate(owners):
            if tgt == self.nid and pid not in self.meta:
                # steal handshake, then a fabric-routed checkpoint fetch:
                # _finish_steal runs at the RPC's round-trip point (and
                # re-checks the assignment under the then-current view)
                self.h.sim.after(
                    self.h.cfg.steal_delay_ms,
                    lambda p=pid, g=gen: self.h.net.rpc(
                        self.nid, STORAGE, "ckpt_get", CTRL_BYTES,
                        lambda p=p, g=g: self._finish_steal(p, g),
                    ),
                )
            elif tgt != self.nid and pid in self.meta:
                self._handoff(pid)

    def _finish_steal(self, pid: int, gen: int):
        if not self.alive or gen != self.generation or pid in self.meta:
            return
        # re-check assignment under the current view (node may have returned)
        if self.h.owners_of(tuple(self._live_view()))[pid] != self.nid:
            return
        ck = self.h.storage.get(pid)
        if self.h.obs.on:
            self.h.obs.event(
                "steal.adopt", node=self.nid, partition=pid,
                status="ckpt" if ck is not None else "fresh",
                nxt_idx=ck.nxt_idx if ck is not None else 0,
            )
        self._adopt(pid, ck)

    def _loop_ckpt(self, gen: int):
        if not self.alive or gen != self.generation:
            return
        for pid in list(self.owned):
            # async durable write completes after one storage RTT; the RPC
            # tier re-issues lost legs (merge-on-put is idempotent)
            self._put_ckpt(pid, self._checkpoint_of(pid, self.meta[pid]))
        self.h.sim.after(self.h.cfg.ckpt_interval_ms, lambda: self._loop_ckpt(gen))


def runtime_device(device) -> torch.device:
    """The device a runtime runs its dataplane on; raises for a CUDA device
    when no card is present (nothing carries on on the host unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class HolonHarness:
    def __init__(self, cfg: SimConfig, query: Query, log: EventBatch | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.query = query
        self.device = dev = runtime_device(device)
        nx = NexmarkConfig(
            num_partitions=cfg.num_partitions,
            num_batches=cfg.num_batches,
            events_per_batch=cfg.events_per_batch,
            rate_per_partition=cfg.rate_per_partition,
            seed=cfg.seed,
            skew=cfg.skew,
        )
        self.log = (log if log is not None else generate_log(nx, dev)).map(lambda x: x.to(dev))
        valid, ts = self.log.valid.cpu().numpy(), self.log.ts.cpu().numpy()
        # per-(partition, batch) valid-event fraction: drives the modeled
        # processing cost, so load skew translates into node load
        self.valid_frac = np.asarray(valid, np.float64).mean(axis=-1)
        # per-(partition, batch) watermark — host mirror of the dataplane's
        # batch_watermark(), recorded on exec.batch spans so the critical-
        # path analyzer (obs/critpath.py) can replay the progress lattice
        # exactly; pure derived data, so it cannot perturb the run
        self.batch_wm = np.where(valid, np.asarray(ts, np.int64), -(2 ** 31)).max(axis=-1)
        self.sim = Sim()
        # one telemetry hub per run (docs/observability.md): the fabric,
        # storage, consumer, and every node record into the same bounded
        # ring + registry, so exported traces interleave in causal order
        self.obs = Telemetry.from_config(self.sim, cfg)
        # all inter-node and node<->storage delivery rides the fabric
        # (runtime/net.py, docs/protocol.md §4); the default profile is the
        # perfect wire, so fabric-off is not a mode — lossless IS the fabric
        self.net = NetworkFabric.from_config(self.sim, cfg, telemetry=self.obs)
        self.storage = CheckpointStorage(telemetry=self.obs)
        self.consumer = Consumer(
            window_len=cfg.window_len, assigner=query.assigner, telemetry=self.obs
        )
        self.evicted_windows = 0
        # the dataplane, eager: a node's partition index as a [1] tensor
        # on the device (a view of one arange, no copy a fold)
        self._pids = torch.arange(cfg.num_partitions, device=dev)
        self.merge_fn = query.merge_shared
        self.read_fn = query.read
        # delta-sync dataplane + sync-bandwidth accounting
        specs = query.shared_specs
        self.zero_base = tuple(
            (np.zeros(spec.num_partitions, np.int32), np.zeros(spec.num_partitions, np.int32))
            for spec in specs
        )
        self.full_state_bytes = float(
            sum(W.state_nbytes(st) for st in self.init_shared())
        )
        # wire sizes for messages the fabric meters: a sync ack carries the
        # (folded, progress) marker; a checkpoint ships the replica snapshot
        # plus the partition's local state and cursors
        self.marker_nbytes = float(sum(f.nbytes + p.nbytes for f, p in self.zero_base))
        loc = self.init_local()
        self.ckpt_nbytes = self.full_state_bytes + CTRL_BYTES + (
            float(W.state_nbytes(loc)) if loc is not None else 0.0
        )
        self.sync_nacks = 0
        self.sync_bytes_full = 0.0  # what full-state all-to-all would ship
        # dissemination topology of the gossip plane (docs/protocol.md §5):
        # one schedule object shared by every node's sync + heartbeat loops
        self.topology = topology_from_spec(cfg.topology, seed=cfg.seed)
        # dynamic membership: nid -> node, every node ever registered (the
        # broadcast-stream subscriber list); epoch bumps per reconfigure
        self.nodes: dict[int, HolonNode] = {
            n: HolonNode(n, self) for n in cfg.initial_membership
        }
        self.membership_epoch = 0
        # broadcast-stream subscription registry: drained nodes unsubscribe,
        # so publishers stop paying per-peer sync cost for them.  Mutate it
        # only through _subscribe/_unsubscribe — _sub_version invalidates
        # every node's cached peer list
        self.unsubscribed: set[int] = set()
        self._sub_version = 0
        # rendezvous assignment memo: owners of every partition per distinct
        # live view.  assignment() is a pure function, so converged views
        # (the common case — every node, every control tick) share one
        # entry instead of re-hashing num_partitions x live_nodes each tick
        self._assign_cache: dict[tuple[int, ...], tuple[int, ...]] = {}
        # (requester, server) log of §3.1 bootstrap handshakes (test probe)
        self.bootstrap_served: list[tuple[int, int]] = []
        # online protocol monitor (obs/monitor.py): a passive telemetry
        # subscriber — alerts accumulate on self.monitor, the run itself is
        # byte-identical with it on or off (docs/observability.md §6)
        self.monitor = None
        if cfg.obs_monitor:
            self.monitor = OnlineMonitor.from_config(cfg)
            self.monitor.attach(self.obs)

    # ---- the dataplane of one node (S=1 stacks on self.device) ---------------
    def init_shared(self) -> tuple:
        return tuple(spec.zero(1, self.device) for spec in self.query.shared_specs)

    def init_local(self):
        spec = self.query.local_spec
        return None if spec is None else spec.zero(1, self.device)

    def fold_fn(self, shared, local, batch: EventBatch, pid: int, idx: int):
        return self.query.fold(shared, local, batch, self._pids[pid:pid + 1], idx)

    def delta_merge_fn(self, replica: tuple, deltas: tuple) -> tuple:
        """Join received deltas (each an R=1 stack) into the replica: one
        fused launch a spec on the card where the window lattice is
        elementwise, bitwise ``W.merge(spec, replica, delta)``."""
        return tuple(W.join_delta_stack(spec, st, d)
                     for spec, st, d in zip(self.query.shared_specs, replica, deltas))

    def delta_fn(self, snap: tuple, base: tuple) -> tuple:
        """Each spec's delta since a host ``(folded, progress)`` baseline."""
        dev = self.device
        return tuple(
            W.delta_since(spec, st, torch.tensor(bf, device=dev), torch.tensor(bp, device=dev))
            for spec, st, (bf, bp) in zip(self.query.shared_specs, snap, base)
        )

    def _subscribe(self, nid: int) -> None:
        self.unsubscribed.discard(nid)
        self._sub_version += 1

    def _unsubscribe(self, nid: int) -> None:
        self.unsubscribed.add(nid)
        self._sub_version += 1

    def note_counterfactual_round(self, num_peers: int) -> None:
        """Accrue ``sync_bytes_full``: what a full-state **all-to-all**
        broadcast would have shipped for this sync round — always every
        subscribed peer at full state, regardless of the configured
        topology or delta sync.  Bootstrap serves are deliberately NOT
        counted (they are §3.1 membership traffic, metered by the fabric);
        mixing them in here used to overstate the counterfactual and make
        the delta-savings ratio look better than it was."""
        self.sync_bytes_full += self.full_state_bytes * num_peers

    def owners_of(self, live: tuple[int, ...]) -> tuple[int, ...]:
        """``assignment(pid, live)`` for every partition, memoized per live
        view (byte-identical to calling the rule directly)."""
        owners = self._assign_cache.get(live)
        if owners is None:
            if len(self._assign_cache) > 4096:  # churn bound, not a hot path
                self._assign_cache.clear()
            owners = tuple(
                assignment(p, live) for p in range(self.cfg.num_partitions)
            )
            self._assign_cache[live] = owners
        return owners

    # sync bandwidth now comes from the fabric's per-class meters — the
    # single source of truth for wire bytes (docs/protocol.md §4).  "sync"
    # covers delta/full rounds AND bootstrap full-state replies, exactly
    # what the pre-fabric ad-hoc counters summed.
    @property
    def sync_msgs(self) -> int:
        return self.net.msgs_of("sync")

    @property
    def sync_bytes(self) -> float:
        return self.net.bytes_of("sync")

    @staticmethod
    def marker_of(snap) -> tuple:
        """Host-side (folded, progress) coverage marker of a replica tuple:
        numpy i32 ``[P]`` each, one device-to-host copy a spec."""
        out = []
        for st in snap:
            fp = torch.stack((st.folded[0], st.progress[0])).cpu().numpy()
            out.append((fp[0], fp[1]))
        return tuple(out)

    @staticmethod
    def delta_bytes(deltas) -> float:
        return float(sum(float(W.delta_nbytes(d)) for d in deltas))

    def batch(self, pid: int, idx: int) -> EventBatch:
        """Batch ``idx`` of partition ``pid``: ``[1, B]`` views of the log."""
        return self.log.map(lambda x: x[pid:pid + 1, idx])

    # ---- control plane --------------------------------------------------------
    def reconfigure(self, add: Iterable[int] = (), remove: Iterable[int] = ()):
        """Operator control-plane event at the current sim time: grow and/or
        shrink the membership.  Added nodes bootstrap from a live peer;
        removed nodes drain (docs/protocol.md §3).  Bumps the membership
        epoch, which gossips through heartbeats into checkpoint markers."""
        add, remove = tuple(add), tuple(remove)
        if not add and not remove:
            return
        self.membership_epoch += 1
        if self.obs.on:
            self.obs.event(
                "ctrl.reconfigure", epoch=self.membership_epoch,
                add=tuple(int(n) for n in add),
                remove=tuple(int(n) for n in remove),
            )
        # the reconfigure command rides the control plane: every live
        # subscriber learns the new epoch with the event (so a drain's
        # leaving beacon below already gossips it) — crashed nodes catch up
        # from peers' beacons if they ever restart
        for node in self.nodes.values():
            if node.alive:
                node.epoch = max(node.epoch, self.membership_epoch)
        for nid in add:
            nid = int(nid)
            node = self.nodes.get(nid)
            if node is None:
                node = HolonNode(nid, self)
                self.nodes[nid] = node
                self._sub_version += 1  # new broadcast-stream subscriber
                node.epoch = self.membership_epoch
                node._bootstrap_pending = bool(self.query.shared_specs)
                node.boot([])
            elif not node.alive:
                node.epoch = max(node.epoch, self.membership_epoch)
                node.restart()
        for nid in remove:
            node = self.nodes.get(int(nid))
            if node is None:
                continue
            if node.alive:
                node.drain()
            else:
                # decommission a crashed node: it cannot drain, but it must
                # stop costing publishers; peers already rebalanced via
                # hb_timeout when it went silent
                self._unsubscribe(int(nid))

    def _node(self, nid: int) -> HolonNode:
        node = self.nodes.get(nid)
        if node is None:
            raise KeyError(
                f"scenario references node {nid}, which was never a member "
                f"(known: {sorted(self.nodes)})"
            )
        return node

    def run(
        self,
        scenario: Scenario | FailureScenario | None = None,
        horizon_ms: float | None = None,
    ):
        scenario = as_scenario(scenario)
        live0 = sorted(self.nodes)
        owners0 = self.owners_of(tuple(live0))
        for n in self.nodes.values():
            # seed membership: initial members boot knowing the t=0 roster
            # (the deployment's config), exactly as if every boot beacon had
            # already landed — under all-to-all this is what the first
            # beacon round establishes anyway (same send-time 0.0, so the
            # schedule is unchanged); under a sparse topology it stops a
            # cold two-beacon view from triggering spurious rendezvous
            # steals in the first control ticks (docs/protocol.md §5)
            for other in live0:
                if other != n.nid:
                    n.last_hb[other] = 0.0
            n.boot([p for p, o in enumerate(owners0) if o == n.nid])
        for ev in scenario.events:
            if ev.kind == "crash":
                for nid in ev.nodes:
                    self.sim.at(ev.t_ms, lambda n=nid: self._node(n).fail())
            elif ev.kind == "restart":
                for nid in ev.nodes:
                    self.sim.at(ev.t_ms, lambda n=nid: self._node(n).restart())
            elif ev.kind == "scale_out":
                self.sim.at(ev.t_ms, lambda ns=ev.nodes: self.reconfigure(add=ns))
            elif ev.kind == "scale_in":
                self.sim.at(ev.t_ms, lambda ns=ev.nodes: self.reconfigure(remove=ns))
            elif ev.kind == "partition":
                self.sim.at(ev.t_ms, lambda gs=ev.groups: self.net.set_partition(*gs))
            elif ev.kind == "heal":
                self.sim.at(ev.t_ms, self.net.heal)
            elif ev.kind == "degrade":
                self.sim.at(
                    ev.t_ms,
                    lambda e=ev: self.net.degrade(
                        e.nodes, loss=e.loss, jitter_ms=e.jitter_ms
                    ),
                )
        horizon = horizon_ms if horizon_ms is not None else self.cfg.horizon_ms + 5000.0
        self.obs.start_snapshots()
        self.sim.run(until=horizon)
        self.obs.buf.flush_spill()
        # expose sync-bandwidth + fabric counters on the consumer (probe)
        self.consumer.sync_msgs = self.sync_msgs
        self.consumer.sync_nacks = self.sync_nacks
        self.consumer.sync_bytes = self.sync_bytes
        self.consumer.sync_bytes_full = self.sync_bytes_full
        self.consumer.net_stats = self.net.class_stats()
        return self.consumer


def run_holon(
    cfg: SimConfig, query: Query, scenario: Scenario | FailureScenario | None = None,
    horizon_ms: float | None = None, log: EventBatch | None = None, device="cuda",
) -> Consumer:
    h = HolonHarness(cfg, query, log=log, device=device)
    return h.run(scenario, horizon_ms)
