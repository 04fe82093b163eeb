"""Simulated network fabric: lossy, partitionable, byte-metered transport.

Every inter-node and node↔storage message in both runtimes (the Holon
harness *and* the Flink-like baseline, so comparisons stay apples-to-apples)
is delivered by a :class:`NetworkFabric` instead of raw ``sim.after``
callbacks.  The fabric owns the properties a transport can have:

* **latency** — seeded deterministic per-link distributions: fixed, or
  fixed + uniform / lognormal jitter (``LinkProfile.jitter``);
* **loss** — per-message Bernoulli drop (``LinkProfile.loss``);
* **bounded reordering** — jitter alone reorders within its window; an
  explicit ``reorder_prob``/``reorder_ms`` adds occasional extra delay;
* **partitions** — ``set_partition(groups…)`` blocks every link between
  groups until ``heal()``; nodes absent from every group form one implicit
  residual side.  Storage is a separate service and stays reachable;
* **degradation** — ``degrade(nodes, …)`` worsens every link touching the
  named nodes (loss / jitter / latency), e.g. one slow rack;
* **byte metering** — per-message-class and per-link counters
  (:class:`ClassStats`), unifying what used to be ad-hoc ``delta_bytes``
  accounting in the harness.

Which guarantee each message class actually *needs* — and why CRDT gossip
tolerates the fire-and-forget tier while bootstrap/handoff ride the retried
tier — is specified in docs/protocol.md §4 (Transport semantics); the
design rationale is DESIGN.md §9.  In
short: gossip (``hb``/``sync``/``sync_ack``/``sync_nack``) is lossy
fire-and-forget, because idempotent lattice joins make any later delivery
subsume a lost one; storage RPCs (``ckpt_put``/``ckpt_get``) are retried
request-response over idempotent handlers; the joiner's ``state_req`` and
the centralized baseline's ``shuffle`` partials ride a reliable (TCP-like)
tier — loss becomes retransmit delay, partitions park the message until
heal (a bootstrap request must survive the partition it was born into).

Determinism: every random draw comes from a per-link ``random.Random``
seeded by ``mix64(seed, src, dst)``, so (a) the same config+seed replays a
byte-identical delivery ``trace``, and (b) traffic on one link never
perturbs another link's draws.  A lossless zero-jitter profile makes *no*
RNG draws at all and schedules exactly one simulator event per message at
``latency_ms`` — the pre-fabric wire, preserved bit-for-bit.

Delivery records are typed :class:`~repro_torch.obs.records.TraceEvent`s
(``kind="net.msg"``) in the harness telemetry's bounded ring buffer
(docs/observability.md §2) — recorded when ``SimConfig.net_trace`` or
``obs`` is set, off by default so long chaos sweeps don't retain
per-message state, and bounded either way so they can't grow memory
without bound.  Recording is passive: it never draws RNG or schedules
events, so the lossless-profile bit-for-bit guarantee holds with tracing
on or off.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Hashable, Iterable

from repro_torch.obs.telemetry import Telemetry

# the durable checkpoint service rides the fabric as a distinguished
# endpoint: always reachable (it is not a cluster member), with its own
# LinkProfile (storage_rtt_ms latency, storage_loss)
STORAGE = "storage"

# nominal wire sizes for messages whose payload the simulation does not
# materialize (real payload classes — sync deltas, checkpoints — are
# metered with their measured nbytes)
HB_BYTES = 64.0
CTRL_BYTES = 16.0
# one (nid, timestamp) liveness-digest entry piggybacked on heartbeats by
# sparse dissemination topologies (docs/protocol.md §5): 4-byte id + 8-byte
# time.  All-to-all beacons carry no digest and stay at HB_BYTES.
GOSSIP_ENTRY_BYTES = 12.0

_M64 = (1 << 64) - 1


def _mix64(*parts: int) -> int:
    """splitmix64-style combine — stable across processes (no PYTHONHASHSEED)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (p & _M64)) * 0xBF58476D1CE4E5B9 & _M64
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & _M64
        x ^= x >> 31
    return x


def _endpoint_id(e: Hashable) -> int:
    return -1 if e == STORAGE else int(e)


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Delivery characteristics of one link direction (docs/protocol.md §4)."""

    latency_ms: float = 5.0  # base one-way latency
    jitter: str = "fixed"  # fixed | uniform | lognormal
    jitter_ms: float = 0.0  # uniform: +U(0, j); lognormal: median extra ≈ j
    loss: float = 0.0  # per-message drop probability
    reorder_prob: float = 0.0  # chance of an extra bounded-reorder delay
    reorder_ms: float = 0.0  # size of that extra delay window

    def __post_init__(self):
        if self.jitter not in ("fixed", "uniform", "lognormal"):
            raise ValueError(f"unknown jitter distribution {self.jitter!r}")

    @property
    def needs_rng(self) -> bool:
        return (
            self.loss > 0.0
            or (self.jitter != "fixed" and self.jitter_ms > 0.0)
            or self.reorder_prob > 0.0
        )


@dataclasses.dataclass
class ClassStats:
    """Wire accounting for one message class (bytes are metered at send
    time: a dropped packet still consumed sender bandwidth)."""

    msgs: int = 0
    bytes: float = 0.0
    dropped: int = 0  # lost + partitioned fire-and-forget messages
    retries: int = 0  # reliable-transport retransmits / RPC re-issues


class NetworkFabric:
    """All message delivery for one simulated deployment.

    ``send`` is the lossy fire-and-forget tier, ``send_reliable`` the
    TCP-like tier (loss → retransmit delay, partition → park until heal),
    ``rpc`` the retried request-response tier for idempotent storage and
    bootstrap handlers.  See docs/protocol.md §4 for which message class
    uses which tier and why that suffices for convergence.
    """

    @classmethod
    def from_config(cls, sim, cfg, telemetry: Telemetry | None = None) -> "NetworkFabric":
        """The one place SimConfig's net knobs become link profiles — both
        runtimes build their fabric here, so they cannot drift apart.
        ``telemetry`` shares the harness's trace buffer so net records and
        protocol spans land in one time-ordered stream."""
        return cls(
            sim,
            profile=LinkProfile(
                latency_ms=cfg.broadcast_delay_ms,
                jitter=cfg.net_jitter,
                jitter_ms=cfg.net_jitter_ms,
                loss=cfg.net_loss,
                reorder_prob=cfg.net_reorder_prob,
                reorder_ms=cfg.net_reorder_ms,
            ),
            storage_profile=LinkProfile(
                latency_ms=cfg.storage_rtt_ms, loss=cfg.storage_loss
            ),
            seed=cfg.seed if cfg.net_seed < 0 else cfg.net_seed,
            rto_ms=cfg.net_rto_ms,
            retry_ms=cfg.storage_retry_ms,
            record_trace=cfg.net_trace,
            telemetry=telemetry,
        )

    def __init__(
        self,
        sim,
        profile: LinkProfile | None = None,
        storage_profile: LinkProfile | None = None,
        seed: int = 0,
        rto_ms: float = 200.0,
        retry_ms: float = 100.0,
        record_trace: bool = False,
        telemetry: Telemetry | None = None,
    ):
        self.sim = sim
        self.profile = profile if profile is not None else LinkProfile()
        self.storage_profile = (
            storage_profile
            if storage_profile is not None
            else LinkProfile(latency_ms=50.0)
        )
        self.seed = int(seed)
        self.rto_ms = float(rto_ms)
        self.retry_ms = float(retry_ms)
        # shared harness telemetry, or a standalone one for bare fabrics;
        # record_trace=True enables its net-record stream either way
        self.telemetry = (
            telemetry
            if telemetry is not None
            else Telemetry(sim, trace_net=record_trace)
        )
        if record_trace:
            self.telemetry.trace_net = True
        self.groups: tuple[frozenset, ...] | None = None
        self._degraded: dict[Hashable, dict] = {}
        self._rngs: dict[tuple[int, int], random.Random] = {}
        self.stats: dict[str, ClassStats] = {}
        self.link_bytes: dict[tuple[Hashable, Hashable], float] = {}
        # parked reliable messages, re-sent on heal: (src, dst, cls, nbytes,
        # deliver, latency_ms, hops)
        self._parked: list[tuple] = []
        # per-class histogram cache: skips the registry's key-string build on
        # every delivery (the fabric is the hottest telemetry call site)
        self._delay_hists: dict[str, object] = {}

    @property
    def record_trace(self) -> bool:
        return self.telemetry.trace_net

    @property
    def trace(self) -> list:
        """Typed per-message delivery records (``TraceEvent``, kind
        ``net.msg``), oldest-first, from the bounded telemetry ring."""
        return self.telemetry.net_events()

    # ---- topology control --------------------------------------------------
    def set_partition(self, *groups: Iterable[Hashable]) -> None:
        """Split the cluster: only links within one group keep delivering.
        Nodes listed in no group form one implicit residual side; STORAGE
        stays reachable from everyone (it is a service, not a member)."""
        self.groups = tuple(frozenset(g) for g in groups)
        self.telemetry.event(
            "net.partition", groups=tuple(tuple(sorted(g)) for g in self.groups)
        )

    def heal(self) -> None:
        """Remove the partition and flush parked reliable messages (they
        deliver after a freshly sampled latency from heal time)."""
        self.telemetry.event("net.heal", parked=len(self._parked))
        self.groups = None
        parked, self._parked = self._parked, []
        for src, dst, cls, nbytes, deliver, latency_ms, hops in parked:
            self.send_reliable(
                src, dst, cls, nbytes, deliver, latency_ms=latency_ms, hops=hops
            )

    def partitioned(self) -> bool:
        return self.groups is not None

    def reachable(self, a: Hashable, b: Hashable) -> bool:
        if a == b or self.groups is None or STORAGE in (a, b):
            return True
        ga = gb = None
        for i, g in enumerate(self.groups):
            if a in g:
                ga = i
            if b in g:
                gb = i
        return ga == gb

    def degrade(
        self,
        nodes: Iterable[Hashable],
        loss: float | None = None,
        jitter_ms: float | None = None,
        latency_ms: float | None = None,
        jitter: str | None = None,
    ) -> None:
        """Worsen every link touching ``nodes``.  Numeric overrides combine
        with the base profile (and each other) by max — degradation never
        improves a link.  All-None clears the nodes' overrides."""
        fields = {
            k: v
            for k, v in (
                ("loss", loss),
                ("jitter_ms", jitter_ms),
                ("latency_ms", latency_ms),
                ("jitter", jitter),
            )
            if v is not None
        }
        # a jitter_ms override on a fixed-latency profile implies a
        # distribution; default to uniform so the knob has an effect
        if jitter_ms is not None and jitter is None and self.profile.jitter == "fixed":
            fields["jitter"] = "uniform"
        self.telemetry.event(
            "net.degrade", nodes=tuple(sorted(_endpoint_id(n) for n in nodes)),
            status="set" if fields else "clear",
        )
        for n in nodes:
            if fields:
                self._degraded[n] = {**self._degraded.get(n, {}), **fields}
            else:
                self._degraded.pop(n, None)

    # ---- link resolution ---------------------------------------------------
    def _profile(self, src: Hashable, dst: Hashable) -> LinkProfile:
        prof = self.storage_profile if STORAGE in (src, dst) else self.profile
        ov: dict = {}
        for e in (src, dst):
            for k, v in self._degraded.get(e, {}).items():
                if k == "jitter":
                    ov[k] = v
                else:
                    base = getattr(prof, k)
                    ov[k] = max(ov.get(k, base), base, v)
        return dataclasses.replace(prof, **ov) if ov else prof

    def _lat_floor(self, src: Hashable, dst: Hashable) -> float:
        """Degraded-link latency floor — applies even to messages that carry
        their own base latency (e.g. the baseline's shuffle hops), so
        ``degrade(latency_ms=…)`` slows every class on the link."""
        f = 0.0
        for e in (src, dst):
            v = self._degraded.get(e, {}).get("latency_ms")
            if v is not None:
                f = max(f, v)
        return f

    def _rng(self, src: Hashable, dst: Hashable) -> random.Random:
        key = (_endpoint_id(src), _endpoint_id(dst))
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(_mix64(self.seed, *key))
        return rng

    def _sample_latency(
        self,
        prof: LinkProfile,
        rng: random.Random | None,
        latency_ms: float | None,
        floor: float = 0.0,
    ) -> float:
        d = prof.latency_ms if latency_ms is None else max(latency_ms, floor)
        if rng is None:
            return d
        if prof.jitter == "uniform" and prof.jitter_ms > 0.0:
            d += rng.uniform(0.0, prof.jitter_ms)
        elif prof.jitter == "lognormal" and prof.jitter_ms > 0.0:
            d += prof.jitter_ms * rng.lognormvariate(0.0, 0.6)
        if prof.reorder_prob > 0.0 and rng.random() < prof.reorder_prob:
            d += rng.uniform(0.0, prof.reorder_ms)
        return d

    # ---- metering ----------------------------------------------------------
    def _meter(self, src, dst, cls: str, nbytes: float) -> ClassStats:
        st = self.stats.get(cls)
        if st is None:
            st = self.stats[cls] = ClassStats()
        st.msgs += 1
        st.bytes += nbytes
        link = (src, dst)
        self.link_bytes[link] = self.link_bytes.get(link, 0.0) + nbytes
        return st

    def _record(self, src, dst, cls, nbytes, status, t_deliver=-1.0, retries=0):
        self.telemetry.net_msg(src, dst, cls, nbytes, status, t_deliver, retries)

    def _observe_delay(self, cls: str, delay: float) -> None:
        """Per-class delivery-latency histogram — the wire-time slice of the
        per-phase breakdown (e.g. ``net_delivery_ms{cls=sync}`` is the sync
        phase's transport cost, docs/observability.md §1)."""
        if self.telemetry.on:
            h = self._delay_hists.get(cls)
            if h is None:
                h = self._delay_hists[cls] = self.telemetry.registry.histogram(
                    "net_delivery_ms", cls=cls)
            h.observe(delay)

    def msgs_of(self, cls: str) -> int:
        return self.stats[cls].msgs if cls in self.stats else 0

    def bytes_of(self, cls: str) -> float:
        return self.stats[cls].bytes if cls in self.stats else 0.0

    def dropped_of(self, cls: str) -> int:
        return self.stats[cls].dropped if cls in self.stats else 0

    def total_bytes(self) -> float:
        return sum(s.bytes for s in self.stats.values())

    def class_stats(self) -> dict[str, dict]:
        return {cls: dataclasses.asdict(s) for cls, s in sorted(self.stats.items())}

    # ---- transport tiers ---------------------------------------------------
    def send(
        self,
        src: Hashable,
        dst: Hashable,
        cls: str,
        nbytes: float,
        deliver: Callable[[], None],
        latency_ms: float | None = None,
    ) -> bool:
        """Fire-and-forget (gossip tier): deliver once after the sampled
        link latency, or drop silently on loss / partition.  Returns whether
        the message was scheduled for delivery."""
        st = self._meter(src, dst, cls, nbytes)
        if not self.reachable(src, dst):
            st.dropped += 1
            self._record(src, dst, cls, nbytes, "partitioned")
            return False
        prof = self._profile(src, dst)
        rng = self._rng(src, dst) if prof.needs_rng else None
        if prof.loss > 0.0 and rng.random() < prof.loss:
            st.dropped += 1
            self._record(src, dst, cls, nbytes, "lost")
            return False
        delay = self._sample_latency(prof, rng, latency_ms, self._lat_floor(src, dst))
        self._record(src, dst, cls, nbytes, "ok", self.sim.now + delay)
        self._observe_delay(cls, delay)
        self.sim.after(delay, deliver)
        return True

    def send_reliable(
        self,
        src: Hashable,
        dst: Hashable,
        cls: str,
        nbytes: float,
        deliver: Callable[[], None],
        latency_ms: float | None = None,
        hops: int = 1,
    ) -> None:
        """Reliable (TCP-like) tier, used by the centralized baseline's
        shuffle partials and the joiner's ``state_req``: each lost
        transmission costs one ``rto_ms`` retransmit delay per hop; a
        partitioned link parks the message until ``heal()``."""
        if not self.reachable(src, dst):
            self._meter(src, dst, cls, nbytes)
            self._parked.append((src, dst, cls, nbytes, deliver, latency_ms, hops))
            self._record(src, dst, cls, nbytes, "parked")
            return
        prof = self._profile(src, dst)
        rng = self._rng(src, dst) if prof.needs_rng else None
        floor = self._lat_floor(src, dst)
        delay, retries = 0.0, 0
        for _ in range(max(1, hops)):
            if prof.loss > 0.0:
                while retries < 64 and rng.random() < prof.loss:
                    retries += 1
                    delay += self.rto_ms
            delay += self._sample_latency(prof, rng, latency_ms, floor)
        st = self._meter(src, dst, cls, nbytes * (1 + retries))
        st.retries += retries
        # retries ride the record so critical-path analysis can split the
        # delivery delay into wire time vs retransmit stalls (obs/critpath.py)
        self._record(src, dst, cls, nbytes, "ok", self.sim.now + delay,
                     retries=retries)
        self._observe_delay(cls, delay)
        self.sim.after(delay, deliver)

    def rpc(
        self,
        src: Hashable,
        dst: Hashable,
        cls: str,
        nbytes: float,
        execute: Callable[[], None],
        latency_ms: float | None = None,
        max_tries: int = 10,
    ) -> None:
        """At-least-once request-response collapsed to one modeled round
        trip: ``execute()`` runs at the RTT point; loss of either leg (or a
        partition) re-issues the whole exchange after ``retry_ms``.  Only
        for idempotent handlers — checkpoint merge-on-put, checkpoint get,
        both are (docs/protocol.md §4)."""

        def attempt(tries_left: int):
            st = self._meter(src, dst, cls, nbytes)
            prof = self._profile(src, dst)
            rng = self._rng(src, dst) if prof.needs_rng else None
            failed = not self.reachable(src, dst) or (
                prof.loss > 0.0 and rng.random() < prof.loss
            )
            if failed:
                st.dropped += 1
                if tries_left > 1:
                    st.retries += 1
                    self._record(src, dst, cls, nbytes, "retry")
                    self.sim.after(self.retry_ms, lambda: attempt(tries_left - 1))
                else:
                    self._record(src, dst, cls, nbytes, "gave_up")
                return
            delay = self._sample_latency(
                prof, rng, latency_ms, self._lat_floor(src, dst)
            )
            self._record(src, dst, cls, nbytes, "ok", self.sim.now + delay)
            self._observe_delay(cls, delay)
            self.sim.after(delay, execute)

        attempt(max_tries)
