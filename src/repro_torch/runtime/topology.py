"""Pluggable dissemination topologies for the gossip plane.

Every sync round and heartbeat used to broadcast to *every* subscribed peer
— O(N²) messages per round, fine at N=8, fatal at the N=256 the ROADMAP
targets.  Because replica merge is an idempotent, commutative lattice join
and a delta from an unmoved baseline subsumes any lost predecessor
(docs/protocol.md §2, §4), deltas may ride *any* connected dissemination
graph and pay only in propagation hops, never in correctness.  This module
makes that graph a first-class, configurable axis (docs/protocol.md §5):
:class:`Topology` answers one question — *whom do I contact this round?* —
and the harness consults it from ``_publish_sync`` and ``_broadcast_hb``.

Implementations:

* :class:`AllToAll` — today's behavior and the correctness **oracle**: every
  peer, every round, in registry order (sparse runs must stay byte-identical
  to it on window outputs — tests/test_topology.py).
* :class:`EpochRing` — rotating k-regular circulant: round ``r`` uses
  strides ``r*k+1 .. r*k+k`` (mod N-1), so the union over
  ``ceil((N-1)/k)`` consecutive rounds spans the whole membership and every
  node has exactly ``k`` in- and out-neighbors per round (permutation-fair).
* :class:`Hypercube` — dimension-scheduled exchange: round ``r`` pairs index
  ``i`` with ``i XOR 2^(r mod dim)``; partners are symmetric, and the union
  over ``dim = ceil(log2 N)`` rounds spans a connected graph even for
  non-power-of-two N (clearing the top bit always lands in range).
* :class:`PartialView` — seeded random peer sampling à la gossip: a
  deterministic splitmix64 stream keyed ``(seed, nid, round)`` draws
  ``fanout`` distinct peers — no global RNG, so runs stay replayable.

All schedules are pure functions of ``(nid, round, peers)``: no state, no
RNG objects, so two nodes (or two runs) with the same arguments agree
exactly.  Rounds are derived from sim time (``now // interval``), which
keeps restarted and late-joining nodes on the shared schedule.
"""
from __future__ import annotations

from typing import Sequence

_M64 = (1 << 64) - 1


def _mix64(*xs: int) -> int:
    """splitmix64-style finalizer over a tuple of ints — the same salt-free
    determinism contract as the rendezvous hash in runtime/harness.py."""
    x = 0x9E3779B97F4A7C15
    for v in xs:
        x = (x + (v & _M64) + 0x9E3779B97F4A7C15) & _M64
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & _M64
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & _M64
        x ^= x >> 31
    return x


class Topology:
    """Dissemination schedule: ``peers_of(nid, round, peers)`` returns the
    subset of ``peers`` node ``nid`` contacts in gossip round ``round``.

    ``peers`` is the caller's current peer-id list (self excluded); the
    membership it reflects may change between rounds — implementations must
    only ever return ids drawn from it.  ``sparse`` is False only for
    :class:`AllToAll`: sparse topologies additionally piggyback transitive
    liveness gossip on heartbeats (docs/protocol.md §5), which the
    all-to-all oracle provably does not need.
    """

    name: str = "?"
    sparse: bool = True

    def peers_of(self, nid: int, rnd: int, peers: Sequence[int]) -> list[int]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({self.name!r})"


class AllToAll(Topology):
    """Every peer, every round — the pre-topology behavior and the oracle
    sparse runs are verified byte-identical against.  Returns ``peers``
    unmodified (same order), so the scheduled event sequence of a default
    run is bit-for-bit the pre-topology one."""

    name = "all"
    sparse = False

    def peers_of(self, nid: int, rnd: int, peers: Sequence[int]) -> list[int]:
        return list(peers)


class EpochRing(Topology):
    """Rotating k-regular ring (circulant graph) over the sorted membership.

    Round ``r`` uses the stride set ``{(r*k + j) mod (N-1) + 1 : j < k}``:
    every node applies the same strides, so per round each node has exactly
    ``k`` out- and ``k`` in-neighbors (permutation-fair), and consecutive
    rounds rotate through all N-1 strides — the union of any
    ``ceil((N-1)/k)`` consecutive rounds is the complete graph."""

    sparse = True

    def __init__(self, k: int = 2):
        if k < 1:
            raise ValueError(f"EpochRing needs k >= 1, got {k}")
        self.k = int(k)
        self.name = f"ring:{self.k}"

    def peers_of(self, nid: int, rnd: int, peers: Sequence[int]) -> list[int]:
        members = sorted(peers)
        if nid not in members:
            members = sorted([nid, *members])
        n = len(members)
        if n - 1 <= self.k:
            return [m for m in members if m != nid]
        i = members.index(nid)
        out: list[int] = []
        for j in range(self.k):
            stride = (rnd * self.k + j) % (n - 1) + 1
            tgt = members[(i + stride) % n]
            if tgt != nid and tgt not in out:
                out.append(tgt)
        return out


class Hypercube(Topology):
    """Dimension-scheduled hypercube exchange over the sorted membership.

    Round ``r`` flips bit ``r mod dim`` of a node's membership index; the
    pairing is symmetric (a talks to b iff b talks to a), and over ``dim``
    consecutive rounds the union of edges is the hypercube skeleton —
    connected even for non-power-of-two N, because clearing a set bit
    always yields a valid (smaller) index.  Out-of-range partners simply
    idle that round; their delta waits one round, never disappears."""

    name = "hypercube"
    sparse = True

    def peers_of(self, nid: int, rnd: int, peers: Sequence[int]) -> list[int]:
        members = sorted(peers)
        if nid not in members:
            members = sorted([nid, *members])
        n = len(members)
        if n <= 1:
            return []
        dim = max(1, (n - 1).bit_length())
        partner = members.index(nid) ^ (1 << (rnd % dim))
        return [members[partner]] if partner < n else []


class PartialView(Topology):
    """Seeded random peer sampling (gossip-style partial view).

    Each round draws ``fanout`` distinct peers by partial Fisher-Yates over
    the sorted peer list, with every swap index taken from a splitmix64
    stream keyed ``(seed, nid, round)`` — per-(node, round) streams are
    independent, deterministic, and shared by no one, so sampling never
    perturbs any other randomness in the run."""

    sparse = True

    def __init__(self, fanout: int = 3, seed: int = 0):
        if fanout < 1:
            raise ValueError(f"PartialView needs fanout >= 1, got {fanout}")
        self.fanout = int(fanout)
        self.seed = int(seed)
        self.name = f"partial:{self.fanout}"

    def peers_of(self, nid: int, rnd: int, peers: Sequence[int]) -> list[int]:
        pool = sorted(p for p in peers if p != nid)
        k = min(self.fanout, len(pool))
        for j in range(k):
            swap = j + _mix64(self.seed, nid, rnd, j) % (len(pool) - j)
            pool[j], pool[swap] = pool[swap], pool[j]
        return pool[:k]


def topology_from_spec(spec: str, seed: int = 0) -> Topology:
    """Parse ``SimConfig.topology`` — ``all``, ``ring[:k]``, ``hypercube``,
    or ``partial[:fanout]`` (docs/protocol.md §5)."""
    name, _, arg = str(spec).strip().partition(":")
    name = name.lower()
    try:
        if name == "all":
            if arg:
                raise ValueError("'all' takes no parameter")
            return AllToAll()
        if name == "ring":
            return EpochRing(int(arg) if arg else 2)
        if name in ("hypercube", "cube"):
            if arg:
                raise ValueError("'hypercube' takes no parameter")
            return Hypercube()
        if name == "partial":
            return PartialView(int(arg) if arg else 3, seed=seed)
    except ValueError as e:
        raise ValueError(f"bad topology spec {spec!r}: {e}") from None
    raise ValueError(
        f"unknown topology {spec!r} (want all | ring[:k] | hypercube | "
        f"partial[:fanout])"
    )
