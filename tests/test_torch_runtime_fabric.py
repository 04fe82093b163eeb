"""The port's network fabric, dissemination topologies and checkpoint store.

Mirrors, on ``repro_torch.runtime`` and the CPU (``device="cpu"``):

* ``tests/test_net.py``, every case outside the ``chaos`` marker: delivery
  timing, loss, partitions, degradation, per-link RNG isolation, reliable
  retransmits, RPC retries, byte metering, and same-seed determinism and
  convergence through the whole runtime;
* ``tests/test_topology.py``, every case that needs no ``obs/audit.py``:
  the schedule laws, and sparse topologies byte-identical to the
  all-to-all run under churn;
* ``tests/test_storage.py``: the checkpoint store's lattice merge.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
from _prop import given, settings, st

import repro_torch.runtime as R
from repro_torch.runtime import (
    AllToAll, EpochRing, Hypercube, PartialView, Scenario, SimConfig, topology_from_spec,
)
from repro_torch.runtime.net import STORAGE, LinkProfile, NetworkFabric
from repro_torch.runtime.sim import Sim
from repro_torch.runtime.storage import CheckpointStorage, PartitionCheckpoint, _coverage
from repro_torch.streaming.queries import make_q7

settings.register_profile("ci-torch-fabric", max_examples=40, deadline=None)
settings.load_profile("ci-torch-fabric")

run_holon = functools.partial(R.run_holon, device="cpu")
HolonHarness = functools.partial(R.HolonHarness, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runtime folds tensors of a few KB, op by op: one intra-op thread
    a process, or the workers of a parallel test run spin against each
    other on the CPU's cores (an order of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q7(cfg):
    return make_q7(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)


# ---------------------------------------------------------------------------
# the fabric against a bare simulator (tests/test_net.py)
# ---------------------------------------------------------------------------


def mk(profile=None, **kw) -> tuple[Sim, NetworkFabric]:
    sim = Sim()
    return sim, NetworkFabric(sim, profile=profile or LinkProfile(latency_ms=5.0), **kw)


def test_lossless_delivers_at_exact_latency_in_order():
    sim, net = mk()
    got = []
    for i in range(4):
        net.send(0, 1, "hb", 10.0, lambda i=i: got.append((i, sim.now)))
    sim.run(until=100.0)
    assert got == [(0, 5.0), (1, 5.0), (2, 5.0), (3, 5.0)]
    assert net.msgs_of("hb") == 4 and net.bytes_of("hb") == 40.0 and net.dropped_of("hb") == 0
    assert not net._rngs  # a lossless fixed-latency fabric draws nothing


def test_full_loss_drops_everything():
    sim, net = mk(LinkProfile(latency_ms=5.0, loss=1.0))
    got = []
    for _ in range(6):
        net.send(0, 1, "sync", 100.0, lambda: got.append(sim.now))
    sim.run(until=100.0)
    assert got == [] and net.dropped_of("sync") == 6 and net.bytes_of("sync") == 600.0


def test_partition_blocks_cross_group_only_and_heals():
    sim, net = mk()
    got = []
    net.set_partition((0, 1), (2, 3))
    net.send(0, 1, "hb", 1.0, lambda: got.append("intra"))
    net.send(0, 2, "hb", 1.0, lambda: got.append("cross"))
    net.send(0, STORAGE, "ckpt_put", 1.0, lambda: got.append("storage"))
    net.send(4, 5, "hb", 1.0, lambda: got.append("residual"))
    net.send(4, 0, "hb", 1.0, lambda: got.append("residual-cross"))
    sim.run(until=50.0)
    assert sorted(got) == ["intra", "residual", "storage"] and net.partitioned()
    net.heal()
    net.send(0, 2, "hb", 1.0, lambda: got.append("healed"))
    sim.run(until=100.0)
    assert "healed" in got and not net.partitioned()


def test_reliable_parks_across_partition_and_flushes_on_heal():
    sim, net = mk()
    got = []
    net.set_partition((0,), (1,))
    net.send_reliable(0, 1, "shuffle", 8.0, lambda: got.append(sim.now))
    sim.run(until=200.0)
    assert got == []
    sim.at(200.0, net.heal)
    sim.run(until=300.0)
    assert got == [205.0]


def test_degrade_worsens_touching_links_and_clears():
    sim, net = mk()
    net.degrade([1], loss=1.0)
    dead, ok = [], []
    net.send(0, 1, "hb", 1.0, lambda: dead.append(1))
    net.send(1, 2, "hb", 1.0, lambda: dead.append(2))
    net.send(0, 2, "hb", 1.0, lambda: ok.append(3))
    sim.run(until=50.0)
    assert dead == [] and ok == [3]
    net.degrade([1])
    net.send(0, 1, "hb", 1.0, lambda: dead.append(4))
    sim.run(until=100.0)
    assert dead == [4]


def test_degrade_latency_floor_applies_to_per_call_latency():
    sim, net = mk()
    net.degrade([1], latency_ms=500.0)
    got = []
    net.send(0, 1, "shuffle", 1.0, lambda: got.append(sim.now), latency_ms=105.0)
    net.send_reliable(0, 1, "shuffle", 1.0, lambda: got.append(sim.now),
                      latency_ms=105.0, hops=2)
    sim.run(until=5000.0)
    assert got == [500.0, 1000.0]


def test_degrade_jitter_on_fixed_profile_takes_effect():
    sim, net = mk(seed=7)
    net.degrade([1], jitter_ms=20.0)
    ts = []
    for _ in range(8):
        net.send(0, 1, "hb", 1.0, lambda: ts.append(sim.now))
    sim.run(until=1000.0)
    assert len(ts) == 8 and any(t > 5.0 for t in ts) and all(5.0 <= t <= 25.0 for t in ts)


def test_per_link_rng_streams_are_isolated():
    prof = LinkProfile(latency_ms=5.0, jitter="uniform", jitter_ms=10.0)

    def latencies(extra_traffic: bool) -> list[float]:
        sim, net = mk(prof, seed=3)
        ts = []
        for _ in range(10):
            if extra_traffic:
                net.send(0, 2, "hb", 1.0, lambda: None)
            net.send(0, 1, "hb", 1.0, lambda: ts.append(sim.now))
        sim.run(until=1000.0)
        return ts

    assert latencies(False) == latencies(True)


def test_reliable_retransmit_adds_rto_per_loss_and_meters_retries():
    sim, net = mk(LinkProfile(latency_ms=5.0, loss=0.5), seed=11, rto_ms=100.0)
    got = []
    for i in range(20):
        net.send_reliable(0, 1, "shuffle", 10.0, lambda i=i: got.append((i, sim.now)))
    sim.run(until=10_000.0)
    assert len(got) == 20
    delays = sorted(t - 5.0 for _, t in got)
    assert delays[0] == 0.0 and delays[-1] >= 100.0
    assert net.stats["shuffle"].retries > 0 and net.stats["shuffle"].bytes > 200.0


def test_rpc_retries_until_delivered_and_gives_up():
    sim, net = mk(storage_profile=LinkProfile(latency_ms=50.0, loss=1.0), retry_ms=30.0)
    got = []
    net.rpc(0, STORAGE, "ckpt_put", 100.0, lambda: got.append(sim.now), max_tries=4)
    sim.run(until=10_000.0)
    st_ = net.stats["ckpt_put"]
    assert got == [] and st_.msgs == 4 and st_.retries == 3 and st_.dropped == 4
    sim2, net2 = mk(storage_profile=LinkProfile(latency_ms=50.0, loss=0.5), seed=5,
                    retry_ms=30.0)
    got2 = []
    for _ in range(10):
        net2.rpc(0, STORAGE, "ckpt_put", 100.0, lambda: got2.append(sim2.now))
    sim2.run(until=10_000.0)
    assert len(got2) == 10


def test_link_bytes_ledger():
    sim, net = mk()
    net.send(0, 1, "sync", 100.0, lambda: None)
    net.send(0, 1, "hb", 10.0, lambda: None)
    net.send(1, 0, "sync", 50.0, lambda: None)
    assert net.link_bytes[(0, 1)] == 110.0 and net.link_bytes[(1, 0)] == 50.0
    assert net.total_bytes() == 160.0


# ---------------------------------------------------------------------------
# determinism and convergence through the runtime (tests/test_net.py)
# ---------------------------------------------------------------------------

NET = SimConfig(
    num_nodes=3, num_partitions=6, num_batches=40, events_per_batch=512,
    rate_per_partition=10_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=300.0, sync_interval_ms=50.0,
)


def _records(consumer):
    return {k: (np.asarray(r.value).tobytes(), r.emit_time, r.latency)
            for k, r in consumer.records.items()}


def _values(consumer):
    return {k: np.asarray(r.value).tobytes() for k, r in consumer.records.items()}


def test_same_seed_identical_trace_and_outputs_under_chaos():
    cfg = dataclasses.replace(NET, net_loss=0.05, net_jitter="uniform", net_jitter_ms=3.0,
                              net_trace=True)
    scen = Scenario("chaos").crash(600.0, 0).restart(1500.0, 0).partition(
        900.0, (0, 1), (2,)).heal(1600.0)

    def once():
        h = HolonHarness(cfg, _q7(cfg))
        return h, h.run(scen, horizon_ms=cfg.horizon_ms + 6000.0)

    h1, c1 = once()
    h2, c2 = once()
    assert h1.net.trace and h1.net.trace == h2.net.trace
    assert _records(c1) == _records(c2)
    assert h1.net.class_stats() == h2.net.class_stats()


def test_small_loss_converges_to_lossless_oracle():
    oracle = run_holon(NET, _q7(NET))
    lossy = run_holon(dataclasses.replace(NET, net_loss=0.02), _q7(NET))
    ref, got = _values(oracle), _values(lossy)
    assert set(ref) <= set(got) and all(got[k] == ref[k] for k in ref)
    assert sum(s["dropped"] for s in lossy.net_stats.values()) > 0


def test_lossless_fabric_counters_match_legacy_accounting():
    full = run_holon(dataclasses.replace(NET, delta_sync=False), _q7(NET))
    assert full.sync_bytes == full.sync_bytes_full == full.net_stats["sync"]["bytes"]
    delta = run_holon(NET, _q7(NET))
    assert delta.sync_bytes < full.sync_bytes
    assert {"hb", "sync", "sync_ack", "ckpt_put"} <= set(delta.net_stats)


# ---------------------------------------------------------------------------
# dissemination topologies (tests/test_topology.py)
# ---------------------------------------------------------------------------

SPECS = ("all", "ring:1", "ring:2", "ring:3", "hypercube", "partial:1", "partial:3")
MEMBERSHIPS = (
    [0, 1], [3, 7, 9], [5, 0, 2, 8, 11], list(range(8)),
    [17, 4, 23, 9, 31, 0, 12, 8, 40, 2, 19, 27, 33], list(range(32)),
)


def _peers(members, nid):
    return [m for m in members if m != nid]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"n{len(m)}")
def test_targets_are_valid_peers(spec, members):
    topo = topology_from_spec(spec, seed=3)
    for nid in members:
        peers = _peers(members, nid)
        for rnd in range(3 * len(members)):
            out = topo.peers_of(nid, rnd, peers)
            assert nid not in out and len(out) == len(set(out)) and set(out) <= set(peers)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"n{len(m)}")
def test_union_of_rounds_spans_live_set(spec, members):
    topo = topology_from_spec(spec, seed=3)
    horizon = 4 * len(members) + 8
    for start in (0, 5):
        edges: dict[int, set[int]] = {m: set() for m in members}
        for rnd in range(start, start + horizon):
            for nid in members:
                edges[nid] |= set(topo.peers_of(nid, rnd, _peers(members, nid)))
        for nid in members:
            seen, frontier = {nid}, [nid]
            while frontier:
                nxt = edges[frontier.pop()] - seen
                seen |= nxt
                frontier.extend(nxt)
            assert seen == set(members), (spec, nid, set(members) - seen)


@pytest.mark.parametrize("spec", ("all", "ring:1", "ring:2", "ring:3", "partial:3"))
@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"n{len(m)}")
def test_direct_union_spans_peers(spec, members):
    topo = topology_from_spec(spec, seed=3)
    for nid in members:
        peers, union = set(_peers(members, nid)), set()
        for rnd in range(6 * len(members) + 30):
            union |= set(topo.peers_of(nid, rnd, sorted(peers)))
            if union == peers:
                break
        assert union == peers, (spec, nid, peers - union)


@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"n{len(m)}")
@pytest.mark.parametrize("k", (1, 2, 3))
def test_ring_is_permutation_fair(members, k):
    topo, deg = EpochRing(k), min(k, len(members) - 1)
    for rnd in range(2 * len(members)):
        indeg = {m: 0 for m in members}
        for nid in members:
            out = topo.peers_of(nid, rnd, _peers(members, nid))
            assert len(out) == deg
            for t in out:
                indeg[t] += 1
        assert set(indeg.values()) == {deg}


@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"n{len(m)}")
def test_hypercube_pairing_is_symmetric(members):
    topo = Hypercube()
    for rnd in range(2 * max(1, (len(members) - 1).bit_length())):
        for nid in members:
            out = topo.peers_of(nid, rnd, _peers(members, nid))
            assert len(out) <= 1
            for t in out:
                assert topo.peers_of(t, rnd, _peers(members, t)) == [nid]


def test_partial_view_is_seeded_and_deterministic():
    members = list(range(24))
    a, b, c = PartialView(fanout=4, seed=9), PartialView(fanout=4, seed=9), PartialView(
        fanout=4, seed=10)
    rounds = [tuple(a.peers_of(5, r, _peers(members, 5))) for r in range(40)]
    assert rounds == [tuple(b.peers_of(5, r, _peers(members, 5))) for r in range(40)]
    assert rounds != [tuple(c.peers_of(5, r, _peers(members, 5))) for r in range(40)]
    assert all(len(r) == 4 for r in rounds) and len(set(rounds)) > 1


def test_all_to_all_preserves_input_order():
    peers = [9, 2, 14, 0, 7]
    assert AllToAll().peers_of(3, 0, peers) == peers == AllToAll().peers_of(3, 17, peers)


def test_from_spec_parses_and_rejects():
    assert isinstance(topology_from_spec("all"), AllToAll)
    assert topology_from_spec("ring").k == 2 and topology_from_spec("ring:5").k == 5
    assert isinstance(topology_from_spec("hypercube"), Hypercube)
    assert topology_from_spec("partial").fanout == 3
    assert topology_from_spec("partial:7", seed=2).seed == 2
    for bad in ("mesh", "ring:0", "partial:0", "all:3", "hypercube:2", ""):
        with pytest.raises(ValueError):
            topology_from_spec(bad)


TOPO = SimConfig(
    num_nodes=5, num_partitions=10, num_batches=40, events_per_batch=256,
    rate_per_partition=5_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=400.0, sync_interval_ms=50.0,
)
SPARSE = ("ring:2", "hypercube", "partial:2")
SCENARIOS = {
    "crash_restart": Scenario("cr").crash(1000, 1).restart(2400, 1),
    "partition_heal": Scenario("ph").partition(800, (0, 1), (2, 3, 4)).heal(2200),
    "scale_out_in": Scenario("oi").scale_out(900, 5, 6).scale_in(2800, 5, 6),
}


@pytest.fixture(scope="module")
def oracles():
    return {name: run_holon(TOPO, _q7(TOPO), sc) for name, sc in SCENARIOS.items()}


@pytest.mark.parametrize("spec", SPARSE)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sparse_topology_outputs_match_oracle(spec, scenario, oracles):
    oracle = oracles[scenario]
    c = run_holon(dataclasses.replace(TOPO, topology=spec), _q7(TOPO), SCENARIOS[scenario])
    assert _values(c) == _values(oracle)
    assert c.sync_msgs < oracle.sync_msgs


def test_counterfactual_excludes_bootstrap_bytes():
    h = HolonHarness(dataclasses.replace(TOPO, delta_sync=False), _q7(TOPO))
    c = h.run(Scenario("join").scale_out(900, 5, 6).scale_in(2800, 5, 6))
    served = len(h.bootstrap_served)
    assert served >= 2
    assert c.sync_bytes == c.sync_bytes_full + served * h.full_state_bytes


def test_peer_cache_tracks_membership_churn():
    h = HolonHarness(TOPO, _q7(TOPO))
    h.run(Scenario("churn").scale_out(900, 5).scale_in(2400, 5))
    n0 = h.nodes[0]
    assert 5 in h.unsubscribed and all(p.nid != 5 for p in n0._peers())
    ver = h._sub_version
    h._subscribe(5)
    assert h._sub_version == ver + 1 and any(p.nid == 5 for p in n0._peers())


def test_baseline_ttl_ages_out_to_full_state():
    oracle = run_holon(dataclasses.replace(TOPO, topology="ring:1"), _q7(TOPO))
    aged = run_holon(dataclasses.replace(TOPO, topology="ring:1", baseline_ttl_ms=150.0),
                     _q7(TOPO))
    assert _values(aged) == _values(oracle) and aged.sync_bytes > oracle.sync_bytes


# ---------------------------------------------------------------------------
# the checkpoint store's lattice merge (tests/test_storage.py)
# ---------------------------------------------------------------------------


def mk_ckpt(nxt_idx: int, folded: list[int], epoch: int = 0) -> PartitionCheckpoint:
    baseline = ((np.asarray(folded, dtype=np.float64), np.zeros(len(folded))),)
    return PartitionCheckpoint(nxt_idx=nxt_idx, nxt_odx=nxt_idx, emitted_upto=nxt_idx,
                               shared=("shared", nxt_idx, tuple(folded), epoch), local=None,
                               baseline=baseline, epoch=epoch)


def key(ck: PartitionCheckpoint) -> tuple:
    return (ck.nxt_idx, _coverage(ck), ck.epoch)


CKPT = st.tuples(st.integers(0, 5), st.lists(st.integers(0, 3), min_size=2, max_size=2),
                 st.integers(0, 2))


def put_all(cks):
    s = CheckpointStorage()
    for ck in cks:
        s.put(0, ck)
    return s


def test_none_baseline_has_zero_coverage():
    assert _coverage(PartitionCheckpoint(0, 0, 0, None, None)) == 0.0


@given(c=CKPT)
def test_put_idempotent(c):
    ck = mk_ckpt(*c)
    s = put_all([ck])
    first = s.get(0)
    s.put(0, ck)
    assert s.get(0) is first


@given(a=CKPT, b=CKPT)
def test_put_commutative_on_key(a, b):
    ka, kb = key(mk_ckpt(*a)), key(mk_ckpt(*b))
    sab, sba = put_all([mk_ckpt(*a), mk_ckpt(*b)]), put_all([mk_ckpt(*b), mk_ckpt(*a)])
    assert key(sab.get(0)) == key(sba.get(0)) == max(ka, kb)


@given(cs=st.lists(CKPT, min_size=1, max_size=6))
def test_put_monotone(cs):
    s, best = CheckpointStorage(), None
    for c in cs:
        ck = mk_ckpt(*c)
        s.put(0, ck)
        best = key(ck) if best is None else max(best, key(ck))
        assert key(s.get(0)) == best


@given(cs=st.lists(CKPT, min_size=2, max_size=5))
def test_put_order_invariant_key(cs):
    fwd = put_all([mk_ckpt(*c) for c in cs])
    rev = put_all([mk_ckpt(*c) for c in reversed(cs)])
    assert key(fwd.get(0)) == key(rev.get(0))


def test_tiebreak_order_is_nxt_idx_then_coverage_then_epoch():
    s = put_all([mk_ckpt(1, [9, 9], epoch=9), mk_ckpt(2, [0, 0], epoch=0)])
    assert s.get(0).nxt_idx == 2
    s.put(0, mk_ckpt(2, [3, 3], epoch=0))
    assert _coverage(s.get(0)) == 6.0
    s.put(0, mk_ckpt(2, [0, 0], epoch=5))
    assert _coverage(s.get(0)) == 6.0
    s.put(0, mk_ckpt(2, [3, 3], epoch=7))
    assert s.get(0).epoch == 7


def test_get_and_has_roundtrip():
    s = CheckpointStorage()
    assert s.get(3) is None and not s.has(3)
    ck = mk_ckpt(0, [0, 0])
    s.put(3, ck)
    assert s.has(3) and s.get(3) is ck and s.puts == 1 and s.gets == 2
