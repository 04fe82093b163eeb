"""Exactly-once, delta sync and elastic membership on the port's runtime.

Mirrors, at the same small sizes and on the CPU (``device="cpu"``), the
runtime cases of ``tests/test_exactly_once.py``, ``tests/test_delta_sync.py``,
``tests/test_reconfig.py`` and ``tests/test_elastic.py`` on
``repro_torch.runtime``: for any failure or membership schedule the
deduplicated outputs equal the failure-free run's, delta sync equals
full-state sync at a fraction of the bytes, a drained node hands off
without replay, joiners bootstrap from settled peers, and the membership
epoch reaches the checkpoints.  The JAX runtime itself is held against the
port in ``tests/test_torch_runtime_parity.py``.
"""
import dataclasses
import functools
import random

import numpy as np
import pytest
import torch
from _prop import given, settings, st

import repro_torch.runtime as R
from repro_torch.runtime import FailureScenario, Scenario, SimConfig, assignment
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from repro_torch.streaming.queries import make_q1_ratio, make_q4, make_q7

settings.register_profile("ci-torch-recovery", max_examples=5, deadline=None)
settings.load_profile("ci-torch-recovery")

run_holon = functools.partial(R.run_holon, device="cpu")
run_flink = functools.partial(R.run_flink, device="cpu")
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


# tests/test_exactly_once.py
SMALL = SimConfig(
    num_nodes=3, num_partitions=6, num_batches=60, events_per_batch=512,
    rate_per_partition=10_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=300.0, sync_interval_ms=50.0,
)
# tests/test_delta_sync.py
CHAOS = SimConfig(
    num_nodes=3, num_partitions=6, num_batches=50, events_per_batch=256,
    rate_per_partition=10_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=250.0, sync_interval_ms=50.0,
)
# tests/test_reconfig.py
CFG = SimConfig(
    num_nodes=3, num_partitions=8, num_batches=40, events_per_batch=256,
    window_len=500, num_slots=32, sync_interval_ms=50.0, ckpt_interval_ms=300.0,
)
# tests/test_elastic.py
ELASTIC = SimConfig(
    num_nodes=4, num_partitions=8, num_batches=80, events_per_batch=512,
    window_len=500, num_slots=32,
)


def _q7(cfg):
    return make_q7(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)


def _vals(consumer):
    return {k: np.asarray(r.value) for k, r in consumer.records.items()}


def _check_byte_identical(oracle, got, what=""):
    missing = set(oracle) - set(got)
    assert not missing, f"{what}: lost outputs {sorted(missing)[:5]}"
    for k in oracle:
        np.testing.assert_array_equal(got[k], oracle[k], err_msg=f"{what}:{k}")


# ---------------------------------------------------------------------------
# exactly-once under failures (tests/test_exactly_once.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q7_baseline():
    q = _q7(SMALL)
    return q, run_holon(SMALL, q)


def test_failure_free_matches_oracle(q7_baseline):
    """Every window of partition 0 the run emitted equals the q7 oracle over
    the port's log, bitwise (prices are exact, top-k is a set)."""
    q, consumer = q7_baseline
    nx = NexmarkConfig(num_partitions=SMALL.num_partitions, num_batches=SMALL.num_batches,
                       events_per_batch=SMALL.events_per_batch,
                       rate_per_partition=SMALL.rate_per_partition, seed=SMALL.seed)
    log = generate_log(nx, "cpu")
    checked = 0
    for (p, w), rec in consumer.records.items():
        if p == 0 and w < 4:
            ov, oi = q.oracle(log, w)
            np.testing.assert_array_equal(rec.value[:8], ov.numpy())
            np.testing.assert_array_equal(rec.value[8:], oi.numpy().astype(np.float32))
            checked += 1
    assert checked > 0


@given(fail_t=st.floats(500.0, 1500.0), restart_dt=st.floats(300.0, 2000.0),
       node=st.integers(0, 2))
def test_exactly_once_single_failure(q7_baseline, fail_t, restart_dt, node):
    q, base = q7_baseline
    scen = FailureScenario(name="hyp", fail_times_ms=(fail_t,), fail_nodes=(node,),
                           restart_times_ms=(fail_t + restart_dt,))
    _check_byte_identical(_vals(base), _vals(run_holon(SMALL, q, scen)), "single")


def test_exactly_once_crash_without_restart(q7_baseline):
    q, base = q7_baseline
    scen = FailureScenario(name="crash1", fail_times_ms=(800.0,), fail_nodes=(0,),
                           restart_times_ms=(-1.0,))
    c = run_holon(SMALL, q, scen, horizon_ms=SMALL.horizon_ms + 10_000)
    _check_byte_identical(_vals(base), _vals(c), "crash")


def test_duplicates_are_deduped(q7_baseline):
    """Concurrent processing of the same partition yields duplicate
    emissions that the consumer drops; outputs stay exactly-once."""
    q, base = q7_baseline
    scen = FailureScenario(name="both", fail_times_ms=(700.0, 900.0), fail_nodes=(0, 1),
                           restart_times_ms=(1500.0, 1800.0))
    _check_byte_identical(_vals(base), _vals(run_holon(SMALL, q, scen)), "both")


@pytest.mark.parametrize("make", [make_q4, make_q1_ratio], ids=["q4", "q1_ratio"])
def test_q4_and_ratio_exactly_once(make):
    q = make(SMALL.num_partitions, window_len=SMALL.window_len, num_slots=SMALL.num_slots)
    base = run_holon(SMALL, q)
    c = run_holon(SMALL, q, FailureScenario.concurrent(t=800.0))
    _check_byte_identical(_vals(base), _vals(c), q.name)


def test_holon_progress_under_crash_flink_stalls():
    """Fig. 6 bottom-right: with both of two failed nodes never restarting,
    Holon reconfigures and keeps emitting; Flink (no spare slots) stops."""
    q = _q7(SMALL)
    scen = FailureScenario.crash(t=800.0)
    ch = run_holon(SMALL, q, scen, horizon_ms=SMALL.horizon_ms + 15_000)
    cf = run_flink(SMALL, q, scen, horizon_ms=SMALL.horizon_ms + 15_000)
    half = int(SMALL.horizon_ms / SMALL.window_len) // 2
    assert [w for (_, w) in ch.records if w > half], "holon should keep completing windows"
    assert not [w for (_, w) in cf.records if w > half], "flink without spare slots must stall"


# ---------------------------------------------------------------------------
# delta sync end to end (tests/test_delta_sync.py, runtime cases)
# ---------------------------------------------------------------------------


def test_runtime_delta_sync_matches_full_state_sync():
    """The delta protocol is pure optimization: identical outputs, a
    fraction of the sync bytes."""
    q = _q7(CHAOS)
    delta = run_holon(CHAOS, q)
    full = run_holon(dataclasses.replace(CHAOS, delta_sync=False), q)
    dv, fv = _vals(delta), _vals(full)
    assert set(dv) == set(fv) and len(dv) > 0
    _check_byte_identical(fv, dv, "delta")
    assert delta.sync_bytes < 0.25 * delta.sync_bytes_full
    assert full.sync_bytes == full.sync_bytes_full


@pytest.mark.parametrize("who", ["sender", "receiver", "both"])
def test_chaos_crash_mid_sync_exactly_once(who):
    """Crash a node while its deltas are in flight, restart it: outputs
    byte-identical to the failure-free run."""
    q = _q7(CHAOS)
    oracle = _vals(run_holon(CHAOS, q))
    mid = 12 * CHAOS.sync_interval_ms + 2.0
    scen = {
        "sender": FailureScenario("sender", (mid,), (0,), (mid + 700.0,)),
        "receiver": FailureScenario("receiver", (mid + 1.0,), (1,), (mid + 900.0,)),
        "both": FailureScenario("both", (mid, mid + 1.0), (0, 1), (mid + 700.0, mid + 900.0)),
    }[who]
    _check_byte_identical(oracle, _vals(run_holon(CHAOS, q, scen)), who)


def test_chaos_recovery_resyncs_after_stale_checkpoint():
    """A restarted node recovers an old checkpoint; peers' deltas assume a
    newer baseline, so it nacks into a full resync, and outputs still match
    (q1_ratio: local and shared state)."""
    q = make_q1_ratio(CHAOS.num_partitions, window_len=CHAOS.window_len,
                      num_slots=CHAOS.num_slots)
    cfg = dataclasses.replace(CHAOS, ckpt_interval_ms=600.0)
    oracle = _vals(run_holon(cfg, q))
    mid = 20 * cfg.sync_interval_ms + 2.0
    c = run_holon(cfg, q, FailureScenario("stale", (mid,), (2,), (mid + 1200.0,)))
    _check_byte_identical(oracle, _vals(c), "stale")
    assert c.sync_nacks > 0


def test_checkpoint_records_sync_baseline():
    """Checkpoints carry the host coverage marker of their (one-replica)
    snapshot."""
    h = HolonHarness(CHAOS, _q7(CHAOS))
    h.run()
    ck = h.storage.get(0)
    assert ck.baseline is not None
    for (bf, bp), st_ in zip(ck.baseline, ck.shared):
        assert bf.dtype == np.int32 and bf.shape == (CHAOS.num_partitions,)
        np.testing.assert_array_equal(bf, st_.folded[0].numpy())
        np.testing.assert_array_equal(bp, st_.progress[0].numpy())


# ---------------------------------------------------------------------------
# elastic membership (tests/test_reconfig.py, tests/test_elastic.py)
# ---------------------------------------------------------------------------


def test_rendezvous_total_and_deterministic():
    members = [0, 3, 7, 11]
    for pid in range(64):
        owner = assignment(pid, members)
        assert owner in members and assignment(pid, list(reversed(members))) == owner
    assert assignment(0, []) == -1


@given(members=st.lists(st.integers(0, 40), min_size=1, max_size=10, unique=True),
       joiner=st.integers(0, 40))
def test_rendezvous_join_moves_only_to_joiner(members, joiner):
    grown = sorted(set(members) | {joiner})
    for pid in range(32):
        assert assignment(pid, grown) in (assignment(pid, members), joiner)


@given(members=st.lists(st.integers(0, 40), min_size=2, max_size=10, unique=True),
       victim_idx=st.integers(0, 9))
def test_rendezvous_leave_moves_only_victims_partitions(members, victim_idx):
    victim = sorted(members)[victim_idx % len(members)]
    shrunk = [n for n in members if n != victim]
    for pid in range(32):
        before = assignment(pid, members)
        if before != victim:
            assert assignment(pid, shrunk) == before


@given(seed=st.integers(0, 2**20))
def test_rendezvous_stable_under_churn(seed):
    rng = random.Random(seed)
    members = set(range(4))
    owners = {p: assignment(p, sorted(members)) for p in range(32)}
    for _ in range(rng.randint(1, 8)):
        gone = joined = None
        if rng.random() < 0.5 and len(members) > 1:
            gone = rng.choice(sorted(members))
            members.discard(gone)
        else:
            joined = rng.randint(0, 12)
            if joined in members:
                joined = None
            else:
                members.add(joined)
        for p in range(32):
            new = assignment(p, sorted(members))
            if new != owners[p]:
                assert owners[p] == gone or new == joined
            owners[p] = new


@pytest.fixture(scope="module")
def cfg_oracle():
    return _vals(run_holon(CFG, _q7(CFG)))


@pytest.mark.parametrize("name", ["scale_out", "drain_node0", "drain_node2", "double_resize"])
def test_elastic_runs_exactly_once(cfg_oracle, name):
    """Scale-out, a drain landing between a sync publish and its deliveries
    (victims 0 and 2), and a 3→5→3 round trip with a crash: byte-identical
    to the static-membership run."""
    mid_flight = 16 * CFG.sync_interval_ms + 2.0
    scen = {
        "scale_out": Scenario("out").scale_out(1200.0, 3, 4),
        "drain_node0": Scenario("drain").scale_in(mid_flight, 0),
        "drain_node2": Scenario("drain").scale_in(mid_flight, 2),
        "double_resize": Scenario("mix").scale_out(600.0, 3, 4).crash(1000.0, 0)
        .restart(1500.0, 0).scale_in(1700.0, 3, 4),
    }[name]
    got = _vals(run_holon(CFG, _q7(CFG), scen))
    _check_byte_identical(cfg_oracle, got, name)
    if name.startswith("drain"):
        assert set(got) == set(cfg_oracle)


def test_scale_in_then_out_rejoin_q1_ratio():
    q = make_q1_ratio(CFG.num_partitions, window_len=CFG.window_len, num_slots=CFG.num_slots)
    oracle = _vals(run_holon(CFG, q))
    got = _vals(run_holon(CFG, q, Scenario("inout").scale_in(700.0, 1).scale_out(1600.0, 1)))
    _check_byte_identical(oracle, got, "rejoin")


def test_drain_hands_off_without_replay():
    h = HolonHarness(CFG, _q7(CFG))
    c = h.run(Scenario("drain").scale_in(1000.0, 1))
    assert all(r.duplicates == 0 for r in c.records.values()), "handoff replayed"
    n1 = h.nodes[1]
    assert not n1.alive and n1.departing and not n1.owned
    for nid in (0, 2):
        assert 1 not in h.nodes[nid]._live_view()


def test_join_bootstraps_full_state_from_peer():
    h = HolonHarness(CFG, _q7(CFG))
    h.run(Scenario("join").scale_out(1000.0, 7))
    joiner = h.nodes[7]
    assert joiner.alive and not joiner._bootstrap_pending
    live = sorted(n.nid for n in h.nodes.values())
    assert joiner.owned == [p for p in range(CFG.num_partitions) if assignment(p, live) == 7]
    for a, b in zip(joiner.replica, h.nodes[0].replica):
        np.testing.assert_array_equal(a.folded.numpy(), b.folded.numpy())


def test_multi_join_bootstraps_from_settled_peers_only():
    h = HolonHarness(CFG, _q7(CFG))
    h.run(Scenario("multi").scale_out(1222.0, 3, 4, 5))
    served = dict(h.bootstrap_served)
    assert set(served) == {3, 4, 5} and all(s in (0, 1, 2) for s in served.values())


def test_decommission_crashed_node(cfg_oracle):
    h = HolonHarness(CFG, _q7(CFG))
    c = h.run(Scenario("decomm").crash(1000.0, 1).scale_in(2000.0, 1))
    assert 1 in h.unsubscribed and h.membership_epoch == 1
    for nid in (0, 2):
        assert h.nodes[nid].epoch == 1 and h.nodes[1] not in h.nodes[nid]._peers()
    _check_byte_identical(cfg_oracle, _vals(c), "decommission")


def test_membership_epoch_reaches_checkpoints():
    h = HolonHarness(CFG, _q7(CFG))
    h.run(Scenario("epoch").scale_out(800.0, 3).scale_in(1500.0, 3))
    assert h.membership_epoch == 2
    epochs = [h.storage.get(p).epoch for p in range(CFG.num_partitions) if h.storage.has(p)]
    assert epochs and max(epochs) == 2
    assert all(h.nodes[nid].epoch == 2 for nid in (0, 1, 2))


def test_skewed_load_elastic_exactly_once():
    cfg = dataclasses.replace(CFG, skew=0.8)
    oracle = _vals(run_holon(cfg, _q7(cfg)))
    assert len(oracle) > 0
    scen = Scenario("skewed").scale_out(800.0, 3).scale_in(1500.0, 0)
    _check_byte_identical(oracle, _vals(run_holon(cfg, _q7(cfg), scen)), "skewed")


def test_scale_out_preserves_outputs():
    """A 4th node joins at 2 s (fail at 0.5 ms, restart at 2 s): outputs
    identical to a static 3-node run."""
    q = _q7(ELASTIC)
    ref = run_holon(ELASTIC, q, FailureScenario("static3", (0.5,), (3,), (-1.0,)))
    got = run_holon(ELASTIC, q, FailureScenario("join", (0.5,), (3,), (2000.0,)))
    _check_byte_identical(_vals(ref), _vals(got), "join")


def test_scale_in_then_out_continuous_progress():
    """Remove a node, later add it back: windows keep completing throughout."""
    c = run_holon(ELASTIC, _q7(ELASTIC), FailureScenario("inout", (1500.0,), (1,), (3500.0,)))
    t, _ = c.latency_series()
    for lo in range(0, int(ELASTIC.horizon_ms) - 1000, 1000):
        assert ((t >= lo) & (t < lo + 1000)).sum() > 0, f"no windows in [{lo},{lo + 1000}) ms"
