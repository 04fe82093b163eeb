"""The port's runtime against the JAX package's, on the CPU.

The same ``SimConfig`` (``tests/test_exactly_once.py``'s ``SMALL``, with
``obs=True``) drives ``repro.runtime.run_holon`` and
``repro_torch.runtime.run_holon(device="cpu")`` for q0, q1_ratio, q4, q5 and
q7 under the baseline, a concurrent failure, a scale-out and scale-in, and
full-state sync.  Each side draws its own log (the port's generator gives
the JAX package's log bit for bit).  Held equal:

* the consumer's records: keys, emit times, latencies and values
  bitwise (a q4 read sums the ``P`` per-partition price rows of a window
  by the left fold of ``jnp.sum(axis=0)`` on XLA's CPU, ``ops.actor_sum``);
* the JSONL trace, byte for byte, the ``digest`` of emitted values too;
* ``sync_bytes``, ``sync_bytes_full``, ``sync_nacks`` and the fabric's
  per-class meters, and the modelled sizes (full state, marker,
  checkpoint), which the port counts through ``wcrdt.state_nbytes`` /
  ``delta_nbytes`` at 4 bytes an int64-carried u32 id.

``run_flink`` gets the same checks.  Then: a received delta's merge
(``wcrdt.join_delta_stack`` on an R=1 stack) is bitwise the JAX
``W.merge(spec, replica, delta)`` on states a JAX run produced, TopK
included; a checkpoint and an in-flight sync payload do not change while
the node folds and merges on (nothing writes a state tensor in place); a
JAX checkpoint carried across by ``convert.checkpoint_from_numpy`` adopts
into the same replica on both sides; and without a card the runtimes
refuse to start unless asked for the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as PR
from repro.streaming import queries as jq
from repro_torch.convert import checkpoint_from_numpy, wstate_from_numpy, wstate_to_numpy
from repro_torch.core import wcrdt as W
from repro_torch.streaming import queries as pq

SMALL = JR.SimConfig(
    num_nodes=3, num_partitions=6, num_batches=60, events_per_batch=512,
    rate_per_partition=10_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=300.0, sync_interval_ms=50.0, obs=True,
)
QUERIES = ("q0", "q1_ratio", "q4", "q5", "q7")
SCENARIOS = ("baseline", "concurrent", "scale_out_in", "full_sync")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runtime folds tensors of a few KB, op by op: one intra-op thread
    a process, or the workers of a parallel test run spin against each
    other on the CPU's cores (an order of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, scenario: str):
    cfg = pkg.SimConfig(**dataclasses.asdict(SMALL))
    return dataclasses.replace(cfg, delta_sync=scenario != "full_sync")


def _scenario(pkg, scenario: str):
    if scenario == "concurrent":
        return pkg.FailureScenario.concurrent(t=800.0)
    if scenario == "scale_out_in":
        return pkg.Scenario("elastic").scale_out(1000.0, 3).scale_in(2500.0, 3)
    return None


def _query(mod, qname: str):
    return getattr(mod, "make_" + qname)(SMALL.num_partitions, window_len=SMALL.window_len,
                                         num_slots=SMALL.num_slots)


def _assert_consumers_equal(jc, pc):
    assert sorted(jc.records) == sorted(pc.records) and len(jc.records) > 0
    for k, jr in jc.records.items():
        r = pc.records[k]
        assert (r.emit_time, r.latency, r.duplicates) == (jr.emit_time, jr.latency, jr.duplicates)
        if jr.value is None:
            assert r.value is None
            continue
        want = np.asarray(jr.value)
        assert r.value.dtype == np.float32 and r.value.shape == want.shape
        np.testing.assert_array_equal(r.value, want, err_msg=str(k))
    for name in ("sync_msgs", "sync_bytes", "sync_bytes_full", "sync_nacks", "duplicates",
                 "events_consumed", "net_stats"):
        assert getattr(pc, name) == getattr(jc, name), name


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("qname", QUERIES)
def test_holon_matches_jax(qname, scenario):
    jh = JR.HolonHarness(_cfg(JR, scenario), _query(jq, qname))
    jc = jh.run(_scenario(JR, scenario))
    ph = PR.HolonHarness(_cfg(PR, scenario), _query(pq, qname), device="cpu")
    pc = ph.run(_scenario(PR, scenario))
    _assert_consumers_equal(jc, pc)
    assert ph.obs.export_jsonl() == jh.obs.export_jsonl()


@pytest.mark.parametrize("qname", QUERIES)
def test_modelled_bytes_match_jax(qname):
    """Full state, sync marker and checkpoint sizes equal the JAX run's: the
    port charges 4 bytes an int64-carried u32 id (``_wire_itemsize``), where
    a TopK id tensor's ``.nbytes`` would be twice that."""
    jh = JR.HolonHarness(SMALL, _query(jq, qname))
    ph = PR.HolonHarness(SMALL, _query(pq, qname), device="cpu")
    for name in ("full_state_bytes", "marker_nbytes", "ckpt_nbytes"):
        assert getattr(ph, name) == getattr(jh, name), name
    if qname == "q7":  # the u32 ids the port carries as int64
        assert ph.init_shared()[0].windows.ids.dtype == torch.int64


@pytest.mark.parametrize("scenario", ["baseline", "concurrent", "partition"])
def test_flink_matches_jax(scenario):
    def scen(pkg):
        if scenario == "partition":
            return pkg.Scenario("ph").partition(1000.0, (0,), (1, 2)).heal(2500.0)
        return _scenario(pkg, scenario)

    horizon = SMALL.horizon_ms + 15_000.0
    jh = JR.FlinkHarness(SMALL, _query(jq, "q7"))
    jc = jh.run(scen(JR), horizon_ms=horizon)
    ph = PR.FlinkHarness(SMALL, _query(pq, "q7"), device="cpu")
    pc = ph.run(scen(PR), horizon_ms=horizon)
    _assert_consumers_equal(jc, pc)
    assert ph.obs.export_jsonl() == jh.obs.export_jsonl()
    np.testing.assert_array_equal(ph.valid_frac, jh.valid_frac)


# ---------------------------------------------------------------------------
# the received delta's merge, aliasing, checkpoints carried across
# ---------------------------------------------------------------------------


def _jax_state_np(st) -> dict:
    d = {k: np.asarray(getattr(st, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    d.update({f"windows.{f.name}": np.asarray(getattr(st.windows, f.name))
              for f in dataclasses.fields(st.windows)})
    return d


def _to_port(specs, states):
    return tuple(wstate_from_numpy(s, _jax_state_np(st)) for s, st in zip(specs, states))


def _assert_port_equals_jax(port_states, jax_states):
    for p, j in zip(port_states, jax_states):
        want = _jax_state_np(j)
        for k, v in wstate_to_numpy(p).items():
            np.testing.assert_array_equal(v[0], want[k], err_msg=k)


@pytest.mark.parametrize("qname", ["q1_ratio", "q4", "q5", "q7"])
def test_received_delta_merge_is_bitwise_jax_merge(qname):
    """Replicas and deltas from a JAX run mid-stream (node 1's replica
    shipped since node 0's marker, since nothing, and since its own older
    marker): ``join_delta_stack`` on the R=1 delta, through the port
    harness's ``delta_merge_fn``, is bitwise ``W.merge``."""
    jh = JR.HolonHarness(SMALL, _query(jq, qname))
    jh.run(horizon_ms=900.0)
    old_marker = jh.marker_of(jh.nodes[1].replica)
    jh.sim.run(until=1700.0)
    n0, n1 = jh.nodes[0], jh.nodes[1]
    ph = PR.HolonHarness(SMALL, _query(pq, qname), device="cpu")
    specs = ph.query.shared_specs
    replica = _to_port(specs, n0.replica)
    for base in (jh.marker_of(n0.replica), jh.zero_base, old_marker):
        jd = jh.delta_fn(n1.replica, base)
        pd = _to_port(specs, jd)
        want = jh.merge_fn(n0.replica, jd)
        _assert_port_equals_jax(ph.delta_merge_fn(replica, pd), want)
        _assert_port_equals_jax(tuple(W.join_delta_stack(s, r, d)
                                      for s, r, d in zip(specs, replica, pd)), want)
        _assert_port_equals_jax(ph.merge_fn(replica, pd), want)


def test_port_delta_matches_jax_delta():
    """The port harness's delta of a replica since a host marker, and its
    modelled size, are the JAX harness's."""
    jh = JR.HolonHarness(SMALL, _query(jq, "q5"))
    jh.run(horizon_ms=1300.0)
    ph = PR.HolonHarness(SMALL, _query(pq, "q5"), device="cpu")
    snap = jh.nodes[2].replica
    for base in (jh.zero_base, jh.marker_of(jh.nodes[0].replica)):
        jd = jh.delta_fn(snap, base)
        pd = ph.delta_fn(_to_port(ph.query.shared_specs, snap), base)
        _assert_port_equals_jax(pd, jd)
        assert ph.delta_bytes(pd) == jh.delta_bytes(jd)
    marker = ph.marker_of(_to_port(ph.query.shared_specs, snap))
    for (pf, pp), (jf, jp) in zip(marker, jh.marker_of(snap)):
        assert pf.dtype == np.int32 and pf.shape == jf.shape
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pp, jp)


def test_checkpoint_and_inflight_payload_are_not_aliased():
    """A checkpoint and a sync payload taken from a node's replica stay as
    they were while the node folds batches and merges deltas on."""
    ph = PR.HolonHarness(SMALL, _query(pq, "q1_ratio"), device="cpu")
    ph.run(horizon_ms=800.0)
    node = ph.nodes[0]
    pid = node.owned[0]
    ck = node._checkpoint_of(pid, node.meta[pid])
    payload = ph.delta_fn(node.replica, ph.zero_base)
    frozen = [wstate_to_numpy(st) for st in (*ck.shared, ck.local, *payload)]
    before = wstate_to_numpy(node.replica[0])
    ph.sim.run(until=2000.0)
    assert node.meta[pid].idx > ck.nxt_idx  # it folded on
    after = wstate_to_numpy(node.replica[0])
    assert any(not np.array_equal(before[k], after[k]) for k in before)
    for st, was in zip((*ck.shared, ck.local, *payload), frozen):
        for k, v in wstate_to_numpy(st).items():
            np.testing.assert_array_equal(v, was[k], err_msg=k)


@pytest.mark.parametrize("qname", ["q1_ratio", "q7"])
def test_jax_checkpoint_carries_across(qname):
    """A JAX run's stored checkpoint, carried across as numpy, adopts into a
    fresh JAX node and a fresh port node with the same replica, local
    state, cursors and marker."""
    jh = JR.HolonHarness(SMALL, _query(jq, qname))
    jh.run(horizon_ms=1500.0)
    jck = jh.storage.get(2)
    np_ck = dataclasses.replace(
        jck, shared=tuple(_jax_state_np(st) for st in jck.shared),
        local=None if jck.local is None else _jax_state_np(jck.local))
    ph = PR.HolonHarness(SMALL, _query(pq, qname), device="cpu")
    pck = checkpoint_from_numpy(np_ck, ph.query.shared_specs, ph.query.local_spec)
    for (pf, pp), (jf, jp) in zip(pck.baseline, jck.baseline):
        assert pf.dtype == np.int32
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pp, jp)
    fresh_j = JR.HolonHarness(SMALL, _query(jq, qname)).nodes[0]
    fresh_p = ph.nodes[0]
    fresh_j._adopt(2, jck)
    fresh_p._adopt(2, pck)
    _assert_port_equals_jax(fresh_p.replica, fresh_j.replica)
    assert dataclasses.astuple(fresh_p.meta[2]) == dataclasses.astuple(fresh_j.meta[2])
    if jck.local is not None:
        _assert_port_equals_jax((fresh_p.locals[2],), (fresh_j.locals[2],))


def test_runtimes_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    q = _query(pq, "q7")
    for make in (PR.HolonHarness, PR.FlinkHarness):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(SMALL, q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PR.run_holon(SMALL, q)


def test_log_passed_in_from_the_jax_package():
    """``log=`` takes a log made elsewhere (here the JAX package's, through
    numpy): the run equals the one on the port's own log."""
    from repro.streaming.generator import NexmarkConfig, generate_log
    from repro_torch.convert import event_batch_from_numpy

    nx = NexmarkConfig(num_partitions=SMALL.num_partitions, num_batches=SMALL.num_batches,
                       events_per_batch=SMALL.events_per_batch,
                       rate_per_partition=SMALL.rate_per_partition, seed=SMALL.seed)
    jlog = jax.tree.map(np.asarray, generate_log(nx))
    plog = event_batch_from_numpy({f.name: getattr(jlog, f.name)
                                   for f in dataclasses.fields(jlog)})
    q = _query(pq, "q7")
    own = PR.HolonHarness(SMALL, q, device="cpu")
    given = PR.HolonHarness(SMALL, q, log=plog, device="cpu")
    own.run()
    given.run()
    assert given.obs.export_jsonl() == own.obs.export_jsonl()
