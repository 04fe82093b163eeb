"""The port's hash-sharded keyed dataplane against the JAX package.

The JAX ``build_keyed_pipeline`` does not run on this jax (its
``compat.pvary`` of the key table raises), so the reference
(``tests/_keyed_reference.py``) steps its ``node_fn`` on the host with the
JAX parts that do run: ``KeyShards``,
``W.insert`` with a per-lane partition and batch index,
``W.increment_watermark``, the progress max of a sync round, and
``W.shard_topk_read`` under ``jax.vmap(axis_name="data")``.  The JAX
generator's zipf log reaches the port as numpy (``repro_torch.convert``).
States, outputs and byte counters match bitwise, and every complete window
equals the JAX ``q5_hot_oracle``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wcrdt as JW
from repro.core import window as jwin
from repro.streaming import generator as jgen
from repro.streaming import queries as jq
from repro_torch.convert import (
    event_batch_from_numpy, key_table_from_numpy, wstate_from_numpy, wstate_to_numpy,
)
from repro_torch.core import wcrdt as W
from repro_torch.core import window
from repro_torch.launch import stream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.streaming import generator
from repro_torch.streaming.queries import q5_hot_oracle
from _keyed_reference import (
    C, FIELDS, NB, SLOTS, WL, jax_log, jax_reference, jax_state_np, read_range,
)


def _assert_rows_equal(port: dict, jax_rows: list[dict]):
    for s, want in enumerate(jax_rows):
        for k, v in want.items():
            np.testing.assert_array_equal(port[k][s], v, err_msg=f"{k} row {s}")


@pytest.mark.parametrize("C_,S", [(10, 4), (1000, 8), (1_000_000, 16), (97, 5), (1, 1)])
def test_keyshards_match_jax(C_, S):
    jsh, psh = JW.KeyShards(C_, S), W.KeyShards(C_, S)
    assert (psh.mult, psh.width) == (jsh.mult, jsh.width)
    assert [psh.num_local(s) for s in range(S)] == [jsh.num_local(s) for s in range(S)]
    keys = np.arange(C_, dtype=np.uint32)
    tk = torch.from_numpy(keys.astype(np.int64))
    for name in ("perm", "shard_of", "local_of"):
        np.testing.assert_array_equal(getattr(psh, name)(tk).numpy(),
                                      np.asarray(getattr(jsh, name)(jnp.asarray(keys))), err_msg=name)
    np.testing.assert_array_equal(psh.key_table().numpy(), jsh.key_table().astype(np.int64))
    np.testing.assert_array_equal(key_table_from_numpy(jsh.key_table()).numpy(),
                                  psh.key_table().numpy())


@pytest.mark.parametrize("C_", [4096, 100])  # width 2048: the segment reduce; 50: the dense fold
def test_insert_with_per_lane_partition_matches_jax(C_):
    """Owners fold lanes from several source partitions, each lane with its
    own partition and batch index: late lanes, re-folds below the frontier,
    masked lanes that still raise ``folded``, float amounts summed in lane
    order, and ring reuse under a hopping assigner."""
    rng = np.random.default_rng(C_)
    R, P, Bn = 2, 3, 96
    jsh, psh = JW.KeyShards(C_, R), W.KeyShards(C_, R)
    jspec = JW.wgcounter_sharded(20, 8, P, jsh, assigner=jwin.Hopping(20, 10))
    pspec = W.wgcounter_sharded(20, 8, P, psh, assigner=window.Hopping(20, 10))
    start = dict(jax_state_np(jspec.zero()), progress=np.array([-45, 5, 30], np.int32),
                 folded=np.array([1, 0, 2], np.int32))
    jst = [JW.WState(**{k: jnp.asarray(v) for k, v in start.items() if "." not in k},
                     windows=jspec.zero_windows()) for _ in range(R)]
    pst = wstate_from_numpy(pspec, {k: np.stack([v] * R) for k, v in start.items()})
    for b in range(4):
        ts = np.sort(rng.integers(-50 + 30 * b, 20 + 40 * b, (R, Bn))).astype(np.int32)
        part = rng.integers(0, P, (R, Bn)).astype(np.int32)
        bidx = rng.integers(0, 4, (R, Bn)).astype(np.int32)
        mask = rng.random((R, Bn)) > 0.2
        amounts = (rng.random((R, Bn)) * 100).astype(np.float32)
        keys = rng.integers(0, psh.width, (R, Bn)).astype(np.int32)
        for s in range(R):
            a = lambda x: jnp.asarray(x[s])
            jst[s] = JW.insert(jspec, jst[s], a(part), a(ts), a(mask), batch_idx=a(bidx),
                               amounts=a(amounts), keys=a(keys))
        T = torch.from_numpy
        pst = W.insert(pspec, pst, T(part), T(ts), T(mask), batch_idx=T(bidx),
                       amounts=T(amounts), keys=T(keys))
        _assert_rows_equal(wstate_to_numpy(pst), [jax_state_np(j) for j in jst])
    assert int(pst.errors[:, W.ERR_LATE].sum()) > 0


@pytest.mark.parametrize("k", [1, 3])
def test_shard_topk_read_matches_jax(k):
    """Tied counts within and across shards, padded locals, an evicted
    window: the port's read against the JAX read under vmap."""
    rng = np.random.default_rng(k)
    S, C_, Wn = 4, 1001, 8
    jsh = JW.KeyShards(C_, S)
    jspec = JW.wgcounter_sharded(10, Wn, S, jsh)
    pspec = W.wgcounter_sharded(10, Wn, S, W.KeyShards(C_, S))
    st = {k_: np.stack([v] * S) for k_, v in jax_state_np(jspec.zero()).items()}
    st["slot_wid"][:] = np.arange(Wn)
    st["slot_wid"][2, 3] = 11  # window 3 evicted on shard 2
    st["progress"][:] = 200
    st["windows.slots"] = rng.integers(0, 6, st["windows.slots"].shape).astype(np.float32)
    table = jsh.key_table()
    jstate = jax.tree.map(jnp.asarray, JW.WState(
        slot_wid=st["slot_wid"], windows=type(jspec.zero_windows())(slots=st["windows.slots"]),
        progress=st["progress"], folded=st["folded"], errors=st["errors"]))
    pstate = wstate_from_numpy(pspec, st)
    mesh = make_data_mesh(S, "cpu")
    for wid in range(Wn):
        jread = jax.vmap(lambda s_, row: JW.shard_topk_read(jspec, s_, wid, row, C_, "data", k=k),
                         axis_name="data")
        (jc, jk), jok = jread(jstate, jnp.asarray(table))
        (pc, pk), pok = W.shard_topk_read(pspec, pstate, wid, key_table_from_numpy(table), C_,
                                          mesh, k=k)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
        assert bool(pok[0]) == (wid != 3)


@pytest.mark.parametrize("S", [2, 4])
def test_keyed_pipeline_matches_jax_reference_and_oracle(S):
    cfg, jlog, arrays, plog = jax_log(S)
    assigner, first, n = read_range(cfg, NB)
    sched = stream.default_fold_schedule(S, NB)
    wm = torch.ones(NB // 4, dtype=torch.bool)
    pipe = stream.build_keyed_pipeline(make_data_mesh(S, "cpu"), W.KeyShards(C, S),
                                       window_len=WL, num_slots=SLOTS, n_windows=n,
                                       first_window=first, provenance=True)
    table = key_table_from_numpy(JW.KeyShards(C, S).key_table())
    state, shuffle, sync, prov = pipe.fold(plog, sched, wm)
    oks, vals = pipe.read(state, table)
    want = jax_reference(arrays, S, sched.numpy(), wm.numpy(), 4, first, n)
    _assert_rows_equal(wstate_to_numpy(state), [jax_state_np(st) for st in want[0]])
    for got, w, name in zip((oks, vals, shuffle, sync, prov), want[1:],
                            ("oks", "vals", "shuffle", "sync", "prov")):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert oks.sum() == S * n and shuffle.min() > 0 and (prov > 0).all()
    for i, w in enumerate(range(first, first + n)):
        oracle = np.asarray(jq.q5_hot_oracle(jlog, w, assigner, C))
        np.testing.assert_array_equal(
            q5_hot_oracle(plog, w, window.as_assigner(WL, WL // 2), C).numpy(), oracle)
        for d in range(S):
            np.testing.assert_array_equal(vals[d, i].numpy(), oracle)
    # the call runs fold and read, and without provenance returns 4 outputs
    plain = stream.build_keyed_pipeline(make_data_mesh(S, "cpu"), W.KeyShards(C, S),
                                        window_len=WL, num_slots=SLOTS, n_windows=n,
                                        first_window=first)
    out = plain(plog, table, sched, wm)
    assert len(out) == 4
    for a, b in zip(out, (oks, vals, shuffle, sync)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_keyed_pipeline_crash_replay_and_partition():
    """Mirrors the JAX 8-device chaos test at S=4: a crash-replay schedule
    and a partitioned-then-healed watermark plane end byte-identical to the
    clean run (and to the oracle); a plane never healed stalls every
    window instead of emitting a wrong value."""
    S, nb = 4, 12
    cfg, jlog, _, plog = jax_log(S, nb=nb)
    assigner, first, n = read_range(cfg, nb)
    shards = W.KeyShards(C, S)
    table = shards.key_table()

    def run(sched, wm, sync_every=4):
        pipe = stream.build_keyed_pipeline(make_data_mesh(S, "cpu"), shards, window_len=WL,
                                           num_slots=SLOTS, sync_every=sync_every,
                                           n_windows=n, first_window=first)
        return [t.numpy() for t in pipe(plog, table, sched, torch.as_tensor(wm))]

    base = stream.default_fold_schedule(S, nb)
    oks0, vals0, _, _ = run(base, np.ones(nb // 4, bool))
    assert oks0.sum() == S * n
    for i, w in enumerate(range(first, first + n)):
        want = np.asarray(jq.q5_hot_oracle(jlog, w, assigner, C))
        for d in range(S):
            np.testing.assert_array_equal(vals0[d, i], want)
    # crash after step 8, deterministic replay from batch 5
    crash = np.concatenate([np.arange(9), np.arange(5, 9), np.arange(9, 12)])
    crash = torch.from_numpy(np.tile(crash.astype(np.int32), (S, 1)))
    oks1, vals1, _, _ = run(crash, np.ones(crash.shape[1] // 4, bool))
    np.testing.assert_array_equal(oks1, oks0)
    np.testing.assert_array_equal(vals1, vals0)
    # partitioned for rounds 1-2 of 6, then healed
    wm = np.ones(6, bool)
    wm[1:3] = False
    oks2, vals2, _, sync2 = run(base, wm, sync_every=2)
    np.testing.assert_array_equal(oks2, oks0)
    np.testing.assert_array_equal(vals2, vals0)
    assert sync2[0] == 4 * S * 4.0  # 4 healthy rounds x [S] i32 map
    oks3, _, _, _ = run(base, np.zeros(6, bool), sync_every=2)
    assert oks3.sum() == 0.0


_DENSE_Q5 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
from repro import compat
from repro.launch.stream import build_pipeline, read_window_range
from repro.streaming import NexmarkConfig, generate_log
from repro.streaming.queries import make_q5

mesh = compat.make_mesh((2,), ("data",))
nx = NexmarkConfig(num_partitions=2, num_batches=8, events_per_batch=256,
                   num_auctions=5000, key_skew=1.1)
log = generate_log(nx)
q = make_q5(2, window_len={WL}, num_slots={SLOTS}, num_auctions=1024)
first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
with mesh:
    o, v, s = build_pipeline(q, mesh, 4, n_windows=n, first_window=first)(log)
out = {{"log." + k: np.asarray(getattr(log, k)) for k in {FIELDS}}}
out.update(oks=np.asarray(o), vals=np.asarray(v), sync=np.asarray(s))
np.savez(sys.argv[1], **out)
print("JAX_DENSE_Q5_OK")
""".format(WL=WL, SLOTS=SLOTS, FIELDS=FIELDS)


def test_dense_q5_on_the_segment_reduce_matches_jax(tmp_path):
    """Dense q5 at 1,024 auction buckets folds through the segment reduce
    (C >= SPARSE_KEY_THRESHOLD): bitwise the JAX ``build_pipeline`` at S=2."""
    out = tmp_path / "q5.npz"
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _DENSE_Q5, str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert "JAX_DENSE_Q5_OK" in r.stdout, f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-2000:]}"
    j = dict(np.load(out))
    log = event_batch_from_numpy({k: j["log." + k] for k in FIELDS})
    q = stream.MAKERS["q5"](2, window_len=WL, num_slots=SLOTS, num_auctions=1024)
    first, n = stream.read_window_range(q, 8 * 1000.0 * 256 / 10_000.0)
    seen = []
    from repro_torch.kernels import ops
    real = ops.segment_reduce
    ops.segment_reduce = lambda *a, **kw: seen.append(a[3]) or real(*a, **kw)
    try:
        oks, vals, sb = stream.build_pipeline(q, make_data_mesh(2, "cpu"), 4, n_windows=n,
                                              first_window=first)(log)
    finally:
        ops.segment_reduce = real
    assert seen and oks.sum() > 0
    np.testing.assert_array_equal(oks.numpy(), j["oks"])
    np.testing.assert_array_equal(vals.numpy(), j["vals"])
    np.testing.assert_array_equal(sb.numpy(), j["sync"])


def test_key_skew_ids_in_range_and_hottest_is_zero():
    S, nb, b, N = 2, 4, 4096, 1000
    log = generator.generate_log(generator.NexmarkConfig(
        num_partitions=S, num_batches=nb, events_per_batch=b, num_auctions=N, key_skew=1.1),
        "cpu")
    ids = log.auction.reshape(-1)
    assert ids.dtype == torch.int64 and int(ids.min()) >= 0 and int(ids.max()) < N
    counts = torch.bincount(ids, minlength=N)
    assert int(counts.argmax()) == 0
    # the mass of id 0 under the power law, as the JAX generator draws it
    jids = np.asarray(jgen.generate_log(jgen.NexmarkConfig(
        num_partitions=S, num_batches=nb, events_per_batch=b, num_auctions=N,
        key_skew=1.1)).auction).reshape(-1)
    mass = (1 - 2**-0.1) / (1 - (N + 1) ** -0.1)
    assert abs(float(counts[0]) / ids.numel() - mass) < 0.01
    assert abs(float((jids == 0).mean()) - mass) < 0.01
    uniform = generator.generate_log(generator.NexmarkConfig(
        num_partitions=S, num_batches=nb, events_per_batch=b, num_auctions=N), "cpu")
    assert float((uniform.auction == 0).float().mean()) < 0.01


def test_keyed_host_ops_per_step_stay_bounded():
    """The keyed step's eager host launches are held under a ceiling, as
    the dense pipeline's are (tests/test_torch_stream.py): about 150
    top-level torch ops a step at S=16 (149 on the CPU) when this was
    written."""
    from torch.profiler import ProfilerActivity, profile

    S, nb = 16, 8
    shards = W.KeyShards(100_000, S)
    log = generator.generate_log(generator.NexmarkConfig(
        num_partitions=S, num_batches=nb, events_per_batch=64, num_auctions=100_000,
        key_skew=1.1), "cpu")
    pipe = stream.build_keyed_pipeline(make_data_mesh(S, "cpu"), shards, window_len=10_000,
                                       num_slots=16, n_windows=1)
    sched, wm = stream.default_fold_schedule(S, nb), torch.ones(nb // 4, dtype=torch.bool)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.fold(log, sched, wm)
    ops = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None]
    assert len(ops) / nb <= 165, len(ops) / nb
