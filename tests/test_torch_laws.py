"""The port's CRDTs are join-semilattices, and the rest of its core matches
the JAX package.

Mirrors ``tests/test_crdt_laws.py`` on the port's ``GCounter``,
``PNCounter``, ``MaxReg``, ``MinReg``, ``GSet``, ``LWWReg`` and ``TopK``
(CPU, drawn through ``tests/_prop.py``): join is commutative, associative
and idempotent, and ``join_many`` converges in any order.  The windowed
CRDTs are built by folding one lane at a time into a one-replica, two-slot
ring.  Every law holds bitwise.

Subnormals: the port's joins are ``torch.maximum``/``minimum`` and a
two-key sort, which keep subnormal floats as they are on the CPU (torch does
not flush them to zero unless asked to), and its ordered-u32 packing is a
bit reinterpretation.  So the JAX test's flaky example for ``topk_from``
(``ops_a=[(0, 0.0)]``, ``ops_b=[(0, 5.965e-41)]``, whose subnormal price
XLA's CPU flushes inside the JAX TopK join) is an explicit case here, and
the port's join keeps the subnormal and commutes.

Then parity with the JAX package, on the same numpy inputs: the
ordered-u32 packing and ``lex_join`` (±0.0, subnormals, ±inf, ties),
``LWWReg``, ``empty_batch``, the assigners' ``start_ts``/``complete``, and
``Query.merge_shared``/``global_watermark``/``window_of``; and
``wcrdt.axis_join_aligned`` against the generic ``axis_join`` on lockstep
replicas.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.core import crdt as jcrdt
from repro.core import lattice as jlat
from repro.core import window as jwin
from repro.streaming import events as jev
from repro.streaming import queries as jq
from repro_torch.convert import wstate_from_numpy, wstate_to_numpy
from repro_torch.core import lattice as L
from repro_torch.core import wcrdt as W
from repro_torch.core import window as pwin
from repro_torch.core.crdt import GCounter, GSet, LWWReg, MaxReg, MinReg, PNCounter, TopK
from repro_torch.launch.mesh import StackMesh
from repro_torch.streaming import events as pev
from repro_torch.streaming import queries as pq

settings.register_profile("ci-torch-laws", max_examples=40, deadline=None)
settings.load_profile("ci-torch-laws")

N_ACTORS = 4
SLOT = torch.zeros((1, 1), dtype=torch.int32)
ON = torch.ones((1, 1), dtype=torch.bool)


def _f32(x) -> torch.Tensor:
    return torch.tensor([[x]], dtype=torch.float32)


def leaves_equal(a, b):
    for name in a.KINDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), (name, x, y)


# ---- state generators: one lane folded at a time ----


def gcounter_from(ops):
    s = GCounter(GCounter.zero_windows(2, N_ACTORS).slots[None])
    for actor, amt in ops:
        s = s.fold_windows(SLOT, ON, actor % N_ACTORS, _f32(abs(amt)))
    return s


def pncounter_from(ops):
    z = PNCounter.zero_windows(2, N_ACTORS)
    s = PNCounter(z.pos[None], z.neg[None])
    for actor, amt in ops:
        s = s.fold_windows(SLOT, ON, actor % N_ACTORS, _f32(amt))
    return s


def maxreg_from(ops):
    s = MaxReg(MaxReg.zero_windows(2).v[None])
    for _, amt in ops:
        s = s.fold_windows(SLOT, ON, _f32(amt))
    return s


def minreg_from(ops):
    s = MinReg(MinReg.zero_windows(2).v[None])
    for _, amt in ops:
        s = s.fold_windows(SLOT, ON, _f32(amt))
    return s


def gset_from(ops):
    s = GSet(GSet.zero_windows(2, 16).bits[None])
    for actor, amt in ops:
        s = s.fold_windows(SLOT, ON, torch.tensor([[(actor + int(abs(amt))) % 16]]))
    return s


def lww_from(ops):
    s = LWWReg.zero(())
    for i, (actor, amt) in enumerate(ops):
        s = s.set_float(i * 7 + actor, amt)
    return s


def topk_from(ops):
    z = TopK.zero_windows(2, 4)
    s = TopK(z.vals[None], z.ids[None])
    for actor, amt in ops:
        s = s.fold_windows(SLOT, ON, _f32(amt), torch.tensor([[actor]]))
    return s


MAKERS = [gcounter_from, pncounter_from, maxreg_from, minreg_from, gset_from, lww_from, topk_from]

ops_strategy = st.lists(
    st.tuples(st.integers(0, 3), st.floats(-100, 100, allow_nan=False, width=32)),
    min_size=1,
    max_size=8,
)


def check_laws(a, b, c):
    leaves_equal(L.join(a, b), L.join(b, a))  # commutativity
    leaves_equal(L.join(L.join(a, b), c), L.join(a, L.join(b, c)))  # associativity
    leaves_equal(L.join(a, a), a)  # idempotence
    ab = L.join(a, b)
    leaves_equal(L.join(ab, b), ab)


@pytest.mark.parametrize("maker", MAKERS, ids=[m.__name__ for m in MAKERS])
@given(ops_a=ops_strategy, ops_b=ops_strategy, ops_c=ops_strategy)
def test_lattice_laws(maker, ops_a, ops_b, ops_c):
    check_laws(maker(ops_a), maker(ops_b), maker(ops_c))


@pytest.mark.parametrize("maker", MAKERS, ids=[m.__name__ for m in MAKERS])
@given(ops=st.lists(ops_strategy, min_size=2, max_size=5), seed=st.integers(0, 2**16))
def test_convergence_any_order(maker, ops, seed):
    """N replicas merged in any order converge to ``join_many``'s state."""
    states = [maker(o) for o in ops]
    ref = L.join_many(states)
    perm = np.random.default_rng(seed).permutation(len(states))
    acc = states[perm[0]]
    for i in perm[1:]:
        acc = L.join(acc, states[i])
    leaves_equal(acc, ref)


@pytest.mark.parametrize("maker", MAKERS, ids=[m.__name__ for m in MAKERS])
def test_lattice_laws_subnormal_example(maker):
    """The JAX test's falsifying example for ``topk_from``: the port keeps
    the subnormal price 5.965e-41 and the join commutes."""
    a, b = maker([(0, 0.0)]), maker([(0, 5.965e-41)])
    check_laws(a, b, maker([(1, -5.965e-41)]))
    if maker is topk_from:
        vals = L.join(a, b).vals[0, 0]
        assert vals[0].item() == np.float32(5.965e-41) and vals[1].item() == 0.0


def test_join_many_rejects_empty():
    with pytest.raises(ValueError):
        L.join_many([])


def test_gcounter_value():
    a = gcounter_from([(0, 5.0), (1, 2.0)])
    b = gcounter_from([(1, 2.0), (2, 4.0)])
    assert float(L.join(a, b).window_value(0)) == 5.0 + 2.0 + 4.0


def test_pncounter_signed():
    assert float(pncounter_from([(0, 5.0), (0, -3.0)]).window_value(0)) == 2.0


def test_topk_set_semantics():
    z = TopK.zero_windows(1, 3)
    t = TopK(z.vals[None], z.ids[None]).fold_windows(
        torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 2), dtype=torch.bool),
        torch.tensor([[5.0, 5.0]]), torch.tensor([[7, 7]]))
    assert int((L.join(t, t).vals == 5.0).sum()) == 1


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

EDGE_FLOATS = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 5.965e-41, -5.965e-41, 1.1754942e-38, -1.1754942e-38,
     1.0, -1.0, 3.4028235e38, -3.4028235e38, np.inf, -np.inf, 0.5, 123.25, -7.75],
    dtype=np.float32)


def _floats(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32).view(np.float32)
    return np.concatenate([EDGE_FLOATS, bits[np.isfinite(bits)]])


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_u32_matches_jax(seed):
    x = _floats(seed)
    want = np.asarray(jlat.float_to_ordered_u32(jnp.asarray(x)))
    got = L.float_to_ordered_u32(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = L.ordered_u32_to_float(got).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))  # every bit
    jback = np.asarray(jlat.ordered_u32_to_float(jnp.asarray(want)))
    np.testing.assert_array_equal(back.view(np.uint32), jback.view(np.uint32))
    # the packing is monotone: u32 order is float order (-0.0 sorts below 0.0)
    order = np.lexsort((~np.signbit(x), x))
    assert np.all(np.diff(got.numpy()[order]) >= 0)


def test_lex_join_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    n = 400
    ts_a = rng.integers(-3, 3, n).astype(np.int32)
    ts_b = np.where(rng.random(n) < 0.5, ts_a, rng.integers(-3, 3, n)).astype(np.int32)
    va = np.asarray(jlat.float_to_ordered_u32(jnp.asarray(rng.choice(EDGE_FLOATS, n))))
    vb = np.where(rng.random(n) < 0.3, va,
                  np.asarray(jlat.float_to_ordered_u32(jnp.asarray(rng.choice(EDGE_FLOATS, n)))))
    jt, jv = jlat.lex_join(*(jnp.asarray(a) for a in (ts_a, va, ts_b, vb)))
    pt, pv = L.lex_join(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
                          for a in (ts_a, va, ts_b, vb)))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv).astype(np.int64))


def test_lwwreg_matches_jax():
    rng = np.random.default_rng(5)
    j, p = jcrdt.LWWReg.zero((3,)), LWWReg.zero((3,))
    for i in range(30):
        ts, x, key = int(rng.integers(0, 10)), float(rng.choice(EDGE_FLOATS)), int(rng.integers(3))
        j, p = j.set_float(ts, x, key=key), p.set_float(ts, x, key=key)
        if i % 7 == 0:
            j, p = j.set_u32(ts, 17 * i, key=key), p.set_u32(ts, 17 * i, key=key)
    np.testing.assert_array_equal(p.ts.numpy(), np.asarray(j.ts))
    np.testing.assert_array_equal(p.value_u32.numpy(), np.asarray(j.value_u32).astype(np.int64))
    np.testing.assert_array_equal(p.value_float.numpy().view(np.uint32),
                                  np.asarray(j.value_float).view(np.uint32))
    whole = LWWReg.zero(()).set_float(4, -2.5).merge(LWWReg.zero(()).set_float(4, 3.0))
    assert whole.value_float.item() == 3.0  # a tie goes to the larger payload


def test_empty_batch_matches_jax():
    j, p = jev.empty_batch(7), pev.empty_batch(7)
    for f in ("ts", "kind", "auction", "price", "category", "bidder", "valid"):
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.shape == b.shape and not b.any()
        assert b.dtype == (np.int64 if a.dtype == np.uint32 else a.dtype)


@pytest.mark.parametrize("hop", [None, 250, 100])
def test_assigner_extents_match_jax(hop):
    ja, pa = jwin.as_assigner(1000, hop), pwin.as_assigner(1000, hop)
    for wid in range(0, 40, 3):
        assert pa.start_ts(wid) == ja.start_ts(wid) and pa.end_ts(wid) == ja.end_ts(wid)
        for gwm in (pa.end_ts(wid) - 1, pa.end_ts(wid), pa.end_ts(wid) + 5):
            assert pa.complete(wid, gwm) == ja.complete(wid, gwm)


def _jax_state_np(st) -> dict:
    d = {k: np.asarray(getattr(st, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    for name in st.windows.__dataclass_fields__:
        d[f"windows.{name}"] = np.asarray(getattr(st.windows, name))
    return d


@pytest.mark.parametrize("qname", ["q0", "q1_ratio", "q4", "q5", "q7"])
def test_query_helpers_match_jax(qname):
    """``merge_shared`` (stacked against the JAX package's unstacked merge,
    replica by replica), ``global_watermark`` and ``window_of``."""
    P, rng = 3, np.random.default_rng(len(qname))
    jquery = getattr(jq, "make_" + qname)(P, window_len=10, num_slots=8)
    pquery = getattr(pq, "make_" + qname)(P, window_len=10, num_slots=8)
    ts = torch.from_numpy(rng.integers(0, 200, 50).astype(np.int32))
    np.testing.assert_array_equal(pquery.window_of(ts).numpy(),
                                  np.asarray(jquery.window_of(ts.numpy())))
    assert int(pquery.window_of(37)) == int(jquery.window_of(37))
    if not pquery.shared_specs:
        local = _jax_state_np(jquery.init_local())
        local["progress"] = np.array([42], np.int32)
        loc = wstate_from_numpy(pquery.local_spec, local)
        assert pquery.global_watermark((), loc).tolist() == [42]
        return

    def rand_state(jspec):
        d = _jax_state_np(jspec.zero())
        d["slot_wid"] = rng.integers(-1, 12, d["slot_wid"].shape).astype(np.int32)
        d["progress"] = rng.integers(0, 100, P).astype(np.int32)
        d["folded"] = rng.integers(0, 5, P).astype(np.int32)
        for k in d:
            if k.startswith("windows.") and d[k].dtype == np.float32:
                d[k] = np.where(rng.random(d[k].shape) < 0.5, d[k],
                                np.round(rng.random(d[k].shape) * 50).astype(np.float32))
        if "windows.vals" in d:  # TopK rows stay desc-sorted sets
            d["windows.vals"] = -np.sort(-d["windows.vals"], axis=-1)
        return d

    a = [rand_state(s) for s in jquery.shared_specs]
    b = [rand_state(s) for s in jquery.shared_specs]
    pa = tuple(wstate_from_numpy(s, d) for s, d in zip(pquery.shared_specs, a))
    pb = tuple(wstate_from_numpy(s, d) for s, d in zip(pquery.shared_specs, b))
    ja = tuple(_jstate(s, d) for s, d in zip(jquery.shared_specs, a))
    jb = tuple(_jstate(s, d) for s, d in zip(jquery.shared_specs, b))
    for got, want in zip(pquery.merge_shared(pa, pb), jquery.merge_shared(ja, jb)):
        w = _jax_state_np(want)
        for k, v in wstate_to_numpy(got).items():
            np.testing.assert_array_equal(v[0], w[k], err_msg=k)
    assert pquery.global_watermark(pa, None).tolist() == [
        int(jquery.global_watermark(ja, None))]


def _jstate(jspec, d: dict):
    from repro.core.wcrdt import WState
    z = jspec.zero()
    windows = type(z.windows)(**{n: jnp.asarray(d[f"windows.{n}"])
                                 for n in z.windows.__dataclass_fields__})
    return WState(slot_wid=jnp.asarray(d["slot_wid"]), windows=windows,
                  progress=jnp.asarray(d["progress"]), folded=jnp.asarray(d["folded"]),
                  errors=jnp.asarray(d["errors"]))


@pytest.mark.parametrize("make", [
    lambda: W.wgcounter(10, 8, 3, key_shape=(2,)),
    lambda: W.wminreg(10, 8, 3),
    lambda: W.wgset(10, 8, 3, 6),
    lambda: W.wtopk(10, 8, 3, 4, max_active_windows=None),
], ids=["gcounter", "minreg", "gset", "topk"])
def test_axis_join_aligned_equals_axis_join_in_lockstep(make):
    """On replicas that hold the same ``slot_wid`` the aligned join (one
    reduce a leaf, TopK through ``join_many``) equals the generic one."""
    spec, S, rng = make(), 4, np.random.default_rng(9)
    mesh = StackMesh(S, torch.device("cpu"))
    st = spec.zero(S)
    wid = torch.from_numpy(rng.integers(-1, 20, 8).astype(np.int32)).expand(S, 8).contiguous()
    ts = torch.from_numpy(rng.integers(0, 200, (S, 30)).astype(np.int32))
    mask = torch.ones((S, 30), dtype=torch.bool)
    kw = {"amounts": torch.ones((S, 30)), "keys": torch.zeros((S, 30), dtype=torch.int32),
          "actor": torch.arange(S) % 3}
    if isinstance(st.windows, GSet):
        kw = {"elems": torch.from_numpy(rng.integers(0, 6, (S, 30)))}
    elif isinstance(st.windows, TopK):
        kw = {"vals": torch.from_numpy(rng.random((S, 30)).astype(np.float32)),
              "ids": torch.from_numpy(rng.integers(0, 50, (S, 30)))}
    elif isinstance(st.windows, MinReg):
        kw = {"vals": torch.from_numpy(rng.random((S, 30)).astype(np.float32))}
    windows = spec.fold(st.windows, torch.remainder(ts, 8), mask, **kw)
    st = W.WState(wid, windows, torch.from_numpy(rng.integers(0, 50, (S, 3)).astype(np.int32)),
                  st.folded, st.errors)
    got, want = W.axis_join_aligned(spec, st, mesh), W.axis_join(spec, st, mesh)
    for k, v in wstate_to_numpy(got).items():
        np.testing.assert_array_equal(v, wstate_to_numpy(want)[k], err_msg=k)
