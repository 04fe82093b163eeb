"""The port's core (lattices, window assigners, CRDTs, Windowed CRDTs)
against ``repro.core`` on the same inputs.

Inputs are made with numpy from a seed.  The JAX side runs one replica at a
time; the port runs the replicas stacked (``[S, ...]``) and is compared row
by row, through ``repro_torch.convert``.  Counts, max/min, top-k, slot
tenants, watermarks, frontiers and error counters match bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crdt as jcrdt
from repro.core import wcrdt as JW
from repro.core import window as jwin
from repro.core.lattice import join_stacked as j_join_stacked
from repro_torch.convert import wstate_from_numpy, wstate_to_numpy
from repro_torch.core import crdt, wcrdt as W, window
from repro_torch.core.lattice import join_stacked
from repro_torch.launch.mesh import StackMesh


def _jax_state_np(st) -> dict:
    d = {k: np.asarray(getattr(st, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    d.update({f"windows.{f.name}": np.asarray(getattr(st.windows, f.name))
              for f in dataclasses.fields(st.windows)})
    return d


def _assert_states_equal(port_np: dict, jax_np: dict, row=None, float_rtol=None):
    assert port_np.keys() == jax_np.keys()
    for k, want in jax_np.items():
        got = port_np[k] if row is None else port_np[k][row]
        if float_rtol and np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=float_rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


# ---------------------------------------------------------------------------
# window assigners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wl,hop", [(10, 10), (10, 5), (12, 4), (7, 7)])
def test_assigners_match_jax_on_negative_zero_and_positive_ts(wl, hop):
    ja, pa = jwin.as_assigner(wl, hop), window.as_assigner(wl, hop)
    ts = np.arange(-3 * wl - 1, 3 * wl + 2, dtype=np.int32)
    jw, jv = ja.assign(jnp.asarray(ts))
    pw, pv = pa.assign(torch.from_numpy(ts))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pa.window_of(torch.from_numpy(ts)).numpy(),
                                  np.asarray(ja.window_of(jnp.asarray(ts))))
    np.testing.assert_array_equal(pa.first_dirty_wid(torch.from_numpy(ts)).numpy(),
                                  np.asarray(ja.first_dirty_wid(jnp.asarray(ts))))
    for t in (-wl - 1, -1, 0, 1, wl, 5 * wl + 3):
        assert pa.first_dirty_wid(t) == ja.first_dirty_wid(t)
        assert pa.window_of(t) == ja.window_of(t)
        assert pa.end_ts(t) == ja.end_ts(t)
        assert pa.contains(t, t) == ja.contains(t, t)
    for wid in (-2, 0, 3):
        np.testing.assert_array_equal(pa.contains(wid, torch.from_numpy(ts)).numpy(),
                                      np.asarray(ja.contains(wid, jnp.asarray(ts))))


def test_assigner_validation():
    with pytest.raises(ValueError):
        window.Hopping(10, 3)
    with pytest.raises(ValueError):
        window.Tumbling(10, 5)
    assert window.as_assigner(10, 10) == window.Tumbling(10)
    assert window.as_assigner(10, None).windows_per_event == 1


# ---------------------------------------------------------------------------
# CRDT folds and joins
# ---------------------------------------------------------------------------


def _batch(rng, S, B, W):
    slots = rng.integers(0, W, (S, B)).astype(np.int32)
    mask = rng.random((S, B)) > 0.25
    vals = (rng.standard_normal((S, B)) * 5).astype(np.float32)
    return slots, mask, vals


@pytest.mark.parametrize("kind", ["gcounter", "gcounter_keyed", "pncounter", "maxreg",
                                  "minreg", "gset"])
def test_crdt_fold_windows_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    S, B, Wn, P, C = 3, 64, 8, 3, 4
    slots, mask, vals = _batch(rng, S, B, Wn)
    keys = rng.integers(0, C, (S, B)).astype(np.int32)
    if kind.startswith("gcounter"):
        key_shape = (C,) if kind == "gcounter_keyed" else ()
        j0, p0 = jcrdt.GCounter.zero_windows(Wn, P, key_shape), crdt.GCounter.zero_windows(Wn, P, key_shape)
        amounts = np.abs(vals)
    elif kind == "pncounter":
        j0, p0 = jcrdt.PNCounter.zero_windows(Wn, P), crdt.PNCounter.zero_windows(Wn, P)
        amounts = vals
    elif kind in ("maxreg", "minreg"):
        jc, pc = {"maxreg": (jcrdt.MaxReg, crdt.MaxReg), "minreg": (jcrdt.MinReg, crdt.MinReg)}[kind]
        j0, p0 = jc.zero_windows(Wn, (C,)), pc.zero_windows(Wn, (C,))
    else:
        j0, p0 = jcrdt.GSet.zero_windows(Wn, C), crdt.GSet.zero_windows(Wn, C)
    p = type(p0)(**{n: getattr(p0, n).expand(S, *getattr(p0, n).shape).clone() for n in p0.KINDS})
    T = torch.from_numpy
    for step in range(2):  # fold twice: the second fold starts from state
        if kind.startswith("gcounter") or kind == "pncounter":
            k = T(keys) if kind == "gcounter_keyed" else None
            p = p.fold_windows(T(slots), T(mask), torch.arange(S), T(amounts), k)
        elif kind == "gset":
            p = p.fold_windows(T(slots), T(mask), T(keys))
        else:
            p = p.fold_windows(T(slots), T(mask), T(vals), T(keys))
        slots = np.roll(slots, 5)
    for s in range(S):
        j = j0
        sl = np.roll(slots, -10)  # replay the same two batches
        for step in range(2):
            a = lambda x: jnp.asarray(x[s])
            if kind.startswith("gcounter") or kind == "pncounter":
                k = a(keys) if kind == "gcounter_keyed" else None
                j = j.fold_windows(a(sl), a(mask), s, a(amounts), k)
            elif kind == "gset":
                j = j.fold_windows(a(sl), a(mask), a(keys))
            else:
                j = j.fold_windows(a(sl), a(mask), a(vals), a(keys))
            sl = np.roll(sl, 5)
        for f in dataclasses.fields(j):
            got = getattr(p, f.name)[s].numpy()
            want = np.asarray(getattr(j, f.name))
            np.testing.assert_array_equal(got, want)  # float sums too: lane order on both sides


@pytest.mark.parametrize("use_lo", [False, True])
def test_topk_fold_and_merge_match_jax(use_lo):
    rng = np.random.default_rng(3 + use_lo)
    S, B, Wn, k = 2, 96, 8, 4
    slots, mask, vals = _batch(rng, S, B, Wn)
    ids = rng.integers(0, 2**32, (S, B), dtype=np.uint64).astype(np.uint32)
    lo = np.array([2, 6], np.int32)
    p0 = crdt.TopK.zero_windows(Wn, k)
    p = crdt.TopK(p0.vals.expand(S, Wn, k).clone(), p0.ids.expand(S, Wn, k).clone())
    T = torch.from_numpy
    p = p.fold_windows(T(slots), T(mask), T(vals), T(ids.astype(np.int64)),
                       lo=T(lo) if use_lo else None, active=3)
    js = []
    for s in range(S):
        j = jcrdt.TopK.zero_windows(Wn, k)
        kw = dict(lo=jnp.int32(lo[s]), active=3) if use_lo else {}
        j = j.fold_windows(jnp.asarray(slots[s]), jnp.asarray(mask[s]), jnp.asarray(vals[s]),
                           jnp.asarray(ids[s]), **kw)
        np.testing.assert_array_equal(p.vals[s].numpy(), np.asarray(j.vals))
        np.testing.assert_array_equal(p.ids[s].numpy(), np.asarray(j.ids).astype(np.int64))
        js.append(j)
    jm = js[0].merge(js[1])
    pm = crdt.TopK(p.vals[0], p.ids[0]).merge(crdt.TopK(p.vals[1], p.ids[1]))
    np.testing.assert_array_equal(pm.vals.numpy(), np.asarray(jm.vals))
    np.testing.assert_array_equal(pm.ids.numpy(), np.asarray(jm.ids).astype(np.int64))


# ---------------------------------------------------------------------------
# Windowed CRDTs: insert, watermarks, delta sync, reads
# ---------------------------------------------------------------------------

SPECS = ["wgcounter", "wgcounter_keyed", "wpncounter", "wmaxreg", "wminreg", "wtopk", "wgset"]


def _make_spec(pkg, name, assigner, P):
    m = {"wgcounter": lambda: pkg.wgcounter(20, 8, P, assigner=assigner),
         "wgcounter_keyed": lambda: pkg.wgcounter(20, 8, P, key_shape=(3,), assigner=assigner),
         "wpncounter": lambda: pkg.wpncounter(20, 8, P, assigner=assigner),
         "wmaxreg": lambda: pkg.wmaxreg(20, 8, P, key_shape=(3,), assigner=assigner),
         "wminreg": lambda: pkg.wminreg(20, 8, P, assigner=assigner),
         "wtopk": lambda: pkg.wtopk(20, 8, P, 4, max_active_windows=4, assigner=assigner),
         "wgset": lambda: pkg.wgset(20, 8, P, 6, assigner=assigner)}
    return m[name]()


def _inputs(name, rng, B, p):
    vals = (rng.standard_normal(B) * 5).astype(np.float32)
    keys = rng.integers(0, 3, B).astype(np.int32)
    if name in ("wgcounter", "wgcounter_keyed", "wpncounter"):
        d = {"actor": p, "amounts": np.abs(vals) if name != "wpncounter" else vals}
        if name == "wgcounter_keyed":
            d["keys"] = keys
        return d
    if name == "wmaxreg":
        return {"vals": vals, "keys": keys}
    if name == "wminreg":
        return {"vals": vals}
    if name == "wtopk":
        return {"vals": vals, "ids": rng.integers(0, 50, B).astype(np.uint32)}
    return {"elems": rng.integers(0, 6, B).astype(np.int32)}


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("hop", [None, 10])
def test_wcrdt_insert_delta_merge_and_read_match_jax(name, hop):
    """Three replicas fold three batches each (late events, ring reuse and a
    replay included), starting from a progress below zero so that negative
    timestamps and window ids fold; then delta_since + merge_delta_stack +
    merge, and window_value for every window id in range."""
    rng = np.random.default_rng(sum(map(ord, name)) + (hop or 0))
    S, B = 3, 24
    jspec = _make_spec(JW, name, jwin.as_assigner(20, hop), S)
    pspec = _make_spec(W, name, window.as_assigner(20, hop), S)
    float_rtol = None  # float sums too: both folds add lane by lane into the state
    start = dict(_jax_state_np(jspec.zero()), progress=np.full((S,), -45, np.int32))
    jst = [JW.WState(**{k: jnp.asarray(v) for k, v in start.items() if "." not in k},
                     windows=jspec.zero_windows()) for _ in range(S)]
    pst = wstate_from_numpy(pspec, {k: np.stack([v] * S) for k, v in start.items()})
    base = [JW.zero_baseline(jspec) for _ in range(S)]
    pbase = W.zero_baseline(pspec, S)
    batches = []
    for b in range(3):
        ts = np.sort(rng.integers(-50 + 40 * b, -10 + 55 * b, (S, B))).astype(np.int32)
        batches.append((ts, rng.random((S, B)) > 0.2,
                        [_inputs(name, rng, B, p) for p in range(S)]))
    for b, (ts, mask, ins) in enumerate(batches + batches[1:2]):  # batch 1 replays
        bidx = b if b < 3 else 1
        for p in range(S):
            jin = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in ins[p].items()}
            jst[p] = JW.insert(jspec, jst[p], p, jnp.asarray(ts[p]), jnp.asarray(mask[p]),
                               batch_idx=bidx, **jin)
            jst[p] = JW.increment_watermark(jspec, jst[p], p, int(ts[p].max()))
        pin = {}
        for k in ins[0]:
            if k == "actor":
                pin[k] = torch.arange(S)
            else:
                a = np.stack([ins[p][k] for p in range(S)])
                pin[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
        pst = W.insert(pspec, pst, torch.arange(S), torch.from_numpy(ts),
                       torch.from_numpy(mask), batch_idx=bidx, **pin)
        pst = W.increment_watermark(pspec, pst, torch.arange(S), torch.from_numpy(ts.max(1)))
        got = wstate_to_numpy(pst)
        for p in range(S):
            _assert_states_equal(got, _jax_state_np(jst[p]), row=p, float_rtol=float_rtol)

    # delta sync: each replica's delta, the stacked merge, the join back
    jd = [JW.delta_since(jspec, jst[p], *map(jnp.asarray, base[p])) for p in range(S)]
    pd = W.delta_since(pspec, pst, *pbase)
    np.testing.assert_array_equal(W.delta_nbytes(pd).numpy(),
                                  [float(JW.delta_nbytes(d)) for d in jd])
    assert W.state_nbytes(pst) == JW.state_nbytes(jst[0])
    jm = JW.merge_delta_stack(jspec, jax.tree.map(lambda *x: jnp.stack(x), *jd))
    pm = W.merge_delta_stack(pspec, pd)
    _assert_states_equal(wstate_to_numpy(pm), _jax_state_np(jm), float_rtol=float_rtol)
    joined = W.merge(pspec, pst, pm)
    got = wstate_to_numpy(joined)
    for p in range(S):
        _assert_states_equal(got, _jax_state_np(JW.merge(jspec, jst[p], jm)), row=p,
                             float_rtol=float_rtol)
    for wid in range(-3, 8):
        pv, pok = W.window_value(pspec, joined, wid)
        jv, jok = JW.window_value(jspec, JW.merge(jspec, jst[0], jm), wid)
        assert bool(pok[0]) == bool(jok)
        for a, b in zip(pv if isinstance(pv, tuple) else (pv,),
                        jv if isinstance(jv, tuple) else (jv,)):
            if float_rtol:
                np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=float_rtol)
            else:
                np.testing.assert_array_equal(a[0].numpy(), np.asarray(b).astype(a.numpy().dtype))


@pytest.mark.parametrize("name", ["wgcounter_keyed", "wtopk"])
def test_full_sync_axis_join_matches_jax_join_stacked(name):
    rng = np.random.default_rng(5)
    S, B = 4, 16
    jspec = _make_spec(JW, name, jwin.Tumbling(20), S)
    pspec = _make_spec(W, name, window.Tumbling(20), S)
    jst = []
    for p in range(S):
        ts = np.sort(rng.integers(0, 60, B)).astype(np.int32)
        ins = _inputs(name, rng, B, p)
        st = JW.insert(jspec, jspec.zero(), p, jnp.asarray(ts), jnp.ones(B, bool), batch_idx=0,
                       **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                          for k, v in ins.items()})
        jst.append(JW.increment_watermark(jspec, st, p, int(ts.max())))
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jst)
    pst = wstate_from_numpy(pspec, _jax_state_np(stacked))
    want = j_join_stacked(stacked, merge_fn=JW._merge_wstate)
    got = W.axis_join(pspec, pst, StackMesh(S, torch.device("cpu")))
    g = wstate_to_numpy(got)
    for p in range(S):
        _assert_states_equal(g, _jax_state_np(want), row=p)
    g1 = wstate_to_numpy(join_stacked(pst, W._merge_wstate))
    _assert_states_equal({k: v[None] for k, v in g1.items()},
                         {k: v[None] for k, v in _jax_state_np(want).items()})


def test_stack_mesh_collectives():
    mesh = StackMesh(3, torch.device("cpu"))
    x = torch.tensor([[1, 5], [4, 2], [3, 3]])
    assert mesh.all_gather(x) is x
    np.testing.assert_array_equal(mesh.pmax(x).numpy(), [[4, 5]] * 3)
    np.testing.assert_array_equal(mesh.replicate(torch.tensor([7, 8])).numpy(), [[7, 8]] * 3)


def test_convert_roundtrip():
    spec = W.wtopk(20, 8, 3, 4)
    st = spec.zero(3)
    d = wstate_to_numpy(st)
    assert d["windows.ids"].dtype == np.uint32
    back = wstate_from_numpy(spec, d)
    for a, b in zip(wstate_to_numpy(back).values(), d.values()):
        np.testing.assert_array_equal(a, b)
    single = wstate_from_numpy(spec, {k: v[0] for k, v in d.items()})
    assert single.slot_wid.shape == (1, 8)
