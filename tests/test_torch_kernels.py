"""The port's plain kernel versions against the JAX package's kernels.

Inputs are made with numpy from a seed and go through ``repro.kernels.ref``,
the Pallas kernel in interpret mode (as tests/test_kernels.py runs it) and
the port's ``repro_torch.kernels.ref`` on the CPU.  Counts, max, min, the
merges and top-k must match bitwise; float sums to rtol 1e-5 (the Pallas
kernels sum a one-hot tile at a time, in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ops import gated_delta_merge as j_gated_delta_merge
from repro.kernels.segment_reduce import segment_reduce_pallas
from repro.kernels.topk_window import topk_window_pallas
from repro.kernels.window_agg import window_agg_pallas
from repro_torch.kernels import (
    build, crdt_merge, ops, ref, segment_reduce, topk_window, window_agg,
)


def _lanes(rng, S, B, W, C):
    vals = (rng.standard_normal((S, B)) * 10).astype(np.float32)
    slots = rng.integers(0, W, (S, B)).astype(np.int32)
    mask = rng.random((S, B)) > 0.2
    keys = rng.integers(0, C, (S, B)).astype(np.int32)
    init = (rng.standard_normal((S, W, C)) * 10).astype(np.float32)
    return vals, slots, mask, keys, init


def _check(op, got, want):
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,W", [(256, 8), (300, 16), (512, 24)])
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
@pytest.mark.parametrize("keyed", [False, True])
def test_window_agg_matches_jax(B, W, op, keyed):
    S, C = 2, (5 if keyed else 1)
    rng = np.random.default_rng(B + W + len(op) + keyed)
    vals, slots, mask, keys, init = _lanes(rng, S, B, W, C)
    t = [torch.from_numpy(a) for a in (vals, slots, mask, keys, init)]
    for use_init in (False, True):
        got = ref.window_agg_ref(t[0], t[1], t[2], W, op=op, keys=t[3] if keyed else None,
                                 C=C, init=t[4] if use_init else None).numpy()
        for s in range(S):
            jk = dict(keys=jnp.asarray(keys[s]), C=C) if keyed else {}
            want = jref.window_agg_ref(jnp.asarray(vals[s]), jnp.asarray(slots[s]),
                                       jnp.asarray(mask[s]), W, op=op, **jk,
                                       init=jnp.asarray(init[s].reshape((W, C) if keyed else (W,)))
                                       if use_init else None)
            _check(op, got[s].reshape(np.shape(want)), np.asarray(want))
            if not use_init:
                pal = window_agg_pallas(jnp.asarray(vals[s]), jnp.asarray(slots[s]),
                                        jnp.asarray(mask[s]), W, op=op, **jk, interpret=True)
                _check(op, got[s].reshape(np.shape(pal)), np.asarray(pal))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_window_agg_expanded_multi_emit_stream(op):
    """The hopping-window [B*K] lane stream (not a tile multiple) folds as
    the JAX reference folds it."""
    from repro.core.window import Hopping as JHopping, expand_events as j_expand
    from repro_torch.core.window import Hopping, expand_events

    rng = np.random.default_rng(42 + len(op))
    B, C, Wn = 300, 5, 16
    ts = np.sort(rng.integers(0, 40 * 8, B)).astype(np.int32)
    vals = (rng.random(B) * 10).astype(np.float32)
    mask = rng.random(B) > 0.2
    keys = rng.integers(0, C, B).astype(np.int32)
    jw, jm = j_expand(JHopping(40, 20), jnp.asarray(ts), jnp.asarray(mask))
    w, m = expand_events(Hopping(40, 20), torch.from_numpy(ts)[None], torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(jw))
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(jm))
    v2, k2 = np.repeat(vals, 2), np.repeat(keys, 2)
    want = jref.window_agg_ref(jnp.asarray(v2), jw % Wn, jm, Wn, op=op,
                               keys=jnp.asarray(k2), C=C)
    got = ref.window_agg_ref(torch.from_numpy(v2)[None], torch.remainder(w, Wn), m, Wn,
                             op=op, keys=torch.from_numpy(k2)[None], C=C)
    _check(op, got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("R,W,F", [(2, 8, 128), (4, 16, 200), (16, 64, 80)])
@pytest.mark.parametrize("op,dtype", [("max", np.float32), ("min", np.float32),
                                      ("max", np.int32), ("min", np.int32), ("or", np.uint8)])
def test_gated_delta_merge_matches_jax(R, W, F, op, dtype):
    """Bitwise against the JAX reference and the Pallas kernel (interpret)."""
    rng = np.random.default_rng(R * W + F + len(op))
    wid = rng.integers(-1, 5, (R, W)).astype(np.int32)
    wid[:, 0] = -1  # an all-clean slot
    if op == "or":
        leaf = rng.integers(0, 256, (R, W, F)).astype(dtype)
    else:
        leaf = (rng.standard_normal((R, W, F)) * 50).astype(dtype)
    leaf = np.where((wid < 0)[..., None], np.zeros_like(leaf), leaf)
    got = ref.gated_delta_merge_ref(torch.from_numpy(wid), torch.from_numpy(leaf), op=op).numpy()
    want = jref.gated_delta_merge_ref(jnp.asarray(wid), jnp.asarray(leaf), op=op)
    pal = j_gated_delta_merge(jnp.asarray(wid), jnp.asarray(leaf), op=op,
                              use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("case", ["all_clean", "all_dirty", "one_dirty_row"])
def test_gated_delta_merge_edges(case):
    rng = np.random.default_rng(7)
    R, W, F = 4, 16, 160
    if case == "all_clean":
        wid = np.full((R, W), -1, np.int32)
        leaf = np.zeros((R, W, F), np.float32)
    elif case == "all_dirty":
        wid = rng.integers(0, 3, (R, W)).astype(np.int32)
        leaf = rng.standard_normal((R, W, F)).astype(np.float32)
    else:
        wid = np.full((R, W), -1, np.int32)
        owner = rng.integers(0, R, W)
        wid[owner, np.arange(W)] = rng.integers(0, 9, W)
        leaf = rng.standard_normal((R, W, F)).astype(np.float32)
        leaf = np.where((wid < 0)[..., None], np.zeros_like(leaf), leaf)
    got = ops.gated_delta_merge(torch.from_numpy(wid), torch.from_numpy(leaf)).numpy()
    pal = j_gated_delta_merge(jnp.asarray(wid), jnp.asarray(leaf), op="max",
                              use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))
    if case == "one_dirty_row":
        np.testing.assert_array_equal(got, leaf[owner, np.arange(W)])


@pytest.mark.parametrize("N,n_seg,p_mask", [(300, 700, 0.8), (1000, 5, 0.9), (257, 1537, 0.0)])
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
def test_segment_reduce_matches_jax(N, n_seg, p_mask, op):
    """Ragged n_seg (not a tile multiple), segments no lane reaches, a few
    long segments, an all-masked batch: the plain version against the JAX
    reference and the Pallas kernel (interpret)."""
    rng = np.random.default_rng(N + n_seg + len(op))
    vals = (rng.standard_normal(N) * 10).astype(np.float32)
    segs = rng.integers(0, n_seg, N).astype(np.int32)
    mask = rng.random(N) < p_mask
    got = ref.segment_reduce_ref(*map(torch.from_numpy, (vals, segs, mask)), n_seg, op=op).numpy()
    j = [jnp.asarray(a) for a in (vals, segs, mask)]
    _check(op, got, np.asarray(jref.segment_reduce_ref(*j, n_seg, op=op)))
    _check(op, got, np.asarray(segment_reduce_pallas(*j, n_seg, op=op, interpret=True)))


@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
def test_window_agg_sparse_route_matches_jax(op):
    """A keyed fold with C >= SPARSE_KEY_THRESHOLD goes through the segment
    reduce, all replicas at once: against the JAX dispatcher's Pallas route
    (segment = slot*C + key, init joined after) and its reference."""
    rng = np.random.default_rng(len(op))
    S, L, W, C = 2, 400, 3, 1500
    vals, slots, mask, keys, init = _lanes(rng, S, L, W, C)
    t = [torch.from_numpy(a) for a in (vals, slots, mask, keys, init)]
    got = ops.window_agg(t[0], t[1], t[2], W, op=op, keys=t[3], C=C, init=t[4]).numpy()
    for s in range(S):
        a = [jnp.asarray(x[s]) for x in (vals, slots, mask)]
        for use_pallas in (True, False):
            want = jops.window_agg(*a, W, op=op, keys=jnp.asarray(keys[s]), C=C,
                                   init=jnp.asarray(init[s]), use_pallas=use_pallas,
                                   interpret=True)
            _check(op, got[s], np.asarray(want))


@pytest.mark.parametrize("R,F", [(1, 7), (4, 1024), (16, 1500)])
@pytest.mark.parametrize("op,dtype", [("max", np.float32), ("min", np.float32),
                                      ("max", np.int32), ("min", np.int32), ("or", np.uint8)])
def test_crdt_merge_matches_jax(R, F, op, dtype):
    """Bitwise against the JAX reference and the Pallas kernel (interpret),
    through the port's dispatcher on the CPU."""
    rng = np.random.default_rng(R + F + len(op))
    if dtype == np.uint8:
        stack = rng.integers(0, 256, (R, F)).astype(dtype)
    else:
        stack = (rng.standard_normal((R, F)) * 1e3).astype(dtype)
    got = ops.crdt_merge(torch.from_numpy(stack), op).numpy()
    np.testing.assert_array_equal(got, ref.crdt_merge_ref(torch.from_numpy(stack), op).numpy())
    np.testing.assert_array_equal(got, np.asarray(jref.crdt_merge_ref(jnp.asarray(stack), op)))
    pal = jops.crdt_merge(jnp.asarray(stack), op=op, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))


def _topk_inputs(rng, S, W, k, B, ties):
    sv = np.full((S, W, k), -np.inf, np.float32)
    si = np.zeros((S, W, k), np.uint32)
    for s in range(S):
        for w in range(W):
            n = rng.integers(0, k + 1)
            if ties:
                pairs = {(float(rng.integers(0, 4)), int(rng.integers(0, 6))) for _ in range(n)}
            else:
                pairs = {(float(rng.standard_normal()), int(rng.integers(0, 2**32))) for _ in range(n)}
            pairs = sorted(pairs, reverse=True)[:k]
            for j, (v, i) in enumerate(pairs):
                sv[s, w, j], si[s, w, j] = v, i
    if ties:
        vals = rng.integers(0, 4, (S, B)).astype(np.float32)
        ids = rng.integers(0, 6, (S, B)).astype(np.uint32)
    else:
        vals = (rng.standard_normal((S, B)) * 10).astype(np.float32)
        ids = rng.integers(0, 2**32, (S, B), dtype=np.uint64).astype(np.uint32)
    slots = rng.integers(0, W, (S, B)).astype(np.int32)
    mask = rng.random((S, B)) > 0.3
    return sv, si, vals, ids, slots, mask


@pytest.mark.parametrize("B,W,k", [(64, 4, 8), (300, 8, 4), (256, 16, 16)])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_window_matches_pallas(B, W, k, ties):
    """Values and ids bitwise against the Pallas kernel (interpret), tied
    prices and duplicate (price, id) pairs included."""
    rng = np.random.default_rng(B + W + k + ties)
    S = 2
    arrs = _topk_inputs(rng, S, W, k, B, ties)
    tv, ti = ref.topk_window_ref(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                                    else a) for a in arrs))
    for s in range(S):
        pv, pi = topk_window_pallas(*(jnp.asarray(a[s]) for a in arrs), interpret=True)
        np.testing.assert_array_equal(tv[s].numpy(), np.asarray(pv))
        np.testing.assert_array_equal(ti[s].numpy(), np.asarray(pi).astype(np.int64))
        if not ties:  # distinct pairs: the JAX reference (no dedup) agrees too
            rv, ri = jref.topk_window_ref(*(jnp.asarray(a[s]) for a in arrs))
            np.testing.assert_array_equal(tv[s].numpy(), np.asarray(rv))
            np.testing.assert_array_equal(ti[s].numpy(), np.asarray(ri).astype(np.int64))


def test_topk_tie_semantics_against_jax_variants():
    """Where the three JAX top-k paths part on ties (ROADMAP Queue 3):

    * a duplicate (price, id) pair: the Pallas kernel and the port collapse
      it; ``repro.kernels.ref.topk_window_ref`` keeps both copies;
    * more than k lanes tied on the price: the Pallas kernel and the port
      keep the k largest ids; the JAX fast fold (``TopK.fold_windows`` with
      ``lo``) pre-reduces with ``lax.top_k`` by value alone, which keeps the
      k lowest lanes, and so the k smallest-index ids.
    """
    from repro.core.crdt import TopK as JTopK

    k, W = 2, 4
    sv = np.full((W, k), -np.inf, np.float32)
    si = np.zeros((W, k), np.uint32)
    # duplicate pair (5.0, 9) in window 0
    vals = np.array([5.0, 5.0, 1.0], np.float32)
    ids = np.array([9, 9, 3], np.uint32)
    slots = np.zeros(3, np.int32)
    mask = np.ones(3, bool)
    args = [jnp.asarray(a) for a in (sv, si, vals, ids, slots, mask)]
    pv, pi = topk_window_pallas(*args, interpret=True)
    rv, ri = jref.topk_window_ref(*args)
    tv, ti = ref.topk_window_ref(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                                    else a)[None]
                                   for a in (sv, si, vals, ids, slots, mask)))
    assert np.asarray(pv)[0].tolist() == tv[0, 0].tolist() == [5.0, 1.0]
    assert np.asarray(rv)[0].tolist() == [5.0, 5.0]  # the reference keeps the duplicate

    # three lanes tied at 7.0 with ids 1, 2, 3 (in lane order)
    vals = np.array([7.0, 7.0, 7.0], np.float32)
    ids = np.array([1, 2, 3], np.uint32)
    tv, ti = ref.topk_window_ref(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                                                    else a)[None]
                                   for a in (sv, si, vals, ids, slots, mask)))
    pv, pi = topk_window_pallas(*(jnp.asarray(a) for a in (sv, si, vals, ids, slots, mask)),
                                interpret=True)
    fast = JTopK(jnp.asarray(sv), jnp.asarray(si)).fold_windows(
        jnp.asarray(slots), jnp.asarray(mask), jnp.asarray(vals), jnp.asarray(ids),
        lo=jnp.int32(0), active=W)
    assert ti[0, 0].tolist() == np.asarray(pi)[0].tolist() == [3, 2]
    assert np.asarray(fast.ids)[0].tolist() == [2, 1]


def test_ops_dispatch_cpu_takes_the_plain_versions():
    rng = np.random.default_rng(1)
    vals, slots, mask, keys, init = [torch.from_numpy(a) for a in _lanes(rng, 2, 256, 8, 5)]
    np.testing.assert_array_equal(
        ops.window_agg(vals, slots, mask, 8, op="max", keys=keys, C=5, init=init),
        ref.window_agg_ref(vals, slots, mask, 8, op="max", keys=keys, C=5, init=init))
    wid = torch.tensor([[0, -1], [1, -1]], dtype=torch.int32)
    leaf = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    np.testing.assert_array_equal(ops.gated_delta_merge(wid, leaf),
                                  ref.gated_delta_merge_ref(wid, leaf))


def test_ops_guards(monkeypatch):
    z = torch.zeros((1, 4))
    i = torch.zeros((1, 4), dtype=torch.int32)
    m = torch.ones((1, 4), dtype=torch.bool)
    seen = []
    monkeypatch.setattr(ops, "segment_reduce",
                        lambda *a, **kw: seen.append((a, kw)) or ref.segment_reduce_ref(*a, **kw))
    out = ops.window_agg(z, i, m, 4, keys=i, C=ops.SPARSE_KEY_THRESHOLD)
    assert len(seen) == 1 and seen[0][0][3] == 4 * ops.SPARSE_KEY_THRESHOLD
    assert out.shape == (1, 4, ops.SPARSE_KEY_THRESHOLD)
    ops.window_agg(z, i, m, 4, keys=i, C=ops.SPARSE_KEY_THRESHOLD - 1)
    assert len(seen) == 1  # below the threshold: the dense fold
    with pytest.raises(ValueError, match="overflows"):
        ops.window_agg(z, i, m, 2**22, keys=i, C=1023)
    with pytest.raises(ValueError, match="overflows"):
        ops.window_agg(torch.zeros((2, 4)), i.expand(2, 4), m.expand(2, 4), 2**20,
                       keys=i.expand(2, 4), C=1024)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    z = torch.zeros((1, 4))
    i = torch.zeros((1, 4), dtype=torch.int32)
    m = torch.ones((1, 4), dtype=torch.bool)
    before = window_agg.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        window_agg.window_agg(z, i, m, 4)
    with pytest.raises(ValueError, match="CUDA"):
        crdt_merge.gated_delta_merge(torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        topk_window.topk_window(torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2), dtype=torch.int64),
                                z, i.long(), i, m)
    with pytest.raises(ValueError, match="no kernel"):
        crdt_merge.gated_delta_merge(torch.zeros((1, 4), dtype=torch.int32),
                                     torch.zeros((1, 4, 2)), op="or")
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce.segment_reduce(z[0], i[0], m[0], 4)
    with pytest.raises(ValueError, match="CUDA"):
        crdt_merge.crdt_merge(i, "max")
    with pytest.raises(ValueError, match="no kernel"):
        crdt_merge.crdt_merge(z, "or")
    assert window_agg.KERNEL.launches == before


def test_build_names_libraries_by_source_hash():
    """Each source builds for sm_90a into its own library named by a hash of
    the source and flags; nothing is built when a module is imported."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    paths = {n: build.lib_path(n) for n in ops.SOURCES}
    assert len(set(paths.values())) == len(ops.SOURCES) == 7
    for n, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(n + "-")
        assert build.lib_path(n) == p
    assert not build._LIBS


def test_window_agg_hot_cell_sum_is_the_jax_live_fold():
    """The order the fold kernels keep: at a hot-cell shape (C = 1, 16,384
    non-integer lanes, nearly all in one cell, folded into a running state)
    the plain version's sum equals the JAX live fold's scatter-add
    (``GCounter.fold_windows``) bit for bit, so it is a sum from ``init`` in
    lane order, not a sum of the batch added to ``init``."""
    from repro.core.crdt import GCounter as JGCounter

    rng = np.random.default_rng(14)
    L, W, P, actor = 16_384, 64, 3, 1
    vals = (rng.random(L) * 10 + 0.1).astype(np.float32)
    slots = np.where(rng.random(L) < 0.97, 9, 10).astype(np.int32)
    mask = rng.random(L) < 0.9
    state = (rng.random((W, P)) * 1e4).astype(np.float32)
    want = JGCounter(jnp.asarray(state)).fold_windows(
        jnp.asarray(slots), jnp.asarray(mask), actor, jnp.asarray(vals)).slots[:, actor]
    got = ref.window_agg_ref(torch.from_numpy(vals)[None], torch.from_numpy(slots)[None],
                             torch.from_numpy(mask)[None], W, op="sum",
                             init=torch.from_numpy(state[:, actor].reshape(1, W, 1)))
    np.testing.assert_array_equal(got.reshape(W).numpy(), np.asarray(want))
    # the batch's sum added to the state once rounds otherwise
    batch = ref.window_agg_ref(torch.from_numpy(vals)[None], torch.from_numpy(slots)[None],
                               torch.from_numpy(mask)[None], W, op="sum")
    assert not np.array_equal((batch.reshape(W) + torch.from_numpy(state[:, actor])).numpy(),
                              np.asarray(want))
