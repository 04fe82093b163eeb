"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips itself when no card is present, so they
count only where one is.  Run them on a machine with an H100 and nvcc:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import crdt_merge, ops, ref, segment_reduce, topk_window, window_agg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lanes(rng, S, L, W, C, keyed, p_mask=0.8):
    vals = torch.from_numpy((rng.standard_normal((S, L)) * 10).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, W, (S, L)).astype(np.int32))
    mask = torch.from_numpy(rng.random((S, L)) < p_mask)
    keys = torch.from_numpy(rng.integers(0, C, (S, L)).astype(np.int32)) if keyed else None
    init = torch.from_numpy((rng.standard_normal((S, W, C)) * 10).astype(np.float32))
    return vals, slots, mask, keys, init


@pytest.mark.parametrize("L", [1, 1000, 1024, 16383])
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
@pytest.mark.parametrize("keyed", [False, True])
def test_window_agg_kernel_matches_plain(dev, L, op, keyed):
    """Counts, max and min bitwise; sums to rtol 1e-5 (the plain version
    sums by atomics on the card, in another order)."""
    rng = np.random.default_rng(L + len(op) + keyed)
    S, W, C = 3, 64, 5 if keyed else 1
    vals, slots, mask, keys, init = _lanes(rng, S, L, W, C, keyed)
    args = [t.to(dev) for t in (vals, slots, mask)]
    kd = keys.to(dev) if keyed else None
    for it in (None, init.to(dev)):
        got = window_agg.window_agg(*args, W, op=op, keys=kd, C=C, init=it)
        want = ref.window_agg_ref(*args, W, op=op, keys=kd, C=C, init=it)
        cpu = ref.window_agg_ref(vals, slots, mask, W, op=op, keys=keys, C=C,
                                 init=None if it is None else init)
        torch.cuda.synchronize()
        if op == "sum":
            np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-4)
            # lane-order folds on both sides: the CPU plain version is exact
            np.testing.assert_array_equal(got.cpu(), cpu)
        else:
            np.testing.assert_array_equal(got.cpu(), want.cpu())


def test_window_agg_all_masked(dev):
    S, L, W, C = 2, 3000, 16, 4
    rng = np.random.default_rng(0)
    vals, slots, mask, keys, init = _lanes(rng, S, L, W, C, True, p_mask=0.0)
    for op in ("sum", "max"):
        got = window_agg.window_agg(vals.to(dev), slots.to(dev), mask.to(dev), W, op=op,
                                    keys=keys.to(dev), C=C, init=init.to(dev))
        np.testing.assert_array_equal(got.cpu(), init)


@pytest.mark.parametrize("R,W,F", [(16, 64, 16), (16, 64, 80), (16, 64, 1024), (3, 5, 200)])
@pytest.mark.parametrize("op,dtype", [("max", torch.float32), ("min", torch.float32),
                                      ("max", torch.int32), ("min", torch.int32),
                                      ("or", torch.uint8), ("max", torch.uint8)])
def test_gated_delta_merge_kernel_matches_plain(dev, R, W, F, op, dtype):
    rng = np.random.default_rng(R * W + F + len(op))
    wid = torch.from_numpy(rng.integers(-1, 4, (R, W)).astype(np.int32))
    wid[:, 0] = -1  # one all-clean slot
    if dtype == torch.uint8:
        leaf = torch.from_numpy(rng.integers(0, 256, (R, W, F)).astype(np.uint8))
    else:
        leaf = torch.from_numpy((rng.standard_normal((R, W, F)) * 50)).to(dtype)
    leaf = torch.where((wid < 0)[..., None], torch.zeros_like(leaf), leaf)
    got = crdt_merge.gated_delta_merge(wid.to(dev), leaf.to(dev), op=op)
    want = ref.gated_delta_merge_ref(wid, leaf, op=op)
    np.testing.assert_array_equal(got.cpu(), want)


@pytest.mark.parametrize("L", [1, 999, 16384])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_window_kernel_matches_plain(dev, L, ties):
    """Top-k values and ids bitwise, with tied prices and duplicate pairs."""
    rng = np.random.default_rng(L + ties)
    S, W, k = 3, 64, 8
    if ties:
        vals = rng.integers(0, 4, (S, L)).astype(np.float32)
        ids = rng.integers(0, 6, (S, L))
    else:
        vals = (rng.standard_normal((S, L)) * 10).astype(np.float32)
        ids = rng.integers(0, 2**32, (S, L))
    slots = rng.integers(0, W, (S, L)).astype(np.int32)
    mask = rng.random((S, L)) < 0.8
    sv0 = np.full((S, W, 2 * k), -np.inf, np.float32)
    si0 = np.zeros((S, W, 2 * k), np.int64)
    sv0[..., :k] = rng.integers(0, 4, (S, W, k)) if ties else rng.standard_normal((S, W, k))
    si0[..., :k] = rng.integers(0, 6, (S, W, k))
    sv, si = ref.lex_topk(torch.from_numpy(sv0), torch.from_numpy(si0), k)
    args = [torch.from_numpy(a) for a in (vals, ids, slots, mask)]
    got = topk_window.topk_window(sv.to(dev), si.to(dev), *[a.to(dev) for a in args])
    want = ref.topk_window_ref(sv, si, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu(), w)


def _topk_case(case: str, k: int):
    """Lanes and a valid state (descending, distinct, (-inf, 0) padded) for
    one shape of the tile and row phases (tiles of 1,024 lanes)."""
    rng = np.random.default_rng(len(case) * 31 + k)
    S, W = 3, 64
    L = {"one_lane": 1, "ragged": 1500, "ragged_large": 16383}.get(case, 4096)
    vals = (rng.standard_normal((S, L)) * 10).astype(np.float32)
    ids = rng.integers(0, 2**32, (S, L))
    slots = rng.integers(0, W, (S, L)).astype(np.int32)
    mask = rng.random((S, L)) < 0.8
    lane = np.arange(L)
    if case == "every_lane_own_slot":  # each tile holds all 64 slots
        slots[:] = lane % W
    elif case == "slot_across_tile_edge":  # slot 5 runs from tile 0 into tile 1
        slots[:] = np.where(lane < 900, 4, np.where(lane < 1900, 5, 6))
    elif case == "ties_across_tiles":  # duplicate pairs in every tile, one slot
        vals = rng.integers(0, 4, (S, L)).astype(np.float32)
        ids = rng.integers(0, 6, (S, L))
        slots[:] = 9
    elif case == "all_masked":
        mask[:] = False
    sv0 = np.full((S, W, 2 * k), -np.inf, np.float32)
    si0 = np.zeros((S, W, 2 * k), np.int64)
    if case == "state_beats_lanes":
        sv0[..., :k] = 1000.0 + rng.random((S, W, k)) * 10
    else:
        sv0[..., :k] = rng.standard_normal((S, W, k)) * 10
    si0[..., :k] = rng.integers(0, 6, (S, W, k))
    sv0[:, ::5, k // 2:k] = -np.inf  # rows short of k pairs
    si0[:, ::5, k // 2:k] = 0
    sv, si = ref.lex_topk(torch.from_numpy(sv0), torch.from_numpy(si0), k)
    lanes = [torch.from_numpy(a) for a in (vals, ids, slots, mask)]
    return sv, si, lanes


@pytest.mark.parametrize("case", ["every_lane_own_slot", "slot_across_tile_edge",
                                  "ties_across_tiles", "one_lane", "ragged", "ragged_large",
                                  "all_masked", "state_beats_lanes"])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_topk_window_tile_and_row_phases(dev, case, k):
    """Bitwise against the plain version, launched twice: many slots in a
    tile, a slot across a tile edge, ties and duplicates split over tiles
    (they collapse in the row phase), one lane, ragged tiles, every lane
    masked, and state rows that beat every lane."""
    sv, si, lanes = _topk_case(case, k)
    want = ref.topk_window_ref(sv, si, *lanes)
    args = [a.to(dev) for a in (sv, si, *lanes)]
    for _ in range(2):
        got = topk_window.topk_window(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu(), w)


def test_topk_window_rows_no_lane_reaches_come_back_unchanged(dev):
    """Slots that no live lane names return their state rows bit for bit."""
    sv, si, (vals, ids, slots, mask) = _topk_case("ragged_large", 8)
    slots = slots % 7  # lanes reach slots 0-6 only
    sv_d, si_d = sv.to(dev), si.to(dev)
    out_v, out_i = topk_window.topk_window(sv_d, si_d, vals.to(dev), ids.to(dev),
                                           slots.to(dev), mask.to(dev))
    assert torch.equal(out_v[:, 7:], sv_d[:, 7:]) and torch.equal(out_i[:, 7:], si_d[:, 7:])
    want = ref.topk_window_ref(sv, si, vals, ids, slots, mask)
    np.testing.assert_array_equal(out_v.cpu(), want[0])
    np.testing.assert_array_equal(out_i.cpu(), want[1])


@pytest.mark.parametrize("N,n_seg,p_mask", [(0, 7, 0.8), (1, 512, 0.8), (5000, 1000, 0.8),
                                             (20000, 3, 0.9), (4096, 70_000, 0.0),
                                             (100_000, 1_000_003, 0.7)])
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
def test_segment_reduce_kernel_matches_plain(dev, N, n_seg, p_mask, op):
    """Empty and one-lane streams, a few huge segments, all lanes masked,
    ragged tiles: counts, max and min bitwise against the plain version on
    the card; every op bitwise against the CPU plain version (both fold each
    segment in lane order from ``init``); sums to rtol 1e-5 against the
    card's plain version, which adds by atomics in another order.  Values
    are non-negative, as the dataplane's counts are, so that a relative
    tolerance bounds a reordered sum."""
    rng = np.random.default_rng(N + n_seg + len(op))
    vals = torch.from_numpy(np.abs(rng.standard_normal(N) * 10).astype(np.float32))
    segs = torch.from_numpy(rng.integers(0, n_seg, N).astype(np.int32))
    mask = torch.from_numpy(rng.random(N) < p_mask)
    init = torch.from_numpy(np.abs(rng.standard_normal(n_seg) * 10).astype(np.float32))
    for it in (None, init):
        got = segment_reduce.segment_reduce(vals.to(dev), segs.to(dev), mask.to(dev), n_seg,
                                            op=op, init=None if it is None else it.to(dev))
        want = ref.segment_reduce_ref(vals.to(dev), segs.to(dev), mask.to(dev), n_seg, op=op,
                                      init=None if it is None else it.to(dev))
        cpu = ref.segment_reduce_ref(vals, segs, mask, n_seg, op=op, init=it)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu(), cpu)
        if op == "sum":
            np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("R,F", [(1, 5), (16, 16), (16, 64), (3, 1000), (16, 1 << 20)])
@pytest.mark.parametrize("op,dtype", [("max", torch.float32), ("min", torch.float32),
                                      ("max", torch.int32), ("min", torch.int32),
                                      ("or", torch.uint8), ("or", torch.bool)])
def test_crdt_merge_kernel_matches_plain(dev, R, F, op, dtype):
    rng = np.random.default_rng(R + F + len(op))
    if dtype in (torch.uint8, torch.bool):
        stack = torch.from_numpy(rng.integers(0, 256, (R, F)).astype(np.uint8)).to(dtype)
    else:
        stack = torch.from_numpy(rng.standard_normal((R, F)) * 1e3).to(dtype)
    got = ops.crdt_merge(stack.to(dev), op)
    assert got.dtype == dtype and got.shape == (F,)
    np.testing.assert_array_equal(got.cpu(), ref.crdt_merge_ref(stack, op))
    nd = ops.crdt_merge(stack.reshape(R, 1, F).to(dev), op)  # trailing dims flatten
    np.testing.assert_array_equal(nd.cpu().reshape(F), got.cpu())


def test_kernel_wrappers_count_launches(dev):
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    S, L, W = 2, 100, 8
    z = torch.zeros((S, L), device=dev)
    slots = torch.zeros((S, L), dtype=torch.int32, device=dev)
    mask = torch.ones((S, L), dtype=torch.bool, device=dev)
    ops.window_agg(z, slots, mask, W)
    ops.gated_delta_merge(torch.zeros((S, W), dtype=torch.int32, device=dev),
                          torch.zeros((S, W, 3), device=dev))
    ops.topk_window(torch.full((S, W, 4), float("-inf"), device=dev),
                    torch.zeros((S, W, 4), dtype=torch.int64, device=dev),
                    z, torch.zeros((S, L), dtype=torch.int64, device=dev), slots, mask)
    ops.segment_reduce(z[0], slots[0], mask[0], 7)
    ops.crdt_merge(slots, "max")
    wid = torch.zeros((S, W), dtype=torch.int32, device=dev)
    ops.delta_merge_join(wid, wid, [torch.zeros((S, W, 3), device=dev)],
                         [torch.zeros((S, W, 3), device=dev)], ["max"], [slots], [slots])
    for n, k in ops.KERNELS.items():
        assert k.launches == before[n] + 1, n


@pytest.mark.parametrize("qname", ["q0", "q1_ratio", "q4", "q5", "q7"])
def test_pipeline_on_card_matches_cpu(dev, qname):
    """The dataplane on the card gives the CPU run's outputs bitwise, q4's
    float price sums included: the fold kernel adds lane by lane into the
    running sum, as the CPU plain version does."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline, read_window_range
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    S = 4
    nx = NexmarkConfig(num_partitions=S, num_batches=16, events_per_batch=512)
    log = generate_log(nx, "cpu")
    q = MAKERS[qname](S, window_len=100, num_slots=16)
    first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
    outs = []
    for d in ("cpu", dev):
        pipe = build_pipeline(q, make_data_mesh(S, d), 4, n_windows=n, first_window=first)
        outs.append([t.cpu() for t in pipe(log.map(lambda x: x.to(d)))])
    (oc, vc, sc), (og, vg, sg) = outs
    assert oc.sum() > 0
    np.testing.assert_array_equal(og, oc)
    np.testing.assert_array_equal(sg, sc)
    np.testing.assert_array_equal(vg, vc)


@pytest.mark.parametrize("S", [2, 4])
def test_keyed_pipeline_on_card_matches_cpu(dev, S):
    """The keyed dataplane (segment_reduce folds, crdt_merge watermark
    exchange) on the card gives the CPU run's outputs and state bitwise."""
    from repro_torch.convert import wstate_to_numpy
    from repro_torch.core.wcrdt import KeyShards
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import build_keyed_pipeline, default_fold_schedule
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    C, nb = 10_000, 12
    shards = KeyShards(C, S)
    nx = NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=512,
                       num_auctions=C, key_skew=1.1)
    log = generate_log(nx, "cpu")
    sched, wm = default_fold_schedule(S, nb), torch.ones(nb // 4, dtype=torch.bool)
    outs = []
    for d in ("cpu", dev):
        pipe = build_keyed_pipeline(make_data_mesh(S, d), shards, window_len=100,
                                    num_slots=16, n_windows=4, first_window=1, provenance=True)
        lg = log.map(lambda x: x.to(d))
        state, *rest = pipe.fold(lg, sched, wm)
        outs.append((wstate_to_numpy(state), [t.cpu() for t in pipe(lg, shards.key_table(), sched, wm)]))
    (sc, oc), (sg, og) = outs
    assert oc[0].sum() > 0
    for k in sc:
        np.testing.assert_array_equal(sg[k], sc[k], err_msg=k)
    for a, b in zip(og, oc):
        np.testing.assert_array_equal(a, b)


def _zipf_keys(rng, shape, C, a=1.1):
    """Keys in [0, C) drawn with zipf(a) popularity: key 0 the hottest."""
    w = 1.0 / np.arange(1, C + 1) ** a
    return rng.choice(C, size=shape, p=w / w.sum()).astype(np.int32)


def _same_bits_twice(launch, want):
    """The kernel's output equals ``want`` bitwise, and so does a second launch."""
    got = launch()
    again = launch()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu(), want)
    np.testing.assert_array_equal(again.cpu(), got.cpu())


# (L, W, C, lanes): the fold kernel's edges.  A tile holds 4,096 lanes and a
# block a range of up to 512 cells.
WINDOW_AGG_EDGES = {
    "one_cell": (16_384, 64, 1, "one"),  # every lane in one cell
    "run_across_tiles": (3 * 4096 + 7, 64, 1, "two_slots"),  # two cells' runs cross tiles
    "ragged_range_c5": (16_384, 64, 5, "two_slots"),  # 320 cells, not a range multiple
    "ragged_range_c37": (9_000, 64, 37, "uniform"),  # 2,368 cells: four ranges and a part
    "ragged_lanes": (4097, 16, 3, "uniform"),  # one lane past a tile
    "zipf_keys": (32_768, 64, 64, "zipf"),  # q5's shape, zipf(1.1) keys
}


@pytest.mark.parametrize("case", list(WINDOW_AGG_EDGES))
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
def test_window_agg_kernel_edges(dev, case, op):
    """Every op bitwise against the CPU plain version (lane-order folds on
    both sides, non-integer values), and a second launch gives the same bits."""
    L, W, C, lanes = WINDOW_AGG_EDGES[case]
    S = 4
    rng = np.random.default_rng(L + W + C + len(op))
    vals = (rng.standard_normal((S, L)) * 10).astype(np.float32)
    mask = rng.random((S, L)) < 0.9
    if lanes == "one":
        slots = np.full((S, L), 17, np.int32)
        mask[:] = True
    elif lanes == "two_slots":
        slots = (rng.random((S, L)) < 0.4).astype(np.int32) + 30
    else:
        slots = rng.integers(0, W, (S, L)).astype(np.int32)
        if lanes == "zipf":
            slots = (rng.random((S, L)) < 0.5).astype(np.int32) + 5
    if lanes == "zipf":
        keys = _zipf_keys(rng, (S, L), C)
    else:
        keys = rng.integers(0, C, (S, L)).astype(np.int32)
    init = (rng.standard_normal((S, W, C)) * 10).astype(np.float32)
    t = [torch.from_numpy(a) for a in (vals, slots, mask, keys, init)]
    d = [x.to(dev) for x in t]
    kd, kc = (None, None) if C == 1 else (d[3], t[3])
    for use_init in (False, True):
        want = ref.window_agg_ref(t[0], t[1], t[2], W, op=op, keys=kc, C=C,
                                  init=t[4] if use_init else None)
        it = d[4] if use_init else None
        _same_bits_twice(lambda: window_agg.window_agg(d[0], d[1], d[2], W, op=op, keys=kd, C=C,
                                                       init=it), want)


def _segment_edge_case(case, rng):
    """(vals, segs, mask, n_seg) of the segment reduce's edges."""
    if case == "one_segment_unaligned":
        # every lane but the first three in one segment: its run starts at
        # stream position 3 and N is not a multiple of 4
        N, n_seg = 100_003, 3000
        segs = np.full(N, 1777, np.int32)
        segs[:3] = 12
        mask = np.ones(N, bool)
    elif case == "hot_last_tile":
        N, n_seg = 60_001, 5000  # ten tiles; the hot segment in the last
        segs = rng.integers(0, n_seg, N).astype(np.int32)
        segs[rng.random(N) < 0.5] = n_seg - 1
        mask = rng.random(N) < 0.95
    elif case == "long_runs_one_tile":
        N, n_seg = 50_000, 20_000  # eleven long runs in tile 0, the rest spread
        segs = rng.integers(0, n_seg, N).astype(np.int32)
        hot = rng.random(N) < 0.3
        segs[hot] = rng.integers(0, 11, int(hot.sum())) * 37
        mask = rng.random(N) < 0.9
    elif case == "many_hot_runs":
        # 30 runs of 3,000-12,000 lanes, some covering an aligned 4,096-lane
        # window of the stream and some not, more than the hot blocks
        n_seg = 3000
        lens = rng.integers(3000, 12_000, 30)
        segs = np.concatenate([np.full(n, 7 + 97 * i, np.int32) for i, n in enumerate(lens)])
        segs = np.concatenate([segs, rng.integers(0, n_seg, 20_000).astype(np.int32)])
        N = segs.shape[0]
        mask = rng.random(N) < 0.99
    else:  # runs of every length around the front warps' threshold
        N, n_seg = 40_000, 1500
        segs = np.repeat(np.arange(n_seg, dtype=np.int32), rng.integers(0, 60, n_seg))[:N]
        N = segs.shape[0]
        mask = rng.random(N) < 0.97
    vals = (rng.standard_normal(N) * 10).astype(np.float32)
    return vals, segs, mask, n_seg


@pytest.mark.parametrize("case", ["one_segment_unaligned", "hot_last_tile",
                                  "long_runs_one_tile", "many_hot_runs", "runs_near_threshold"])
@pytest.mark.parametrize("op", ["sum", "count", "max", "min"])
def test_segment_reduce_kernel_edges(dev, case, op):
    """Long runs (folded by the front warps) and short ones: every op bitwise
    against the CPU plain version, with and without init, and the same bits
    from a second launch and from a stream whose buffers are not 16-byte
    aligned (the kernel's scalar loads)."""
    rng = np.random.default_rng(len(case) + len(op))
    vals, segs, mask, n_seg = _segment_edge_case(case, rng)
    init = (rng.standard_normal(n_seg) * 10).astype(np.float32)
    t = [torch.from_numpy(a) for a in (vals, segs, mask)]
    d = [x.to(dev) for x in t]
    sseg, sval, edges = segment_reduce.sort_lanes(*d, n_seg)
    N = sseg.shape[0]
    off_seg = torch.empty(N + 1, dtype=torch.int32, device=dev)[1:]
    off_val = torch.empty(N + 1, dtype=torch.float32, device=dev)[1:]
    off_seg.copy_(sseg)
    off_val.copy_(sval)
    for it in (None, torch.from_numpy(init)):
        want = ref.segment_reduce_ref(*t, n_seg, op=op, init=it)
        itd = None if it is None else it.to(dev)
        _same_bits_twice(lambda: segment_reduce.segment_reduce(*d, n_seg, op=op, init=itd), want)
        _same_bits_twice(lambda: segment_reduce.reduce_sorted(off_seg, off_val, edges, n_seg,
                                                              op=op, init=itd), want)


def test_segment_reduce_completes_before_the_next_op(dev):
    """What follows a launch on the stream sees every segment, the hot run's
    too, although that run's chain of some 3.7 million adds outlasts the
    state copy many times over: the launch's kernels complete together.
    Each launch writes a fresh buffer, read by a copy enqueued right after
    it with no synchronisation between."""
    rng = np.random.default_rng(23)
    N, n_seg = 1 << 22, 1 << 20
    segs = np.full(N, 777_777, np.int32)
    segs[: N // 8] = rng.integers(0, n_seg, N // 8)
    vals = rng.standard_normal(N).astype(np.float32)
    mask = np.ones(N, bool)
    init = rng.standard_normal(n_seg).astype(np.float32)
    t = [torch.from_numpy(a) for a in (vals, segs, mask)]
    want = ref.segment_reduce_ref(*t, n_seg, op="sum", init=torch.from_numpy(init))
    srt = segment_reduce.sort_lanes(*(x.to(dev) for x in t), n_seg)
    itd = torch.from_numpy(init).to(dev)
    torch.cuda.synchronize()
    outs, seen = [], []
    for _ in range(3):
        outs.append(segment_reduce.reduce_sorted(*srt, n_seg, op="sum", init=itd))
        seen.append(outs[-1].clone())
    for s in seen:
        np.testing.assert_array_equal(s.cpu(), want)


# ---------------------------------------------------------------------------
# the fused merge side of a delta-sync round, and the gated keyed exchange
# ---------------------------------------------------------------------------

MERGE_FIELDS = {  # (dtype, join, trailing shape) per window field
    "f32 max": [(torch.float32, "max", (16,))],
    "f32 max x2, q4": [(torch.float32, "max", (16, 5)), (torch.float32, "max", (16, 5))],
    "f32 max, q5": [(torch.float32, "max", (16, 64))],
    "pncounter": [(torch.float32, "max", (16, 3)), (torch.float32, "max", (16, 3))],
    "f32 min": [(torch.float32, "min", (7,))],
    "i32 max / min": [(torch.int32, "max", (33,)), (torch.int32, "min", (65,))],
    "u8 or / max / min": [(torch.uint8, "or", (5,)), (torch.uint8, "max", (200,)),
                          (torch.uint8, "min", (1,))],
    "mixed": [(torch.float32, "max", (129,)), (torch.int32, "min", (2,)),
              (torch.uint8, "or", (64,)), (torch.float32, "min", (3, 11))],
}


def _merge_case(rng, S, R, Wn, fields, edge):
    state_wid = rng.integers(-1, 6, (S, Wn)).astype(np.int32)
    stack_wid = rng.integers(-1, 6, (R, Wn)).astype(np.int32)
    state_wid[:, 0] = stack_wid[:, 0] = -1  # clean everywhere: both -1
    stack_wid[:, 1] = -1  # clean on every delta replica
    state_wid[:, 2] = 9  # the state newer than the merged delta
    state_wid[:, 3] = stack_wid[:, 3] = 4  # equal wids everywhere
    if edge == "all_clean":
        stack_wid[:] = -1
    elif edge == "state_newer":
        state_wid[:] = 9
    elif edge == "equal_wids":
        state_wid[:] = stack_wid[:] = 2
    sl, kl, joins = [], [], []
    for dt, op, rest in fields:
        for lead, out in ((S, sl), (R, kl)):
            if dt == torch.uint8:
                x = torch.from_numpy(rng.integers(0, 256, (lead, Wn, *rest)).astype(np.uint8))
            else:
                x = torch.from_numpy(rng.standard_normal((lead, Wn, *rest)) * 50).to(dt)
            out.append(x)
        joins.append(op)
    P = 16
    sm = [torch.from_numpy(rng.integers(-5, 50, (S, n)).astype(np.int32)) for n in (P, P, 3)]
    km = [torch.from_numpy(rng.integers(-5, 50, (R, n)).astype(np.int32)) for n in (P, P, 3)]
    return (torch.from_numpy(state_wid), torch.from_numpy(stack_wid), sl, kl, joins, sm, km)


def _to(x, dev):
    return [_to(v, dev) for v in x] if isinstance(x, list) else (
        x.to(dev) if torch.is_tensor(x) else x)


@pytest.mark.parametrize("edge", ["mixed", "all_clean", "state_newer", "equal_wids"])
@pytest.mark.parametrize("S,R,Wn", [(16, 16, 64), (16, 1, 64), (3, 5, 7)])
@pytest.mark.parametrize("fields", list(MERGE_FIELDS))
def test_delta_merge_join_kernel_matches_plain(dev, fields, S, R, Wn, edge):
    """One launch over every field of a spec (mixed dtypes in one launch
    included) is bitwise its plain version: the new tenants, every leaf and
    the metadata, with each slot edge in every case."""
    rng = np.random.default_rng(S * 7 + R + Wn + len(fields) + len(edge))
    args = _merge_case(rng, S, R, Wn, MERGE_FIELDS[fields], edge)
    before = ops.KERNELS["delta_merge_join"].launches
    got = ops.delta_merge_join(*_to(list(args), dev))
    assert ops.KERNELS["delta_merge_join"].launches == before + 1
    want = ref.delta_merge_join_ref(*args)
    np.testing.assert_array_equal(got[0].cpu(), want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.cpu(), w)


def test_delta_merge_join_wide_field(dev):
    """q5's shape at 10,000 auctions: one field of 160,000 features."""
    rng = np.random.default_rng(31)
    args = _merge_case(rng, 16, 16, 64, [(torch.float32, "max", (16, 10_000))], "mixed")
    got = ops.delta_merge_join(*_to(list(args), dev))
    want = ref.delta_merge_join_ref(*args)
    for g, w in zip([got[0]] + got[1] + got[2], [want[0]] + want[1] + want[2]):
        np.testing.assert_array_equal(g.cpu(), w)


def test_q4_sync_merge_side_is_one_launch(dev):
    """One sync round of each q4 spec: the merge side (``join_delta_stack``)
    is exactly one device kernel, the fused launch, and neither standalone
    join runs; the new state equals the CPU run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import wstate_to_numpy
    from repro_torch.core import wcrdt as W
    from repro_torch.core.lattice import map_tensors
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    S = 4
    q = MAKERS["q4"](S, window_len=100, num_slots=16)
    log = generate_log(NexmarkConfig(num_partitions=S, num_batches=4, events_per_batch=256), dev)
    mesh = make_data_mesh(S, dev)
    part = torch.arange(S, device=dev)
    shared, local = q.init_shared(dev), q.init_local(dev)
    for i in range(4):
        shared, local = q.fold(shared, local, log.batch(i), part, batch_idx=i)
    torch.cuda.synchronize()
    for spec, st in zip(q.shared_specs, shared):
        delta = W.delta_since(spec, st, *W.zero_baseline(spec, S, dev))
        assert bool((delta.slot_wid >= 0).any())
        torch.cuda.synchronize()  # the profile sees only the merge side's kernels
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = W.join_delta_stack(spec, st, mesh.all_gather(delta))
            torch.cuda.synchronize()
        counts = {n: k.launches - before[n] for n, k in ops.KERNELS.items()}
        assert counts == {n: int(n == "delta_merge_join") for n in counts}, counts
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]
        host = lambda x: x.cpu()  # noqa: E731
        want = wstate_to_numpy(W.join_delta_stack(spec, map_tensors(host, st),
                                                  map_tensors(host, delta)))
        for k, v in wstate_to_numpy(got).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("on", [True, False, None])
@pytest.mark.parametrize("R,F,dtype", [(16, 16, torch.int32), (1, 5, torch.int32),
                                       (3, 1000, torch.float32), (16, 300, torch.uint8)])
def test_crdt_merge_rows_gated_is_torch_where(dev, on, R, F, dtype):
    """The keyed exchange's mode: the join written to every row, gated by a
    device bool, bitwise ``torch.where`` of the plain join; one launch."""
    rng = np.random.default_rng(R + F)
    x = torch.from_numpy(rng.integers(-1000, 1000, (R, F))).to(dtype)
    where = None if on is None else torch.tensor(on)
    before = ops.KERNELS["crdt_merge"].launches
    got = ops.crdt_merge(x.to(dev), "max", rows=True, where=_to(where, dev))
    assert ops.KERNELS["crdt_merge"].launches == before + 1
    joined = ref.crdt_merge_ref(x, "max").expand_as(x)
    want = joined if on is None else torch.where(where, joined, x)
    assert got.shape == (R, F) and got.dtype == dtype
    np.testing.assert_array_equal(got.cpu(), want)
