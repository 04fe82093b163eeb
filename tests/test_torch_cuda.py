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
    ops.actor_sum(torch.zeros((S, 3, 4), device=dev))
    meta = torch.zeros((S, 2), dtype=torch.int32, device=dev)
    ops.ring_insert(slots, mask, 0, 1, wid, meta, meta, torch.zeros((S, 3), dtype=torch.int32,
                    device=dev), [torch.zeros((S, W, 3), device=dev)], [0.0], 10, 10)
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


@pytest.mark.parametrize("qname", ["q1_ratio", "q4", "q5"])
def test_delta_merge_join_state_rows_fewer_than_stack(dev, qname):
    """A rank's merge side across processes: its 4 state rows against the
    16-row gathered delta stack, at every spec of the query, is one launch
    and bitwise the plain version on the CPU."""
    from repro_torch.convert import wstate_to_numpy
    from repro_torch.core import wcrdt as W
    from repro_torch.core.lattice import map_tensors
    from repro_torch.launch.stream import MAKERS
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    S, L = 16, 4
    q = MAKERS[qname](S, window_len=100, num_slots=16)
    log = generate_log(NexmarkConfig(num_partitions=S, num_batches=4, events_per_batch=256), dev)
    part = torch.arange(S, device=dev)
    shared, local = q.init_shared(dev), q.init_local(dev)
    for i in range(4):
        shared, local = q.fold(shared, local, log.batch(i), part, batch_idx=i)
    host = lambda x: x.cpu()  # noqa: E731
    for spec, st in zip(q.shared_specs, shared):
        delta = W.delta_since(spec, st, *W.zero_baseline(spec, S, dev))
        assert bool((delta.slot_wid >= 0).any())
        mine = map_tensors(lambda x: x[L:2 * L].contiguous(), st)  # rank 1's rows
        before = ops.KERNELS["delta_merge_join"].launches
        got = W.join_delta_stack(spec, mine, delta)
        assert ops.KERNELS["delta_merge_join"].launches == before + 1
        assert got.slot_wid.shape[0] == L
        want = wstate_to_numpy(W.join_delta_stack(spec, map_tensors(host, mine),
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


@pytest.mark.parametrize("qname", ["q4", "q7"])
def test_runtime_on_card_matches_cpu(dev, qname):
    """The discrete-event runtime at ``tests/test_exactly_once.py``'s SMALL
    size, tracing on: the card's JSONL trace is byte for byte the CPU run's
    (simulated time does not depend on the device, and the fold, merge and
    read give the same bits), and the card run went through the kernels."""
    from repro_torch.runtime import HolonHarness, SimConfig
    from repro_torch.streaming.queries import make_q4, make_q7

    cfg = SimConfig(num_nodes=3, num_partitions=6, num_batches=60, events_per_batch=512,
                    rate_per_partition=10_000.0, window_len=500, num_slots=32,
                    ckpt_interval_ms=300.0, sync_interval_ms=50.0, obs=True)
    make = {"q4": make_q4, "q7": make_q7}[qname]
    q = make(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)
    traces = []
    for d in ("cpu", dev):
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        h = HolonHarness(cfg, q, device=d)
        h.run()
        traces.append(h.obs.export_jsonl())
        launched = {n for n, k in ops.KERNELS.items() if k.launches > before[n]}
    assert traces[0] == traces[1]
    assert launched == ({"topk_window"} if qname == "q7"
                        else {"window_agg", "delta_merge_join", "actor_sum"})


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("S", [1, 16])
def test_window_agg_one_lane_a_replica(dev, op, S):
    """The training-metrics fold's shape: one lane a replica (``L = 1``,
    ``C = 1``) folded into a non-empty state, against the plain version on
    the card and on the CPU, bitwise (one addend a cell: no order)."""
    rng = np.random.default_rng(S * 7 + len(op))
    W = 8
    vals = torch.from_numpy((rng.random((S, 1)) * 4 + 1).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, W, (S, 1)).astype(np.int32))
    mask = torch.ones((S, 1), dtype=torch.bool)
    if S > 1:
        mask[S // 2] = False  # one replica's lane masked
    # a non-empty state below every lane, so that max changes it too
    init = torch.from_numpy(rng.random((S, W, 1)).astype(np.float32))
    args = [t.to(dev) for t in (vals, slots, mask)]
    got = window_agg.window_agg(*args, W, op=op, init=init.to(dev))
    want = ref.window_agg_ref(*args, W, op=op, init=init.to(dev))
    cpu = ref.window_agg_ref(vals, slots, mask, W, op=op, init=init)
    np.testing.assert_array_equal(got.cpu(), want.cpu())
    np.testing.assert_array_equal(got.cpu(), cpu)
    assert not torch.equal(cpu, init)


def test_metrics_fold_on_card_matches_cpu(dev):
    """The training-metrics lattice folded on the card, one worker at a time
    and stacked, equals the CPU's bitwise, one launch a counter a fold."""
    from repro_torch.convert import wstate_to_numpy
    from repro_torch.training import MetricSpec, metrics_fold, metrics_init

    spec = MetricSpec(num_workers=4, window_len=5, num_slots=8)
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(a.astype(np.float32)) for a in
         (rng.random((23, 4)) * 3, rng.integers(1, 900, (23, 4)), rng.random((23, 4)))]
    states = []
    for d in ("cpu", dev):
        before = ops.KERNELS["window_agg"].launches
        one = metrics_init(spec, d)
        stacked = metrics_init(spec, d, replicas=4)
        xd = [a.to(d) for a in x]
        for t in range(23):
            one = metrics_fold(spec, one, t % 4, t, *(a[t, t % 4] for a in xd))
            stacked = metrics_fold(spec, stacked, torch.arange(4, device=d), t, *(a[t] for a in xd))
        if d == dev:
            assert ops.KERNELS["window_agg"].launches - before == 2 * 23 * 3
        states.append({f"{n}.{k}.{f}": a for n, st in (("one", one), ("stacked", stacked))
                       for k, s in st.items() for f, a in wstate_to_numpy(s).items()})
    for k, a in states[0].items():
        np.testing.assert_array_equal(states[1][k], a, err_msg=k)


@pytest.mark.parametrize("P", [1, 4, 16])
@pytest.mark.parametrize("key", [(), (5,), (3, 7), (2049,)])
def test_actor_sum_kernel_matches_plain(dev, P, key):
    """The left fold over actor rows, bitwise against its plain version on
    the card and on the CPU, for contiguous rows and for one ring slot of a
    ``[S, W, P, *key]`` counter (rows strided over S and P)."""
    rng = np.random.default_rng(P * 31 + len(key))
    S, W = 3, 4
    x = rng.standard_normal((S, W, P, *key)) * np.exp(rng.uniform(-6, 6, (S, W, P, *key)))
    x = torch.from_numpy(x.astype(np.float32))
    before = ops.KERNELS["actor_sum"].launches
    for rows in (x[:, 1].contiguous(), x[:, 2]):
        got = ops.actor_sum(rows.to(dev))
        want = ref.actor_sum_ref(rows.to(dev))
        torch.cuda.synchronize()
        assert got.shape == (S, *key)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      want.cpu().numpy().view(np.uint32))
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      ref.actor_sum_ref(rows).numpy().view(np.uint32))
    assert ops.KERNELS["actor_sum"].launches - before == 2


def test_pow_f32_on_card_equals_cpu(dev):
    """glibc's powf in torch ops gives the same bits on the card: random
    f32 bit patterns at several powers, and the generator's zipf domain."""
    from repro_torch.streaming import prng

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
                         .view(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, 1 << 20).astype(np.float32))
    for base, e in ((x, -10.0), (x, 0.7), (x, 3.0), (u * 0.5 + 1.0, -10.0),
                    (u * np.float32((1e6 + 1) ** -0.1 - 1) + 1.0, 1.0 / (1.0 - 1.1))):
        got = prng.pow_f32(base.to(dev), e).cpu()
        want = prng.pow_f32(base, e)
        same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
        assert bool(same.all()), e
    t = torch.arange(1, 200, dtype=torch.float32)
    np.testing.assert_array_equal(prng.pow_f32(0.95, t.to(dev)).cpu().numpy(),
                                  prng.pow_f32(0.95, t).numpy())


def _train_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("minitron_4b").reduced(), n_kv_heads=2, n_layers=2)


def test_train_step_on_card_matches_cpu(dev):
    """One train step on the card against the CPU's, f32 with TF32 off:
    the same parameters (drawn on each device, bitwise), loss and grad norm
    to rtol 1e-5, moments to 1e-4 of each leaf's largest magnitude
    (tests/test_torch_train.py's tolerances).  Updated parameters to 0.05
    lr where the gradient is above 1e-3 of its leaf's largest: a first
    AdamW step moves a lane by lr g / (|g| + eps), whose direction the two
    devices' products decide alike only where g stands above their
    rounding; elsewhere a lane steps by at most lr (1 + wd |p|) either way,
    so the two differ by at most 2.2 lr there."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves
    from repro_torch.streaming import prng
    from repro_torch.training import adamw_init, make_train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, lr = _train_cfg(), 1e-3
    out = {}
    for d in ("cpu", dev):
        p = init_params(cfg, prng.prng_key(0, d), dtype=torch.float32)
        if d == "cpu":
            p0 = p
        else:
            for a, b in zip(tree_leaves(p), tree_leaves(p0)):
                assert torch.equal(a.cpu(), b)
        step = make_train_step(cfg, q_chunk=32, lr=lr)
        out[str(d)] = step(p, adamw_init(p), synthetic_batch(0, 0, 2, 64, cfg.vocab, d))
    (pc, oc, sc), (pg, og, sg) = out["cpu"], out[str(dev)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(sg[k]), float(sc[k]), rtol=1e-5, err_msg=k)
    for kind, a_, b_ in (("mu", og.mu, oc.mu), ("nu", og.nu, oc.nu)):
        for a, b in zip(tree_leaves(a_), tree_leaves(b_)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()), err_msg=kind)
    for a, b, m in zip(tree_leaves(pg), tree_leaves(pc), tree_leaves(oc.mu)):
        a, sure = a.cpu(), m.abs() > 1e-3 * m.abs().max()
        assert bool(sure.any())
        np.testing.assert_allclose(a[sure].numpy(), b[sure].numpy(), rtol=0, atol=0.05 * lr)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2.2 * lr)


def test_crash_and_restore_on_card_is_bitwise(dev, tmp_path):
    """Six steps on the card uncrashed, and three, a checkpoint through the
    LocalStore, a restore and three more: the same parameters and moments
    bit for bit (every op of a step is deterministic on the card)."""
    from repro_torch.convert import adamw_from_numpy, params_from_numpy
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves
    from repro_torch.streaming import prng
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.checkpoint import LocalStore, TrainCheckpoint

    cfg = _train_cfg()
    step = make_train_step(cfg, q_chunk=32)
    batch = lambda s: synthetic_batch(0, s, 2, 64, cfg.vocab, dev)
    p0 = init_params(cfg, prng.prng_key(0, dev), dtype=torch.float32)
    p1, o1 = p0, adamw_init(p0)
    for s in range(6):
        p1, o1, _ = step(p1, o1, batch(s))
    p2, o2 = p0, adamw_init(p0)
    for s in range(3):
        p2, o2, _ = step(p2, o2, batch(s))
    store = LocalStore(tmp_path)
    store.put("w0", TrainCheckpoint(step=3, data_idx=3, params=p2, opt=o2, metrics={},
                                    rng_seed=0))
    ck = store.get("w0")
    p3, o3 = params_from_numpy(ck.params, dev), adamw_from_numpy(ck.opt, dev)
    for s in range(3, 6):
        p3, o3, _ = step(p3, o3, batch(s))
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu),
                    tree_leaves(p3) + tree_leaves(o3.mu) + tree_leaves(o3.nu)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the moe, ssm, hybrid and audio families' training path on the card
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["llama4_scout_17b_a16e", "qwen3_moe_235b_a22b", "falcon_mamba_7b", "zamba2_7b",
                "seamless_m4t_large_v2"]


def _family_step(cfg, d, lr):
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.streaming import prng
    from repro_torch.training import adamw_init, make_train_step

    batch = synthetic_batch(0, 0, 2, 64, cfg.vocab, d)
    if cfg.family == "audio":
        g = torch.Generator().manual_seed(0)
        batch["enc_embeds"] = torch.randn((2, 64, cfg.d_model), generator=g).to(d)
    p = init_params(cfg, prng.prng_key(0, d), dtype=torch.float32)
    step = make_train_step(cfg, q_chunk=32, ssm_chunk=16, lr=lr)
    return p, step, batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_card_matches_cpu(dev, arch):
    """A reduced step of each new family on the card against the CPU's,
    f32 with TF32 off, at tests/test_torch_families_step.py's tolerances:
    parameters drawn bitwise, loss to rtol 1e-5, grad norm 1e-5 (5e-5 for
    the hybrid), moments to 1e-4 of each leaf's largest (at least 1e-8 of
    the tree's), parameters to 0.05 lr where the first moment stands above
    1e-3 of its leaf's largest and 2.2 lr elsewhere."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import adamw_init

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, lr = get_config(arch).reduced(), 1e-3
    out = {}
    for d in ("cpu", dev):
        p, step, batch = _family_step(cfg, d, lr)
        out[str(d)] = (p, *step(p, adamw_init(p), batch))
    (p0c, pc, oc, sc), (p0g, pg, og, sg) = out["cpu"], out[str(dev)]
    for a, b in zip(tree_leaves(p0g), tree_leaves(p0c)):
        assert torch.equal(a.cpu(), b)
    np.testing.assert_allclose(float(sg["loss"]), float(sc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(sg["grad_norm"]), float(sc["grad_norm"]),
                               rtol=5e-5 if cfg.family == "hybrid" else 1e-5)
    for kind, a_, b_ in (("mu", og.mu, oc.mu), ("nu", og.nu, oc.nu)):
        top = max(float(b.abs().max()) for b in tree_leaves(b_))
        for a, b in zip(tree_leaves(a_), tree_leaves(b_)):
            atol = 1e-4 * max(float(b.abs().max()), 1e-4 * top)
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=atol,
                                       err_msg=kind)
    for a, b, m in zip(tree_leaves(pg), tree_leaves(pc), tree_leaves(oc.mu)):
        a, sure = a.cpu(), m.abs() > 1e-3 * m.abs().max()
        np.testing.assert_allclose(a[sure].numpy(), b[sure].numpy(), rtol=0, atol=0.05 * lr)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2.2 * lr)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_repeats_bitwise_on_card(dev, arch):
    """Two steps on the card from the same state give the same parameters
    and moments bit for bit: no step of the scan, the MoE dispatch and
    combine or cross-attention adds by atomics."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import adamw_init

    cfg = get_config(arch).reduced()
    p, step, batch = _family_step(cfg, dev, 1e-3)
    (p1, o1, _), (p2, o2, _) = (step(p, adamw_init(p), batch) for _ in range(2))
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu),
                    tree_leaves(p2) + tree_leaves(o2.mu) + tree_leaves(o2.nu)):
        assert torch.equal(a, b)


def test_moe_gather_rows_backward_is_bitwise_on_card(dev):
    """The MoE layer's gather function on the card: its values equal the
    CPU's, and two backward runs give the same gradients bit for bit (the
    backward gathers through the inverse map and adds a row's terms in
    slot order)."""
    from repro_torch.models import moe
    from repro_torch.streaming import prng

    dims = moe.MoEDims(d_model=64, n_experts=16, top_k=4, d_ff=32, shared_expert=True,
                       shared_d_ff=48)
    p = moe.init_moe(prng.prng_key(0, dev), dims, torch.float32)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 512, 64), generator=g).to(dev)
    gy = torch.randn((2, 512, 64), generator=g).to(dev)
    grads = []
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items() if k != "shared"}
        xr = x.clone().requires_grad_(True)
        moe.moe_ffn(dict(leaves, shared=p["shared"]), dims, xr).backward(gy)
        grads.append([xr.grad] + [leaves[k].grad for k in sorted(leaves)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    r = moe.route(torch.softmax(x.reshape(-1, 64) @ p["router"], -1), dims,
                  moe.capacity(dims, 1024))
    src = torch.randn((1024, 8), generator=g).to(dev)
    out = moe.gather_rows(src, r["tok_of_slot"], r["slot_of_token"])
    torch.testing.assert_close(out.cpu(), torch.cat([src, src[:1] * 0])[r["tok_of_slot"]].cpu(),
                               rtol=0, atol=0)


# one architecture of each family, served at reduced(): prefill, then decode
SERVE_ARCHS = ["minitron_4b", "pixtral_12b", "llama4_scout_17b_a16e", "falcon_mamba_7b",
               "zamba2_7b", "seamless_m4t_large_v2"]


def _serve_run(cfg, dev, steps=4):
    """Parameters drawn on ``dev`` from seed 0, a prefill of 2 x 32 tokens
    (4 stub patch embeddings before them for vlm, 32 frames for audio),
    its cache grown to hold ``steps`` more, then ``steps`` decode steps of
    the next prompt tokens.  Returns the parameters, every step's logits
    and the final cache."""
    from repro_torch.models import lm
    from repro_torch.streaming import prng

    p = lm.init_params(cfg, prng.prng_key(0, dev), dtype=torch.float32)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32 + steps))).to(dev)
    P = 4 if cfg.family == "vlm" else 0
    extra = torch.from_numpy(rng.standard_normal((2, 32 if cfg.is_enc_dec else P, cfg.d_model))
                             .astype(np.float32)).to(dev)
    enc_kv = None
    if cfg.is_enc_dec:
        logits, cache, enc_kv = lm.prefill_encdec(cfg, p, extra, toks[:, :32], q_chunk=16)
    else:
        logits, cache = lm.prefill(cfg, p, toks[:, :32], prefix_embeds=extra if P else None,
                                   q_chunk=16, ssm_chunk=8)
    cache = lm.pad_cache(cache, P + 32 + steps)
    out = [logits]
    for i in range(steps):
        lg, cache = lm.decode_step(cfg, p, cache, toks[:, 32 + i:33 + i], P + 32 + i,
                                   enc_kv=enc_kv)
        out.append(lg)
    return p, out, cache


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_on_card_matches_cpu(dev, arch):
    """Prefill and 4 decode steps at ``reduced()`` in f32 (TF32 off), card
    against CPU: parameters bitwise, every step's logits and every cache
    leaf to tests/test_torch_serve_families.py's tolerances (1e-5 of the
    largest magnitude; 1e-4 for the hybrid's scan)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    tol = 1e-4 if cfg.family == "hybrid" else 1e-5
    (pc, lc, cc), (pg, lg, cg) = (_serve_run(cfg, d) for d in ("cpu", dev))
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(lg + tree_leaves(cg), lc + tree_leaves(cc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=tol * float(b.abs().max()))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_repeats_bitwise_on_card(dev, arch):
    """A prefill and 4 decode steps on the card, twice: every logit and
    every cache leaf bit for bit (the cache is written by ``index_copy_``
    and ``copy_``, the MoE combine is a gather: no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves

    cfg = get_config(arch).reduced()
    (_, l1, c1), (_, l2, c2) = (_serve_run(cfg, dev) for _ in range(2))
    for a, b in zip(l1 + tree_leaves(c1), l2 + tree_leaves(c2)):
        assert torch.equal(a, b)


RING_SHAPES = {  # S, B, K, W, P, leaf shapes after [S, W], fills
    "q5_dense": (16, 16384, 2, 64, 16, [(16, 10000)], [0.0]),
    "odd_k3": (3, 1000, 3, 7, 5, [(3,)], [float("-inf")]),
    "two_leaves": (5, 4099, 2, 13, 2, [(2, 7), (2, 7)], [0.0, 0.0]),
    "one_lane": (1, 1, 1, 5, 1, [()], [float("inf")]),
    "no_lanes": (2, 0, 2, 4, 3, [(1, 6)], [0.0]),
    # clusters of 3 blocks with a ragged last share, and of 8 over the
    # largest ring: the slot max joined across blocks
    "cluster_3": (7, 5000, 2, 64, 16, [(16, 3)], [0.0]),
    "cluster_8_wide": (4, 40000, 1, 1024, 4, [(5,)], [float("-inf")]),
}


def _ring_inputs(rng, S, B, K, W, P, rests, idx):
    hop, base = 10, 100  # the batch's windows lie around window ``base``
    wid = base - W + rng.integers(0, W + 3, (S, W))
    wid = wid - (wid - np.arange(W)) % W  # a tenant sits in its own slot
    # empty slots hold -1, as in every state
    wid = np.where((rng.random((S, W)) < 0.2) | (wid < 0), -1, wid).astype(np.int32)
    ts = (base * hop + rng.integers(-4 * hop, 3 * hop, (S, B))).astype(np.int32)
    progress = (base * hop + rng.integers(-6 * hop, hop, (S, P))).astype(np.int32)
    folded = rng.integers(0, 20, (S, P)).astype(np.int32)
    T = torch.from_numpy
    args = dict(ts=T(ts), mask=T(rng.random((S, B)) < 0.8), slot_wid=T(wid),
                progress=T(progress), folded=T(folded),
                errors=T(rng.integers(0, 9, (S, 3)).astype(np.int32)))
    if idx == "tensors":
        args.update(part=T(rng.integers(0, P, S)), bidx=T(rng.integers(5, 25, S)))
    else:
        args.update(part=P - 1, bidx=None if idx == "ungated" else 12)
    leaves = [T((rng.standard_normal((S, W, *r)) * 10).astype(np.float32)) for r in rests]
    return args, leaves, hop, hop * K


@pytest.mark.parametrize("idx", ["tensors", "ints", "ungated"])
@pytest.mark.parametrize("shape", list(RING_SHAPES))
def test_ring_insert_kernel_matches_plain(dev, shape, idx):
    """The one-launch ring bookkeeping against its plain version, bitwise on
    every output and on the leaves it resets in place; at q5's dense shape
    some slots advance."""
    from repro_torch.kernels import ring_insert

    S, B, K, W, P, rests, fills = RING_SHAPES[shape]
    rng = np.random.default_rng(len(shape) * 3 + len(idx))
    args, leaves, hop, wl = _ring_inputs(rng, S, B, K, W, P, rests, idx)
    on = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    mine, theirs = [x.to(dev) for x in leaves], [x.to(dev) for x in leaves]
    before = ops.KERNELS["ring_insert"].launches
    got = ring_insert.ring_insert(leaves=mine, fills=fills, hop=hop, window_len=wl, **on)
    ref_args = dict(on)
    for k in ("part", "bidx"):
        if ref_args[k] is not None and not isinstance(ref_args[k], torch.Tensor):
            ref_args[k] = torch.full((S,), ref_args[k], dtype=torch.int64, device=dev)
    want = ref.ring_insert_ref(leaves=theirs, fills=fills, hop=hop, window_len=wl, **ref_args)
    torch.cuda.synchronize()
    assert ops.KERNELS["ring_insert"].launches == before + 1
    for name, g, w in zip(("slot", "valid", "slot_wid", "folded", "errors"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(), err_msg=name)
    for g, w in zip(mine, theirs):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(), err_msg="leaf")
    for k in ("slot_wid", "progress", "folded", "errors", "ts", "mask"):
        np.testing.assert_array_equal(on[k].cpu().numpy(), args[k].numpy(), err_msg=k)
    if shape == "q5_dense":
        assert bool((want[2] > on["slot_wid"]).any()) and int(want[1].sum()) > 0


@pytest.mark.parametrize("qname", ["q0", "q1_ratio", "q4", "q5"])
def test_pipeline_owned_insert_matches_functional_on_card(dev, qname, monkeypatch):
    """A whole ``build_pipeline`` pass on the card, its fold steps on
    ``insert(owned=True)`` (one ring launch a counter spec a step), gives
    the outputs of the same pass on the functional ``insert``, bitwise, with
    no synchronising call."""
    import warnings

    from repro_torch.core import wcrdt as W
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline, read_window_range
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    S, nb = 16, 16
    nx = NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=2048)
    log = generate_log(nx, dev)
    kw = {"num_auctions": 10_000} if qname == "q5" else {}
    q = MAKERS[qname](S, window_len=100, num_slots=64, **kw)
    first, n = read_window_range(q, nb * nx.batch_span_ms)
    pipe = build_pipeline(q, make_data_mesh(S, dev), 4, n_windows=n, first_window=first)
    pipe(log)  # warm-up
    torch.cuda.synchronize()
    before = ops.KERNELS["ring_insert"].launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = pipe(log)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    got = [t.cpu() for t in got]
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    specs = len(q.shared_specs) + (q.local_spec is not None)
    assert ops.KERNELS["ring_insert"].launches - before == nb * specs
    functional = W.insert
    monkeypatch.setattr(W, "insert", lambda *a, owned=False, **k: functional(*a, **k))
    want = [t.cpu() for t in pipe(log)]
    assert got[0].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert syncs == [], [str(w.message)[:160] for w in syncs]


# q5's fold step at the dense cell's shape on the card: 46.6 device events a
# step measured (H100, torch 2.11), with a margin of 1.4
Q5_DEVICE_EVENTS_PER_STEP = 48


def test_q5_fold_step_device_events_stay_bounded(dev):
    """q5's dense fold step as ``build_pipeline`` runs it (``query.fold`` of
    the batch's views on the dataplane's own states): the device events it
    enqueues a step stay under a ceiling."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.stream import MAKERS
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    S, nb = 16, 6
    log = generate_log(NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=16384),
                       dev)
    q = MAKERS["q5"](S, window_len=10_000, num_slots=64, num_auctions=10_000)
    part = torch.arange(S, device=dev)
    shared, local = q.init_shared(dev), q.init_local(dev)
    batch = lambda i: log.map(lambda x: x[:, i])  # noqa: E731  the views build_pipeline folds
    shared, local = q.fold(shared, local, batch(0), part, batch_idx=0, owned=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(1, nb):
            shared, local = q.fold(shared, local, batch(i), part, batch_idx=i, owned=True)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_step = len(events) / (nb - 1)
    print(f"q5 dense fold step: {per_step} device events a step")
    assert per_step <= Q5_DEVICE_EVENTS_PER_STEP, sorted({e.name[:80] for e in events})
