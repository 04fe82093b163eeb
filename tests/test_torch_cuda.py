"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips itself when no card is present, so they
count only where one is.  Run them on a machine with an H100 and nvcc:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import crdt_merge, ops, ref, topk_window, window_agg

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
    for n, k in ops.KERNELS.items():
        assert k.launches == before[n] + 1, n


@pytest.mark.parametrize("qname", ["q0", "q1_ratio", "q4", "q5", "q7"])
def test_pipeline_on_card_matches_cpu(dev, qname):
    """The dataplane on the card gives the CPU run's outputs: bitwise, but
    q4's float price sums, which the two fold in another grouping (rtol
    1e-5)."""
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
    if qname == "q4":
        np.testing.assert_allclose(vg, vc, rtol=1e-5)
    else:
        np.testing.assert_array_equal(vg, vc)
