"""``wcrdt.insert(owned=True)`` against ``wcrdt.insert`` on the CPU (the
ring bookkeeping's plain version), bitwise on every field of the state, step by
step over batches that replay, arrive late, advance slots and evict windows
before they complete; and ``insert`` left functional."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import wstate_to_numpy
from repro_torch.core import wcrdt as W
from repro_torch.core.lattice import map_fields
from repro_torch.core.window import as_assigner

S, P, B, SLOTS, WL, C = 3, 3, 40, 4, 10, 5

SPECS = {
    "gcounter_keyed": lambda a: W.wgcounter(WL, SLOTS, P, key_shape=(C,), assigner=a),
    "pncounter": lambda a: W.wpncounter(WL, SLOTS, P, assigner=a),
    "maxreg": lambda a: W.wmaxreg(WL, SLOTS, P, key_shape=(C,), assigner=a),
    "minreg": lambda a: W.wminreg(WL, SLOTS, P, key_shape=(C,), assigner=a),
}


def _inputs(name, rng, part):
    v = torch.from_numpy((rng.standard_normal((S, B)) * 10).astype(np.float32))
    keys = torch.from_numpy(rng.integers(0, C, (S, B)).astype(np.int32))
    if name == "gcounter_keyed":
        return dict(actor=part, amounts=v.abs(), keys=keys)
    if name == "pncounter":
        return dict(actor=part, amounts=v)
    return dict(vals=v, keys=keys)


def _snapshot(st):
    return {k: v.copy() for k, v in wstate_to_numpy(st).items()}


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _count_launches(monkeypatch):
    calls = []
    launch = W.ops.ring_insert

    def counted(*a, **kw):
        calls.append(1)
        return launch(*a, **kw)

    monkeypatch.setattr(W.ops, "ring_insert", counted)
    return calls


@pytest.mark.parametrize("hop", [WL, WL // 2], ids=["K1", "K2"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_insert_owned_matches_insert(monkeypatch, name, hop):
    """Per step: the batch replayed by one replica (batch index below its
    frontier, as a per-replica tensor), events below the partition's
    watermark, slots whose tenant advances (a few lanes a ring ahead make
    their slot's older lanes stale), and evictions of windows the lagging
    global watermark has not completed; the partition is an [S]
    tensor on even steps and the int 1 on odd ones."""
    spec = SPECS[name](as_assigner(WL, hop))
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(len(name) * 7 + hop)
    fun = spec.zero(S)
    own = dataclasses.replace(fun, windows=map_fields(torch.clone, fun.windows))
    steps = 12
    for t in range(steps):
        part = torch.arange(S) if t % 2 == 0 else 1
        ts = torch.from_numpy((t * 6 + rng.integers(-8, 12, (S, B))).astype(np.int32))
        mask = torch.from_numpy(rng.random((S, B)) < 0.8)
        wm = torch.where(mask, ts, -(2**31)).amax(1)
        if t % 3 == 1:  # a few lanes a ring ahead: their slot's older lanes go stale
            ts[t % S, :3] += SLOTS * WL
        bidx = torch.tensor([t - 2 if t == 5 else t, t, t], dtype=torch.int64)
        kw = _inputs(name, rng, part)
        before = _snapshot(fun)
        want = W.insert(spec, fun, part, ts, mask, batch_idx=bidx, **kw)
        _assert_equal(_snapshot(fun), before)  # insert stays functional
        own = W.insert(spec, own, part, ts, mask, batch_idx=bidx, owned=True, **kw)
        _assert_equal(wstate_to_numpy(own), wstate_to_numpy(want))
        fun = W.increment_watermark(spec, want, part, wm)
        own = W.increment_watermark(spec, own, part, wm)
    assert len(calls) == steps
    err = fun.errors.sum(0)
    assert (err > 0).all(), err  # late, stale and incomplete-eviction lanes all occurred


def _fallback(case, rng):
    """``(spec, partition, inputs)`` of a fold that ``insert(owned=True)``
    leaves to the functional path."""
    f32 = torch.from_numpy(rng.random((S, B)).astype(np.float32))
    ints = torch.from_numpy(rng.integers(0, 7, (S, B)))
    if case == "topk":
        return (W.wtopk(WL, SLOTS, P, k=2, max_active_windows=2), torch.arange(S),
                dict(vals=f32, ids=ints))
    if case == "gset":
        return W.wgset(WL, SLOTS, P, domain=7), torch.arange(S), dict(elems=ints)
    part = (torch.from_numpy(rng.integers(0, P, (S, B))) if case == "lane_partition"
            else torch.arange(S))
    return W.wgcounter(WL, SLOTS, P), part, dict(actor=torch.arange(S), amounts=f32)


@pytest.mark.parametrize("case", ["expanded_leaves", "gset", "lane_partition", "topk"])
def test_insert_owned_falls_back_to_insert(monkeypatch, case):
    """Specs and states outside the one launch's reach take the functional
    path, with its result: a TopK or GSet ring, lanes of their own partitions,
    window leaves that are a broadcast of one row."""
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(3)
    spec, part, kw = _fallback(case, rng)
    st = spec.zero(S)
    if case == "expanded_leaves":
        one = st.windows.slots[:1]
        st = dataclasses.replace(st, windows=type(st.windows)(one.expand_as(st.windows.slots)))
    ts = torch.from_numpy(rng.integers(0, 30, (S, B)).astype(np.int32))
    mask = torch.from_numpy(rng.random((S, B)) < 0.8)
    want = W.insert(spec, st, part, ts, mask, batch_idx=2, **kw)
    got = W.insert(spec, st, part, ts, mask, batch_idx=2, owned=True, **kw)
    _assert_equal(wstate_to_numpy(got), wstate_to_numpy(want))
    assert calls == []
