"""The merge side of the port's sync against the JAX package.

The dense delta-sync round's merge side is one fused launch on the card
(``wcrdt.join_delta_stack`` → ``ops.delta_merge_join``); on the CPU it is
the plain version ``kernels/ref.py::delta_merge_join_ref``.  Both are held
bitwise to the JAX package's ``_merge_wstate(state, merge_delta_stack(spec,
stacked))``, one replica of the state at a time, on the same inputs made
with numpy from a seed: every join is exact (max, min, bitwise or), so no
tolerance.  The keyed watermark exchange, ``StackMesh.pmax(x, where=on)``,
is held to ``torch.where`` of the join.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wcrdt as JW
from repro.streaming import queries as jq
from repro_torch.convert import wstate_from_numpy, wstate_to_numpy
from repro_torch.core import wcrdt as W
from repro_torch.kernels import crdt_merge, ops, ref
from repro_torch.launch.mesh import StackMesh
from repro_torch.streaming import queries as pq

SLOTS = 8


def _specs(name: str, P: int):
    """``(jax spec, port spec)`` pairs: a query's shared specs, or one
    catalog lattice."""
    if name in ("q1_ratio", "q4", "q5"):
        mk = {"q1_ratio": "make_q1_ratio", "q4": "make_q4", "q5": "make_q5"}[name]
        kw = {"num_auctions": 6} if name == "q5" else {}
        jqr = getattr(jq, mk)(P, window_len=10, num_slots=SLOTS, **kw)
        pqr = getattr(pq, mk)(P, window_len=10, num_slots=SLOTS, **kw)
        return list(zip(jqr.shared_specs, pqr.shared_specs))
    make = {"pncounter": lambda pkg: pkg.wpncounter(10, SLOTS, P, key_shape=(3,)),
            "maxreg": lambda pkg: pkg.wmaxreg(10, SLOTS, P, key_shape=(2,)),
            "minreg": lambda pkg: pkg.wminreg(10, SLOTS, P),
            "gset": lambda pkg: pkg.wgset(10, SLOTS, P, 5)}[name]
    return [(make(JW), make(W))]


def _leaf(rng, zero: np.ndarray, lead: int) -> np.ndarray:
    shape = (lead, *zero.shape)
    if zero.dtype == np.uint8:
        return rng.integers(0, 2, shape).astype(np.uint8)
    x = np.round(rng.standard_normal(shape) * 20).astype(zero.dtype)
    # the identities ride along: +/-inf in registers, 0 in counters
    return np.where(rng.random(shape) < 0.15, zero[None], x).astype(zero.dtype)


def _case(rng, jspec, S: int, R: int, edge: str) -> tuple[dict, dict]:
    """Numpy ``(state [S], stacked deltas [R])``.  Delta slots clean on a
    replica (wid -1) carry the zero state, as ``delta_since`` ships them.
    Slots 0-3 hold the edges in every case: clean on every replica of the
    stack and of the state (both -1); clean on every delta replica only;
    every state wid newer than the merged one; equal wids everywhere."""
    zero = {f"windows.{f.name}": np.asarray(getattr(jspec.zero_windows(), f.name))
            for f in dataclasses.fields(jspec.zero_windows())}
    P = jspec.num_partitions
    state_wid = rng.integers(-1, 7, (S, SLOTS)).astype(np.int32)
    stack_wid = rng.integers(-1, 7, (R, SLOTS)).astype(np.int32)
    state_wid[:, 0] = stack_wid[:, 0] = -1
    stack_wid[:, 1] = -1
    stack_wid[:, 2] = rng.integers(-1, 4, R)
    state_wid[:, 2] = 5
    state_wid[:, 3] = stack_wid[:, 3] = 4
    if edge == "all_clean":
        stack_wid[:] = -1
    elif edge == "state_newer":
        state_wid[:] = 9
    elif edge == "equal_wids":
        state_wid[:] = stack_wid[:] = 3
    state = {"slot_wid": state_wid}
    stack = {"slot_wid": stack_wid}
    for k, z in zero.items():
        state[k] = _leaf(rng, z, S)
        d = _leaf(rng, z, R)
        clean = (stack_wid < 0).reshape(R, SLOTS, *(1,) * (z.ndim - 1))
        stack[k] = np.where(clean, z[None], d).astype(z.dtype)
    for d, n in ((state, S), (stack, R)):
        d["progress"] = rng.integers(-20, 40, (n, P)).astype(np.int32)
        d["folded"] = rng.integers(0, 9, (n, P)).astype(np.int32)
        d["errors"] = rng.integers(0, 4, (n, 3)).astype(np.int32)
    return state, stack


def _jax_state(jspec, d: dict, row=None):
    z = jspec.zero_windows()
    pick = (lambda a: jnp.asarray(a)) if row is None else (lambda a: jnp.asarray(a[row]))
    return JW.WState(slot_wid=pick(d["slot_wid"]),
                     windows=type(z)(**{f.name: pick(d[f"windows.{f.name}"])
                                        for f in dataclasses.fields(z)}),
                     progress=pick(d["progress"]), folded=pick(d["folded"]),
                     errors=pick(d["errors"]))


def _jax_np(st) -> dict:
    d = {k: np.asarray(getattr(st, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    d.update({f"windows.{f.name}": np.asarray(getattr(st.windows, f.name))
              for f in dataclasses.fields(st.windows)})
    return d


@pytest.mark.parametrize("edge", ["mixed", "all_clean", "state_newer", "equal_wids", "R=1"])
@pytest.mark.parametrize("name", ["q1_ratio", "q4", "q5", "pncounter", "maxreg", "minreg",
                                  "gset"])
def test_fused_merge_side_matches_jax_merge_of_merged_stack(name, edge):
    S = 4
    R = 1 if edge == "R=1" else S
    rng = np.random.default_rng(sum(map(ord, name + edge)))
    for jspec, pspec in _specs(name, S):
        state, stack = _case(rng, jspec, S, R, edge)
        jstack = _jax_state(jspec, stack)
        jmerged = JW.merge_delta_stack(jspec, jstack)
        pstate = wstate_from_numpy(pspec, state)
        pstack = wstate_from_numpy(pspec, stack)
        fused = wstate_to_numpy(W.join_delta_stack(pspec, pstate, pstack))
        two_step = wstate_to_numpy(W._merge_wstate(pstate, W.merge_delta_stack(pspec, pstack)))
        assert fused.keys() == two_step.keys()
        for s in range(S):
            want = _jax_np(JW._merge_wstate(_jax_state(jspec, state, row=s), jmerged))
            assert want.keys() == fused.keys()
            for k, v in want.items():
                assert fused[k].dtype == v.dtype, k
                np.testing.assert_array_equal(fused[k][s], v, err_msg=f"{name} {edge} {k}")
                np.testing.assert_array_equal(two_step[k][s], v, err_msg=f"{name} {edge} {k}")


def test_fused_merge_plain_version_mixed_dtypes_in_one_call():
    """One call of the plain version with an f32 max, an f32 min, an i32 max
    and a u8 or field, and R != S, against each field merged on its own
    (the gated join, then the slot-aware pick)."""
    rng = np.random.default_rng(7)
    S, R, Wn = 3, 5, 6
    state_wid = torch.from_numpy(rng.integers(-1, 4, (S, Wn)).astype(np.int32))
    stack_wid = torch.from_numpy(rng.integers(-1, 4, (R, Wn)).astype(np.int32))
    fields = [(torch.float32, "max", (2,)), (torch.float32, "min", (3, 2)),
              (torch.int32, "max", (4,)), (torch.uint8, "or", (5,))]
    sl, kl, joins = [], [], []
    for dt, op, rest in fields:
        a = torch.from_numpy(rng.integers(0, 50, (S, Wn, *rest))).to(dt)
        b = torch.from_numpy(rng.integers(0, 50, (R, Wn, *rest))).to(dt)
        sl.append(a)
        kl.append(b)
        joins.append(op)
    sm = [torch.from_numpy(rng.integers(0, 9, (S, n)).astype(np.int32)) for n in (3, 3, 2)]
    km = [torch.from_numpy(rng.integers(0, 9, (R, n)).astype(np.int32)) for n in (3, 3, 2)]
    wid, leaves, meta = ops.delta_merge_join(state_wid, stack_wid, sl, kl, joins, sm, km)
    top = stack_wid.amax(0)
    np.testing.assert_array_equal(wid, torch.maximum(state_wid, top))
    for a, b, op, out in zip(sl, kl, joins, leaves):
        assert out.dtype == a.dtype and out.shape == a.shape
        m = ref.gated_delta_merge_ref(stack_wid, b, op)
        for s in range(S):
            for w in range(Wn):
                if state_wid[s, w] > top[w]:
                    want = a[s, w]
                elif state_wid[s, w] < top[w]:
                    want = m[w]
                else:
                    want = {"max": torch.maximum, "min": torch.minimum,
                            "or": torch.bitwise_or}[op](a[s, w], m[w])
                np.testing.assert_array_equal(out[s, w], want)
    for a, b, out in zip(sm, km, meta):
        np.testing.assert_array_equal(out, torch.maximum(a, b.amax(0)))


def test_delta_axis_join_takes_the_fused_merge_for_elementwise_specs(monkeypatch):
    """``delta_axis_join`` makes one ``delta_merge_join`` call a spec with
    elementwise fields, and the merge side calls neither standalone join."""
    calls = []

    def counted(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    for name in ("delta_merge_join", "gated_delta_merge", "crdt_merge"):
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    S = 3
    for spec in pq.make_q4(S, window_len=10, num_slots=SLOTS).shared_specs:
        st = spec.zero(S)
        W.delta_axis_join(spec, st, *W.zero_baseline(spec, S), StackMesh(S, torch.device("cpu")))
    assert calls == ["delta_merge_join", "delta_merge_join"]


@pytest.mark.parametrize("on", [True, False, None])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stack_mesh_pmax_where_is_torch_where_of_the_join(on, dtype):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-100, 100, (5, 7))).to(dtype)
    mesh = StackMesh(5, torch.device("cpu"))
    joined = x.amax(0, keepdim=True).expand_as(x)
    if on is None:
        got, want = mesh.pmax(x), joined
    else:
        where = torch.tensor(on)
        got, want = mesh.pmax(x, where=where), torch.where(where, joined, x)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref.crdt_merge_rows_ref(x, "max", None if on is None
                                                          else torch.tensor(on)), want)


def test_kernel_wrappers_refuse_host_tensors_and_bad_arguments():
    """The CUDA wrappers launch only on CUDA tensors of the types and
    shapes their kernels take (the dispatchers in ``ops`` send host tensors
    to the plain versions instead)."""
    wid = torch.zeros((2, 4), dtype=torch.int32)
    leaf = torch.zeros((2, 4, 3))
    meta = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        crdt_merge.delta_merge_join(wid, wid, [leaf], [leaf], ["max"], [meta], [meta])
    with pytest.raises(ValueError, match="fields"):
        crdt_merge.delta_merge_join(wid, wid, [leaf] * 9, [leaf] * 9, ["max"] * 9, [], [])
    with pytest.raises(ValueError, match="differ in length"):
        crdt_merge.delta_merge_join(wid, wid, [leaf], [], ["max"], [], [])
    with pytest.raises(ValueError, match="no kernel"):
        crdt_merge.delta_merge_join(wid, wid, [leaf], [leaf], ["or"], [], [])
    with pytest.raises(ValueError, match="CUDA tensor"):
        crdt_merge.crdt_merge(meta, "max", rows=True, where=torch.tensor(True))
    with pytest.raises(ValueError, match="no kernel"):
        crdt_merge.crdt_merge(meta.to(torch.int64), "max", rows=True)
