"""The port's training-metrics lattice against ``repro.training.metrics``.

Mirrors the three cases of ``tests/test_metrics.py`` on both packages, with
the same inputs, made from a seed with numpy where they are not the JAX
test's own.  States are held bitwise (``wstate_to_numpy`` against the JAX
state's arrays); reads bitwise too: ``mean_loss`` and ``tokens`` sum
per-worker f32 rows by the left fold of the JAX package's
``jnp.sum(axis=0)`` (``ops.actor_sum``).  Against plain Python arithmetic,
reads hold to ``rtol=1e-6``, the JAX test's tolerance.

Also here: one stacked state of ``S`` workers folded one step a call (one
``window_agg`` launch of ``L = 1`` a counter) and joined by
``metrics_axis_join`` on a ``StackMesh`` equals each worker folding its own
replica and the replicas merged pairwise; states carried across by
``convert.metric_state_from_numpy`` fold on as the JAX states do.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import metrics as JM
from repro_torch.convert import metric_state_from_numpy, wstate_to_numpy
from repro_torch.launch.mesh import StackMesh
from repro_torch.training import metrics as PM

SPEC = dict(num_workers=3, window_len=2, num_slots=8)
JSPEC, PSPEC = JM.MetricSpec(**SPEC), PM.MetricSpec(**SPEC)
READ_RTOL = 1e-6


def _jax_np(state: dict) -> dict:
    """A JAX metric state as :func:`wstate_to_numpy`'s arrays, with the
    port's replica axis of 1."""
    out = {}
    for k, st in state.items():
        d = {f: np.asarray(getattr(st, f))[None] for f in ("slot_wid", "progress", "folded",
                                                           "errors")}
        d.update({f"windows.{f.name}": np.asarray(getattr(st.windows, f.name))[None]
                  for f in dataclasses.fields(st.windows)})
        out[k] = d
    return out


def _port_np(state: dict, row=None) -> dict:
    out = {k: wstate_to_numpy(st) for k, st in state.items()}
    if row is not None:
        out = {k: {f: a[row:row + 1] for f, a in d.items()} for k, d in out.items()}
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys(), k
        for f in a[k]:
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=f"{k} {f}")
            assert a[k][f].dtype == b[k][f].dtype, (k, f)


def _assert_reads(port, jax_, row=0):
    (pv, pok), (jv, jok) = port, jax_
    assert bool(pok[row]) == bool(jok)
    for k in jv:
        np.testing.assert_array_equal(pv[k][row].numpy(), np.asarray(jv[k]), err_msg=k)


def _fold_both(js, ps, w, step, loss, n_tokens, grad_norm):
    js = JM.metrics_fold(JSPEC, js, w, step, jnp.float32(loss), jnp.float32(n_tokens),
                         jnp.float32(grad_norm))
    ps = PM.metrics_fold(PSPEC, ps, w, step, loss, n_tokens, grad_norm)
    return js, ps


def _replicas():
    """Each worker folds steps 0-2 into its own replica (the JAX test's
    inputs); window 0 holds steps 0-1."""
    out = []
    for w in range(3):
        js, ps = JM.metrics_init(JSPEC), PM.metrics_init(PSPEC, device="cpu")
        for step in range(3):
            js, ps = _fold_both(js, ps, w, step, w + step * 0.1, 100, w * 10 + step)
        _assert_same(_port_np(ps), _jax_np(js))
        out.append((js, ps))
    return out


def test_metric_windows_deterministic_any_merge_order():
    reps = _replicas()
    ref = None
    for order in itertools.permutations(range(3)):
        js, ps = reps[order[0]]
        for i in order[1:]:
            js = JM.metrics_merge(JSPEC, js, reps[i][0])
            ps = PM.metrics_merge(PSPEC, ps, reps[i][1])
        _assert_same(_port_np(ps), _jax_np(js))
        vals, ok = PM.metrics_read(PSPEC, ps, 0)
        _assert_reads((vals, ok), JM.metrics_read(JSPEC, js, 0))
        assert bool(ok[0])
        if ref is None:
            ref = vals
        for k in ref:
            np.testing.assert_array_equal(vals[k].numpy(), ref[k].numpy())


def test_window_incomplete_until_all_workers_pass():
    js, ps = JM.metrics_init(JSPEC), PM.metrics_init(PSPEC, device="cpu")
    for step in range(4):  # only worker 0 progresses
        js, ps = _fold_both(js, ps, 0, step, 1.0, 1.0, 1.0)
    _assert_same(_port_np(ps), _jax_np(js))
    read = PM.metrics_read(PSPEC, ps, 0)
    assert not bool(read[1][0]), "window must wait for the global watermark"
    _assert_reads(read, JM.metrics_read(JSPEC, js, 0))


def test_metric_values_match_plain_aggregation():
    js, ps = JM.metrics_init(JSPEC), PM.metrics_init(PSPEC, device="cpu")
    losses = {(w, s): w * 1.0 + s * 0.25 for w in range(3) for s in range(2)}
    for (w, s), loss in losses.items():
        js, ps = _fold_both(js, ps, w, s, loss, 7.0, loss * 2)
    _assert_same(_port_np(ps), _jax_np(js))
    (vals, ok), jread = PM.metrics_read(PSPEC, ps, 0), JM.metrics_read(JSPEC, js, 0)
    assert bool(ok[0])
    np.testing.assert_allclose(float(vals["mean_loss"][0]), sum(losses.values()) / 6,
                               rtol=READ_RTOL)
    np.testing.assert_allclose(float(vals["tokens"][0]), 7 * 6, rtol=READ_RTOL)
    np.testing.assert_allclose(float(vals["grad_norm_max"][0]), max(losses.values()) * 2,
                               rtol=READ_RTOL)
    _assert_reads((vals, ok), jread)


def _inputs(S: int, steps: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    loss = (rng.random((steps, S)) * 4 + 0.5).astype(np.float32)
    tokens = rng.integers(100, 5000, (steps, S)).astype(np.float32)
    gnorm = (rng.standard_normal((steps, S)) ** 2).astype(np.float32)
    return loss, tokens, gnorm


@pytest.mark.parametrize("S", [3, 5, 16])
def test_stacked_fold_and_axis_join_equal_pairwise_merges(S):
    """One call folds every worker's step into its own row; the join over
    the stack equals the per-worker replicas merged pairwise, in the port
    and in the JAX package, bitwise; reads bitwise too."""
    spec_kw = dict(num_workers=S, window_len=4, num_slots=8)
    jspec, pspec = JM.MetricSpec(**spec_kw), PM.MetricSpec(**spec_kw)
    steps = 22
    loss, tokens, gnorm = _inputs(S, steps)
    stacked = PM.metrics_init(pspec, device="cpu", replicas=S)
    workers = torch.arange(S)
    for t in range(steps):
        stacked = PM.metrics_fold(pspec, stacked, workers, t, torch.from_numpy(loss[t]),
                                  torch.from_numpy(tokens[t]), torch.from_numpy(gnorm[t]))
    acc_p = acc_j = None
    for w in range(S):
        ps, js = PM.metrics_init(pspec, device="cpu"), JM.metrics_init(jspec)
        for t in range(steps):
            ps = PM.metrics_fold(pspec, ps, w, t, float(loss[t, w]), float(tokens[t, w]),
                                 float(gnorm[t, w]))
            js = JM.metrics_fold(jspec, js, w, t, jnp.float32(loss[t, w]),
                                 jnp.float32(tokens[t, w]), jnp.float32(gnorm[t, w]))
        _assert_same(_port_np(stacked, row=w), _port_np(ps))
        _assert_same(_port_np(ps), _jax_np(js))
        acc_p = ps if acc_p is None else PM.metrics_merge(pspec, acc_p, ps)
        acc_j = js if acc_j is None else JM.metrics_merge(jspec, acc_j, js)
    joined = PM.metrics_axis_join(pspec, stacked, StackMesh(S, torch.device("cpu")))
    _assert_same(_port_np(acc_p), _jax_np(acc_j))
    for row in range(S):
        _assert_same(_port_np(joined, row=row), _port_np(acc_p))
    complete = 0
    for wid in range(steps // spec_kw["window_len"] + 1):
        read = PM.metrics_read(pspec, joined, wid)
        want = JM.metrics_read(jspec, acc_j, wid)
        for row in range(S):
            _assert_reads(read, want, row)
        complete += bool(want[1])
    assert complete == steps // spec_kw["window_len"]


def test_states_from_numpy_fold_on_as_jax():
    """A JAX state carried across by ``metric_state_from_numpy`` takes the
    next steps as the JAX state does."""
    js = JM.metrics_init(JSPEC)
    loss, tokens, gnorm = _inputs(3, 6, seed=1)
    for t in range(3):
        for w in range(3):
            js = JM.metrics_fold(JSPEC, js, w, t, jnp.float32(loss[t, w]),
                                 jnp.float32(tokens[t, w]), jnp.float32(gnorm[t, w]))
    ps = metric_state_from_numpy(PSPEC, {k: {f: a[0] for f, a in d.items()}
                                         for k, d in _jax_np(js).items()})
    _assert_same(_port_np(ps), _jax_np(js))
    for t in range(3, 6):
        for w in range(3):
            js, ps = _fold_both(js, ps, w, t, float(loss[t, w]), float(tokens[t, w]),
                                float(gnorm[t, w]))
    _assert_same(_port_np(ps), _jax_np(js))
    for wid in range(3):
        _assert_reads(PM.metrics_read(PSPEC, ps, wid), JM.metrics_read(JSPEC, js, wid))


def test_metrics_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: metrics_init runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.metrics_init(PSPEC)
