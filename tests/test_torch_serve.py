"""The serving layers of the port (``attention``, ``ssm``, ``moe``)
against the JAX package's, on the CPU in f32.

Each side gets the same parameters (the JAX package's, carried over
through numpy) and the same inputs, made from a seed with numpy.

Tolerances, each as a share of the JAX output's largest magnitude:

* attention prefill and decode, and their caches: ``1e-5``.  The f32
  products, sums and ``sin``/``cos`` of XLA's CPU round otherwise than
  torch's in the last bits (tests/test_torch_models.py's tolerance);
* ``mamba_decode``: ``1e-5`` (tests/test_torch_ssm.py's: one step of the
  scan, whose multiply-add XLA's CPU fuses and torch does not);
* ``_moe_ffn_decode``: ``1e-5``, as ``moe_ffn`` in tests/test_torch_moe.py;
  its routing maps are bitwise on shared router probabilities;
* the cache written in place: bitwise the JAX package's new cache in every
  slot but the one written (copied unchanged), which holds to ``1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# caches: shapes and dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hp", [0, 6])
def test_init_cache_matches_jax(hp, dtype):
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64, n_heads_padded=hp)
    got = attn.init_cache(attn.AttnDims(**kw), 3, 10, getattr(torch, dtype))
    want = jattn.init_cache(jattn.AttnDims(**kw), 3, 10, getattr(jnp, dtype))
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape == (3, 10, hp or 4, 16)
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not bool(got[k].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [1, 2])
def test_init_ssm_state_matches_jax(version, dtype):
    """The state is f32 whatever the serving dtype; the conv tail is in it."""
    kw = dict(d_model=32, d_state=8, version=version, n_heads=4 if version == 2 else 0)
    got = ssm.init_ssm_state(ssm.SSMDims(**kw), 3, getattr(torch, dtype))
    want = jssm.init_ssm_state(jssm.SSMDims(**kw), 3, getattr(jnp, dtype))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype) == f"torch.{w.dtype}"
        assert not bool(g.any())
    assert got[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# attention: prefill and decode
# ---------------------------------------------------------------------------

ATTN = {
    "gqa": dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64),
    "mha": dict(n_heads=4, n_kv_heads=4, head_dim=16, d_model=64),
    "sliding": dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64, sliding_window=8),
    "pad_heads": dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=64, n_heads_padded=6),
}


def _attn(case, seed):
    jd = jattn.AttnDims(**ATTN[case])
    jp = jattn.init_attn(jax.random.PRNGKey(seed), jd, jnp.float32)
    return attn.AttnDims(**ATTN[case]), jd, params_from_numpy(_numpy(jp)), jp


@pytest.mark.parametrize("case", list(ATTN))
def test_attn_prefill_matches_jax(case):
    """Output and ``{"k", "v"}`` at the ``Hp`` heads, causal, over 4 query
    chunks (a sliding window slices each chunk's kv range)."""
    d, jd, p, jp = _attn(case, 0)
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(np.float32)
    out, kv = attn.attn_prefill(p, d, torch.from_numpy(x), q_chunk=8)
    jout, jkv = jattn.attn_prefill(jp, jd, jnp.asarray(x), q_chunk=8)
    _close(out, jout)
    for k in ("k", "v"):
        assert tuple(kv[k].shape) == jkv[k].shape == (2, 32, d.hp, 16)
        _close(kv[k], jkv[k])


def _decode_both(case, T, position, seed=2, as_tensor=False):
    """One decode step on each side from the same non-zero cache (every
    slot holds data, so a slot the mask lets through shows); the port gets
    ``position`` as a 0-d tensor when ``as_tensor``."""
    d, jd, p, jp = _attn(case, seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    c = {k: rng.standard_normal((2, T, d.hp, 16)).astype(np.float32) for k in ("k", "v")}
    cache = cache_from_numpy(c)
    out, new = attn.attn_decode(p, d, torch.from_numpy(x), cache,
                                torch.tensor(position) if as_tensor else position)
    jout, jnew = jattn.attn_decode(jp, jd, jnp.asarray(x), jax.tree.map(jnp.asarray, c),
                                   position)
    return (out, new, cache), (jout, jnew), c


@pytest.mark.parametrize("case, T, position", [
    ("gqa", 16, 0), ("gqa", 16, 7), ("gqa", 16, 15), ("gqa", 16, 19), ("mha", 16, 40),
    ("sliding", 16, 11), ("sliding", 8, 11), ("pad_heads", 16, 9)],
    ids=["pos0", "mid", "T-1", "ring_past_T", "ring_twice", "sliding_T>w", "ring_T=w",
         "pad_heads"])
def test_attn_decode_matches_jax(case, T, position):
    """Position 0, a mid position, T - 1, past T (the ring slot
    ``position % T``, every slot visible), a sliding window with T > w
    (the explicit mask) and T = w (the ring is the window)."""
    (out, new, _), (jout, jnew), _ = _decode_both(case, T, position)
    _close(out, jout)
    for k in ("k", "v"):
        _close(new[k], jnew[k])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_attn_decode_writes_the_cache_in_place(as_tensor):
    """The cache returned is the one given, its storage written at the slot
    ``position % T`` alone: that slot holds JAX's new keys and values,
    every other slot is unchanged (bitwise JAX's).  ``position`` as a
    Python int or as a 0-d tensor gives the same bits."""
    T, position = 16, 21
    (out, new, cache), (jout, jnew), c = _decode_both("gqa", T, position,
                                                      as_tensor=as_tensor)
    slot = position % T
    for k in ("k", "v"):
        assert new[k] is cache[k]
        assert new[k].data_ptr() == cache[k].data_ptr()
        rest = np.ones(T, bool)
        rest[slot] = False
        np.testing.assert_array_equal(new[k].numpy()[:, rest], np.asarray(jnew[k])[:, rest])
        np.testing.assert_array_equal(new[k].numpy()[:, rest], c[k][:, rest])
        _close(new[k][:, slot], np.asarray(jnew[k])[:, slot])
    (out2, new2, _), _, _ = _decode_both("gqa", T, position)
    assert torch.equal(out, out2) and all(torch.equal(new[k], new2[k]) for k in ("k", "v"))


# ---------------------------------------------------------------------------
# Mamba decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_decode_matches_jax(version):
    """One step from a non-zero state and conv tail: the output, the new
    state and the new tail; the state given is not written."""
    kw = dict(d_model=32, d_state=8, version=version, n_heads=4 if version == 2 else 0)
    d, jd = ssm.SSMDims(**kw), jssm.SSMDims(**kw)
    jp = jssm.init_mamba(jax.random.PRNGKey(version), jd, jnp.float32)
    p = params_from_numpy(_numpy(jp))
    rng = np.random.default_rng(version)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    h_shape = (3, d.d_inner, 8) if version == 1 else (3, d.heads, d.head_dim, 8)
    h0 = rng.standard_normal(h_shape).astype(np.float32)
    c0 = rng.standard_normal((3, d.d_conv - 1, d.d_inner)).astype(np.float32)
    h0_t, c0_t = torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy())
    y, (h, c) = ssm.mamba_decode(p, d, torch.from_numpy(x), h0_t, c0_t)
    jy, (jh, jc) = jssm.mamba_decode(jp, jd, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
    _close(y, jy)
    _close(h, jh)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))  # the tail is a copy
    assert np.array_equal(h0_t.numpy(), h0) and np.array_equal(c0_t.numpy(), c0)
    assert h.dtype == torch.float32


# ---------------------------------------------------------------------------
# MoE decode
# ---------------------------------------------------------------------------


def _moe_dims(**kw):
    base = dict(d_model=32, n_experts=8, top_k=2, d_ff=16, shared_d_ff=24)
    base.update(kw)
    return moe.MoEDims(**base), jmoe.MoEDims(**base)


def _moe_params(jd, seed, bias=0.0):
    """The JAX parameters and the port's copy; ``bias`` raises the router's
    columns of experts 0 and 1 (on positive inputs they then take every
    token first)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jd, jnp.float32)
    jp = dict(jp, router=jp["router"].at[:, :2].add(bias))
    return params_from_numpy(_numpy(jp)), jp


def _jax_decode_route(probs, jd, C):
    """The JAX package's ``_moe_ffn_decode`` routing
    (``src/repro/models/moe.py``:258-274) from given probabilities."""
    T, E = probs.shape
    K = jd.top_k
    gate_vals, gate_idx = jax.lax.top_k(jnp.asarray(probs), K)
    gate_vals = gate_vals / jnp.maximum(jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    flat_e = gate_idx.reshape(-1).astype(jnp.int32)
    flat_t = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    perm0 = jnp.arange(T * K, dtype=jnp.int32)
    se, st, perm = jax.lax.sort((flat_e, flat_t, perm0), dimension=0, num_keys=2)
    sg = gate_vals.reshape(-1)[perm]
    pos = jnp.arange(T * K, dtype=jnp.int32)
    run_start = jnp.searchsorted(se, jnp.arange(E, dtype=jnp.int32), side="left")
    pos_in_e = pos - run_start[se]
    keep = pos_in_e < C
    slot = jnp.where(keep, se * C + pos_in_e, E * C)
    tok_of_slot = jnp.full((E * C + 1,), T, jnp.int32).at[slot].set(st)[: E * C]
    gate_of_slot = jnp.zeros((E * C + 1,), jnp.float32).at[slot].set(sg)[: E * C]
    return _numpy(dict(gate_vals=gate_vals, gate_idx=gate_idx, keep=keep,
                       tok_of_slot=tok_of_slot, gate_of_slot=gate_of_slot))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B, K", [(24, 2), (128, 8), (5, 1)])
def test_moe_decode_routing_bitwise_on_shared_probs(B, K, ties):
    """The decode path's routing (one group of the B tokens, ``C =
    capacity(dims, B)``) from the same probabilities, ties included."""
    d, jd = _moe_dims(n_experts=16, top_k=K)
    C = moe.capacity(d, B)
    rng = np.random.default_rng(B + K)
    logits = rng.standard_normal((B, 16)).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    got = moe.route(torch.from_numpy(probs), d, C)
    want = _jax_decode_route(probs, jd, C)
    for k in ("gate_idx", "gate_vals", "keep", "tok_of_slot"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    gos = np.zeros(16 * C + 1, np.float32)
    gos[got["slot_of_pair"][:, 0].numpy()] = got["gate_vals"].numpy().reshape(-1)
    np.testing.assert_array_equal(gos[:16 * C], want["gate_of_slot"])


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_decode_matches_jax(shared, overflow):
    """24 tokens of one position each, with and without the shared
    expert; ``overflow`` biases the router so that experts 0 and 1 take
    every token first: past ``C = 8`` their pairs go to the trash slot, and
    a token with no kept pair gets zero, or the shared expert's output."""
    d, jd = _moe_dims(shared_expert=shared)
    p, jp = _moe_params(jd, seed=3, bias=40.0 / 32 if overflow else 0.0)
    x = np.random.default_rng(3).standard_normal((24, 1, 32)).astype(np.float32)
    if overflow:
        x = np.abs(x)
    got = moe._moe_ffn_decode(p, d, torch.from_numpy(x))
    want = jmoe._moe_ffn_decode(jp, jd, jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (24, 1, 32)
    _close(got, want)
    C = moe.capacity(d, 24)
    r = moe.route(torch.softmax(torch.from_numpy(x[:, 0]) @ p["router"], -1), d, C)
    none_kept = (r["slot_of_token"] == d.n_experts * C).all(-1)
    assert bool(none_kept.any()) == overflow
    if overflow:
        from repro_torch.models.mlp import mlp_ffn

        alone = (mlp_ffn(p["shared"], torch.from_numpy(x[:, 0])) if shared
                 else torch.zeros((24, 32)))
        assert torch.equal(got[none_kept, 0], alone[none_kept])


def test_moe_ffn_one_token_is_the_decode_path(monkeypatch):
    """``moe_ffn`` on one token a sequence calls ``_moe_ffn_decode``, as
    the JAX package's does, and returns its output."""
    d, jd = _moe_dims(shared_expert=True)
    p, _ = _moe_params(jd, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 1, 32))
                         .astype(np.float32))
    calls = []
    real = moe._moe_ffn_decode
    monkeypatch.setattr(moe, "_moe_ffn_decode",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    got = moe.moe_ffn(p, d, x)
    assert calls == [x.shape]
    assert torch.equal(got, real(p, d, x))
