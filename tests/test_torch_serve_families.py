"""The port's serving path for every architecture at ``reduced()``
(dense, vlm, moe in both layouts, ssm, hybrid, audio) against the JAX
package's, on the CPU in f32, and on the port alone in bf16.

Both sides get the JAX package's parameters (carried over through numpy)
and the same tokens, encoder frames and prefix embeddings, made from a
seed with numpy.  A cache made by the JAX package is carried into the
port (``convert.cache_from_numpy``) and decoded there.

Tolerances, each as a share of the JAX leaf's (or logits') largest
magnitude:

* logits and caches: ``1e-5`` (tests/test_torch_models.py's: the f32
  products, sums and ``sin``/``cos`` of XLA's CPU round otherwise than
  torch's in the last bits; measured at most 1.7e-6 outside the hybrid);
  ``1e-4`` for the hybrid (zamba2), whose Mamba2 scan's multiply-adds
  XLA's CPU fuses and torch does not (tests/test_torch_ssm.py), carried
  through the gated RMSNorm of every layer: its caches and logits differ
  by up to 1.6e-5 of their largest;
* decode against the prefill's next token, on the port alone: ``1e-5``
  (``1e-4`` for the hybrid): the same function of the same inputs,
  computed in one pass or in two (other chunks, other row counts in each
  product); measured at most 1.7e-6.  The JAX package's own test allows
  ``2e-3``;
* bf16, on the port alone: decode against the prefill's next token to
  ``2e-2`` of the logits' largest magnitude, about five steps of bf16's
  8-bit mantissa (2^-8 = 3.9e-3): a product whose sum order depends on
  its row count may round a residual apart in any layer.  Measured 0 on
  the CPU for all ten architectures (torch's CPU bf16 products keep the
  order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import make_prefill_step, make_serve_step

ARCHS = configs.list_archs()
B, S, T = 2, 32, 40  # batch, prompt, cache slots
Q_CHUNK, SSM_CHUNK = 16, 8


def _tol(cfg) -> float:
    return 1e-4 if cfg.family == "hybrid" else 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _paths(tree) -> list[str]:
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _pad_numpy(cache, T_):
    """The JAX cache's key and value leaves grown to ``T_`` slots along
    their time axis (-3), by key: the hybrid's ``conv`` is 5-dim and the
    moe macro's ``dense`` 6-dim, so a pad by ``ndim`` would be wrong."""
    if isinstance(cache, dict):
        return {k: (_pad_time(v, T_) if k in ("k", "v") else _pad_numpy(v, T_))
                for k, v in cache.items()}
    return cache


def _pad_time(x, T_):
    w = [(0, 0)] * x.ndim
    w[-3] = (0, T_ - x.shape[-3])
    return np.pad(x, w)


def _inputs(cfg, seed, B_=B, S_=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B_, S_ + 1)).astype(np.int32)
    enc = (rng.standard_normal((B_, S_, cfg.d_model)).astype(np.float32)
           if cfg.family == "audio" else None)
    return toks, enc


def _port_prefill(cfg, p, toks, enc, **kw):
    t = torch.from_numpy(toks).long()
    if cfg.family == "audio":
        return lm.prefill_encdec(cfg, p, torch.from_numpy(enc), t,
                                 q_chunk=kw.get("q_chunk", Q_CHUNK))
    return (*lm.prefill(cfg, p, t, q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK, **kw), None)


def _jax_prefill(jcfg, jp, toks, enc, **kw):
    if jcfg.family == "audio":
        return jlm.prefill_encdec(jcfg, jp, jnp.asarray(enc), jnp.asarray(toks), q_chunk=Q_CHUNK)
    return (*jlm.prefill(jcfg, jp, jnp.asarray(toks), q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK,
                         **kw), None)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX package's side, once an architecture: parameters, inputs,
    the prefill of the first ``S`` tokens (logits, cache, enc_kv), and one
    decode step of token ``S`` at position ``S`` from that cache grown to
    ``T`` slots."""
    cfg, jcfg = configs.get_config(arch).reduced(), jconfigs.get_config(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    toks, enc = _inputs(cfg, 0)
    jl, jcache, jekv = _jax_prefill(jcfg, jp, toks[:, :S], enc)
    padded = _pad_numpy(_numpy(jcache), T)
    jlg, jnew = jlm.decode_step(jcfg, jp, jax.tree.map(jnp.asarray, padded),
                                jnp.asarray(toks[:, S:]), S, enc_kv=jekv)
    return dict(cfg=cfg, jcfg=jcfg, p=params_from_numpy(_numpy(jp)), jp=jp, toks=toks,
                enc=enc, logits=np.asarray(jl), cache=_numpy(jcache),
                enc_kv=None if jekv is None else _numpy(jekv), padded=padded,
                dec_logits=np.asarray(jlg), dec_cache=_numpy(jnew))


def _same_tree(got, want, tol, what):
    """The port's tree against a numpy tree: the same key paths, shapes and
    dtypes, values to ``tol`` of each leaf's largest magnitude."""
    assert _paths(got) == _paths(want), what
    for path, a, b in zip(_paths(want), tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape, (what, path)
        assert str(a.dtype) == f"torch.{b.dtype}", (what, path)
        _close(a, b, tol, f"{what} {path}")


# ---------------------------------------------------------------------------
# parameters at full depth, and the cache layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["minitron_4b", "zamba2_7b"])
def test_init_draws_in_runs_over_the_key_batch(arch, monkeypatch):
    """A whole model's stacked layers draw their normals at most
    ``_DRAW_CHUNK`` lanes at a time over all the layers' keys (a full-depth
    stack at once would not fit the card): with the bound at 4,096 lanes,
    well under one stacked leaf, the parameters are bitwise the draw at
    once, and so the JAX package's (tests/test_torch_families.py)."""
    from repro_torch.models import common

    cfg = configs.get_config(arch).reduced()
    want = lm.init_params(cfg, prng.prng_key(5), dtype=torch.float32)
    monkeypatch.setattr(common, "_DRAW_CHUNK", 4096)
    got = lm.init_params(cfg, prng.prng_key(5), dtype=torch.float32)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_jax(arch, dtype):
    """Leaf for leaf, key path, shape and dtype (the SSM state stays f32),
    all zeros."""
    cfg, jcfg = configs.get_config(arch).reduced(), jconfigs.get_config(arch).reduced()
    got = lm._cache_spec(cfg, B, T, getattr(torch, dtype))
    want = jax.eval_shape(lambda: jlm._cache_spec(jcfg, B, T, getattr(jnp, dtype)))
    assert _paths(got) == _paths(want)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype}"
        assert not bool(a.any())


def test_cache_spec_hybrid_long_context_is_a_ring():
    """At ``T > 65536`` the hybrid's shared-attention cache is a ring of
    ``long_context_window`` slots (256 at ``reduced()``), as in JAX."""
    cfg, jcfg = (c.get_config("zamba2_7b").reduced() for c in (configs, jconfigs))
    got = lm._cache_spec(cfg, 1, 70_000, torch.bfloat16)
    want = jax.eval_shape(lambda: jlm._cache_spec(jcfg, 1, 70_000, jnp.bfloat16))
    assert _paths(got) == _paths(want)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}"
    assert got["kv"]["k"].shape[2] == cfg.long_context_window == 256


# ---------------------------------------------------------------------------
# prefill and decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """The last position's logits and the whole cache (and the audio
    family's cross-attention keys and values)."""
    r = _reference(arch)
    cfg = r["cfg"]
    logits, cache, enc_kv = _port_prefill(cfg, r["p"], r["toks"][:, :S], r["enc"])
    assert tuple(logits.shape) == r["logits"].shape == (B, 1, cfg.vocab)
    _close(logits, r["logits"], _tol(cfg), "logits")
    _same_tree(cache, r["cache"], _tol(cfg), "cache")
    if cfg.family == "audio":
        _same_tree(enc_kv, r["enc_kv"], _tol(cfg), "enc_kv")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """One step from the JAX-made cache carried across: the logits, and
    the new cache, written into the tensors given."""
    r = _reference(arch)
    cfg = r["cfg"]
    cache = cache_from_numpy(r["padded"])
    storage = [x.data_ptr() for x in tree_leaves(cache)]
    enc_kv = None if r["enc_kv"] is None else cache_from_numpy(r["enc_kv"])
    logits, new = lm.decode_step(cfg, r["p"], cache, torch.from_numpy(r["toks"][:, S:]).long(),
                                 S, enc_kv=enc_kv)
    assert new is cache and [x.data_ptr() for x in tree_leaves(new)] == storage
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    _close(logits, r["dec_logits"], _tol(cfg), "logits")
    _same_tree(new, r["dec_cache"], _tol(cfg), "cache")


def _next_token_gap(cfg, p, dtype) -> float:
    """``tests/test_models_smoke.py::test_decode_matches_prefill_next_token``
    on the port for any family: the logits of decoding the last prompt
    token against a cache prefilled without it (grown by key to S slots)
    against the prefill's logits over the whole prompt, as a share of the
    latter's largest magnitude."""
    toks, enc = _inputs(cfg, 3, B_=1)
    toks = torch.from_numpy(toks[:, :S]).long()
    enc = None if enc is None else torch.from_numpy(enc).to(dtype)
    if cfg.family == "audio":
        want, _, _ = lm.prefill_encdec(cfg, p, enc, toks, q_chunk=Q_CHUNK)
        _, cache, enc_kv = lm.prefill_encdec(cfg, p, enc, toks[:, :S - 1], q_chunk=Q_CHUNK)
    else:
        want, _ = lm.prefill(cfg, p, toks, q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK)
        _, cache = lm.prefill(cfg, p, toks[:, :S - 1], q_chunk=Q_CHUNK, ssm_chunk=S - 1)
        enc_kv = None
    got, _ = lm.decode_step(cfg, p, lm.pad_cache(cache, S), toks[:, S - 1:], S - 1,
                            enc_kv=enc_kv)
    assert got.dtype == want.dtype == dtype and bool(torch.isfinite(got).all())
    want = want.to(torch.float32)
    return float((got.to(torch.float32) - want).abs().max() / want.abs().max())


def _no_drop(cfg):
    """``cfg`` with a capacity factor of ``E / K`` for a MoE: every expert
    then has a slot for every token (``C >= T``).  At the default 1.25 a
    prefill of 32 tokens may drop the last token's pair at an expert that
    more than ``C`` of them chose, where its decode step alone keeps it:
    the two passes then compute different functions."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_next_token(arch):
    r = _reference(arch)
    assert _next_token_gap(_no_drop(r["cfg"]), r["p"], torch.float32) <= _tol(r["cfg"])


def test_vlm_prefix_embeds_match_jax():
    """pixtral with 4 stub patch embeddings before the tokens: the
    prefill's logits and cache (covering 4 + S positions), then a decode
    step at position 4 + S, against JAX."""
    r = _reference("pixtral_12b")
    cfg, jcfg = r["cfg"], r["jcfg"]
    pre = np.random.default_rng(5).standard_normal((B, 4, cfg.d_model)).astype(np.float32)
    toks = r["toks"]
    logits, cache, _ = _port_prefill(cfg, r["p"], toks[:, :S], None,
                                     prefix_embeds=torch.from_numpy(pre))
    jl, jcache, _ = _jax_prefill(jcfg, r["jp"], toks[:, :S], None,
                                 prefix_embeds=jnp.asarray(pre))
    assert cache["k"].shape[2] == 4 + S
    _close(logits, jl, _tol(cfg), "logits")
    _same_tree(cache, _numpy(jcache), _tol(cfg), "cache")
    padded = _pad_numpy(_numpy(jcache), T + 4)
    lg, new = lm.decode_step(cfg, r["p"], cache_from_numpy(padded),
                             torch.from_numpy(toks[:, S:]).long(), 4 + S)
    jlg, jnew = jlm.decode_step(jcfg, r["jp"], jax.tree.map(jnp.asarray, padded),
                                jnp.asarray(toks[:, S:]), 4 + S)
    _close(lg, jlg, _tol(cfg), "decode logits")
    _same_tree(new, _numpy(jnew), _tol(cfg), "decode cache")


def test_hybrid_ring_wraps_as_jax():
    """zamba2 at ``reduced()`` with an 8-slot window and ``T > 65536``: its
    shared attention decodes against a ring of 8 slots.  Twelve steps from
    an empty cache, each against JAX's from the same cache: logits and
    every cache leaf.  Before the ring fills, the slots past ``position``
    are zero (and masked); from step 8 on the ring's slots are all written
    and all visible, the oldest overwritten."""
    r = _reference("zamba2_7b")
    cfg = dataclasses.replace(r["cfg"], long_context_window=8)
    jcfg = dataclasses.replace(r["jcfg"], long_context_window=8)
    cache = lm._cache_spec(cfg, 1, 70_000, torch.float32)
    assert cache["kv"]["k"].shape[2] == 8
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, 12)).astype(np.int32)
    jstep = jax.jit(lambda p_, c_, t_, pos: jlm.decode_step(jcfg, p_, c_, t_, pos))
    for pos in range(12):
        # a copy, finished before the port's step writes the cache in place:
        # jnp.asarray may alias a numpy view of it, and JAX runs ahead
        jc = jax.tree.map(lambda x: jnp.array(x.numpy(), copy=True), cache)
        jlg, jnew = jax.block_until_ready(
            jstep(r["jp"], jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos)))
        lg, cache = lm.decode_step(cfg, r["p"], cache, torch.from_numpy(toks[:, pos:pos + 1])
                                   .long(), torch.tensor(pos))
        _close(lg, jlg, _tol(cfg), f"logits at {pos}")
        _same_tree(cache, _numpy(jnew), _tol(cfg), f"cache at {pos}")
        written = cache["kv"]["k"].abs().sum((0, 1, 3, 4)) > 0  # by ring slot
        assert written.tolist() == [s <= pos for s in range(8)] if pos < 8 else bool(written.all())


# ---------------------------------------------------------------------------
# the step factories, the smoke mirrors and bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_prefill_steps_equal_direct_calls(arch):
    """``make_prefill_step`` and ``make_serve_step`` give the direct calls'
    results bit for bit (the serve step from a clone of the same cache)."""
    r = _reference(arch)
    cfg, p = r["cfg"], r["p"]
    toks = torch.from_numpy(r["toks"]).long()
    prefill_step = make_prefill_step(cfg, q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK)
    if cfg.family == "audio":
        got = prefill_step(p, torch.from_numpy(r["enc"]), toks[:, :S])
    else:
        got = prefill_step(p, toks[:, :S])
    want = _port_prefill(cfg, p, r["toks"][:, :S], r["enc"])
    assert torch.equal(got[0], want[0])
    for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert torch.equal(a, b)
    enc_kv = got[2] if cfg.family == "audio" else None
    c1, c2 = (lm.pad_cache(want[1], T) for _ in range(2))
    l1, n1 = make_serve_step(cfg)(p, c1, toks[:, S:], S, enc_kv)
    l2, n2 = lm.decode_step(cfg, p, c2, toks[:, S:], S, enc_kv=enc_kv)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(n1), tree_leaves(n2)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_shapes(arch):
    """``tests/test_models_smoke.py::test_prefill_decode_shapes`` on the
    port: prefill 64 tokens, then decode at position 64 against the cache
    of 64 slots (the ring's first wrap)."""
    cfg = configs.get_config(arch).reduced()
    p = lm.init_params(cfg, prng.prng_key(2), dtype=torch.float32)
    toks, enc = _inputs(cfg, 2, S_=64)
    logits, cache, enc_kv = _port_prefill(cfg, p, toks[:, :64], enc)
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    lg, _ = lm.decode_step(cfg, p, cache, torch.from_numpy(toks[:, :1]).long(), 64,
                           enc_kv=enc_kv)
    assert tuple(lg.shape) == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving(arch):
    """The JAX package's serving dtype on the port: the cache's leaves in
    bf16 but the SSM states in f32 (its ``_cache_spec``'s dtypes), finite
    bf16 logits, and decode after prefill within 2e-2 of the logits'
    largest magnitude (the docstring)."""
    cfg = configs.get_config(arch).reduced()
    p = lm.init_params(cfg, prng.prng_key(4), dtype=torch.bfloat16)
    toks, enc = _inputs(cfg, 4)
    enc = None if enc is None else torch.from_numpy(enc).to(torch.bfloat16)
    t = torch.from_numpy(toks[:, :S]).long()
    if cfg.family == "audio":
        logits, cache, _ = lm.prefill_encdec(cfg, p, enc, t, q_chunk=Q_CHUNK)
    else:
        logits, cache = lm.prefill(cfg, p, t, q_chunk=Q_CHUNK, ssm_chunk=SSM_CHUNK)
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    spec = lm._cache_spec(cfg, B, S, torch.bfloat16)
    assert _paths(cache) == _paths(spec)
    for a, b in zip(tree_leaves(cache), tree_leaves(spec)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert _next_token_gap(_no_drop(cfg), p, torch.bfloat16) <= 2e-2
