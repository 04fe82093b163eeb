"""The port's LM stack (``repro_torch.configs`` and ``repro_torch.models``)
against the JAX package's, on the CPU in f32.

The same seed draws the same parameters on both sides: ``init_params`` is
held bitwise, leaf by leaf, for every dense and vlm architecture at its
``reduced()`` size (``tests/test_torch_families.py`` holds every other
family).  The layers and the loss are held to ``rtol=1e-5`` (the
f32 matrix products, sums and ``sin``/``cos``/``rsqrt`` of XLA's CPU and of
torch's round differently in the last bits; 1e-5 is ``tests/test_kernels.py``'s
float tolerance), except ``rope_freqs``, which goes through glibc's
``powf`` on both sides and is bitwise.  Then the dense and vlm cases of
``tests/test_models_smoke.py`` run on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import forward_loss as jforward_loss
from repro_torch import configs
from repro_torch.models import attention, common, forward_loss, init_params
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import adamw_init
from repro_torch.training.train_step import make_train_step

DENSE = [a for a in configs.list_archs() if configs.get_config(a).family in ("dense", "vlm")]
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after,
    so the workers of a parallel test run do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _gqa(cfg):
    """The reduced config with 2 kv heads under 4 query heads, so the GQA
    expansion runs (``reduced()`` keeps kv heads = heads)."""
    return dataclasses.replace(cfg, n_kv_heads=2)


# ---------------------------------------------------------------------------
# configs: plain data, copied
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.list_archs())
def test_configs_are_the_jax_configs(arch):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert configs.runnable_cells(got) == jconfigs.runnable_cells(want)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


# ---------------------------------------------------------------------------
# init: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_bitwise(arch):
    cfg = configs.get_config(arch).reduced()
    want = jinit_params(jconfigs.get_config(arch).reduced(), jax.random.PRNGKey(3),
                        dtype=jnp.float32)
    got = init_params(cfg, prng.prng_key(3), dtype=torch.float32)
    jl, pl = jax.tree.leaves(want), tree_leaves(got)
    assert [a.shape for a in jl] == [tuple(b.shape) for b in pl]
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a).view(np.uint32))


def test_init_params_gqa_and_bf16():
    """Two kv heads under four query heads (the wk / wv widths), and the
    JAX default dtype, bf16: both bitwise.  Under bf16 the MoE router and
    Mamba's ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` stay f32, as in
    the JAX package."""
    cfg = _gqa(configs.get_config("minitron_4b").reduced())
    jcfg = _gqa(jconfigs.get_config("minitron_4b").reduced())
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.tree.leaves(jinit_params(jcfg, jax.random.PRNGKey(1), dtype=jdt))
        got = tree_leaves(init_params(cfg, prng.prng_key(1), dtype=pdt))
        for a, b in zip(want, got):
            assert b.dtype == pdt
            np.testing.assert_array_equal(b.view(torch.int16 if pdt == torch.bfloat16
                                                 else torch.int32).numpy(),
                                          np.asarray(a).view(np.int16 if jdt == jnp.bfloat16
                                                             else np.int32))
    f32_leaves = {"qwen3_moe_235b_a22b": lambda p: [p["layers"]["moe"]["router"]],
                  "llama4_scout_17b_a16e": lambda p: [p["layers"]["moe"]["moe"]["router"]],
                  "falcon_mamba_7b": lambda p: [p["layers"]["mamba"][k] for k in
                                                ("dt_proj", "dt_bias", "A_log", "D")],
                  "zamba2_7b": lambda p: [p[s]["mamba"][k] for s in ("layers", "tail") for k in
                                          ("dt_proj", "dt_bias", "A_log", "D")]}
    for arch, leaves in f32_leaves.items():
        p = init_params(configs.get_config(arch).reduced(), prng.prng_key(1),
                        dtype=torch.bfloat16)
        jp = jinit_params(jconfigs.get_config(arch).reduced(), jax.random.PRNGKey(1),
                          dtype=jnp.bfloat16)
        for a, b in zip(leaves(p), leaves(jp)):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32, arch
            np.testing.assert_array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))
        assert p["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers, f32
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    scale = (rng.standard_normal(32) * 0.1).astype(np.float32)
    _close(common.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    for hd, theta in ((32, 10_000.0), (128, 500_000.0)):
        np.testing.assert_array_equal(common.rope_freqs(hd, theta).numpy(),
                                      np.asarray(jcommon.rope_freqs(hd, theta)))
    pos = np.arange(16)[None, :] + np.array([[0], [300]])
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), atol=1e-6)


@pytest.mark.parametrize("causal, window, q_chunk", [
    (True, 0, 16), (True, 0, 64), (True, 24, 16), (True, 40, 32), (False, 0, 16)])
def test_attend_chunked_matches_jax(causal, window, q_chunk):
    """Full-causal and sliding-window chunking, and a bidirectional pass,
    with the kv heads expanded as the train path expands them."""
    rng = np.random.default_rng(window + q_chunk)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, sliding_window=window, q_chunk=q_chunk)
    got = attention.attend_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, atol=1e-6)


def test_attn_train_gqa_matches_jax():
    cfg = _gqa(configs.get_config("minitron_4b").reduced())
    jcfg = _gqa(jconfigs.get_config("minitron_4b").reduced())
    from repro.models import lm as jlm
    from repro_torch.models import lm
    dims, jdims = lm.attn_dims(cfg), jlm.attn_dims(jcfg)
    np.testing.assert_array_equal(dims.kv_expand_idx().numpy(), np.asarray(jdims.kv_expand_idx()))
    p = attention.init_attn(prng.prng_key(4), dims, torch.float32)
    jp = jattn.init_attn(jax.random.PRNGKey(4), jdims, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _close(attention.attn_train(p, dims, torch.from_numpy(x), q_chunk=8),
           jattn.attn_train(jp, jdims, jnp.asarray(x), q_chunk=8), atol=1e-6)


def test_unembed_loss_matches_jax():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 64, 32)).astype(np.float32)
    table = (rng.standard_normal((300, 32)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 300, (2, 64))
    mask = (rng.random((2, 64)) > 0.2).astype(np.float32)
    for chunk in (16, 64):
        got = common.unembed_loss(torch.from_numpy(h), torch.from_numpy(table),
                                  torch.from_numpy(labels), torch.from_numpy(mask), chunk=chunk)
        want = jcommon.unembed_loss(jnp.asarray(h), jnp.asarray(table), jnp.asarray(labels),
                                    jnp.asarray(mask), chunk=chunk)
        _close(got, want)


def _batch(cfg, seed=0, B=2, S=64):
    """Tokens (and a vlm's 16 prefix embeddings) from numpy: the port's
    batch and the JAX one."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    port = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in b.items()}
    return port, {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["minitron_4b", "pixtral_12b"])
def test_forward_loss_matches_jax(arch):
    cfg = _gqa(configs.get_config(arch).reduced())
    jcfg = _gqa(jconfigs.get_config(arch).reduced())
    params = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pb, jb = _batch(cfg)
    got = forward_loss(cfg, params, pb, q_chunk=32)
    want = jax.jit(lambda p, b: jforward_loss(jcfg, p, b, q_chunk=32))(jparams, jb)
    _close(got, want)


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py, dense and vlm, on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_finite(arch):
    cfg = configs.get_config(arch).reduced()
    params = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    pb, _ = _batch(cfg)
    loss = forward_loss(cfg, params, pb, q_chunk=32)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch} loss={loss}"
    assert 1.0 < float(loss) < 20.0  # ~ln(vocab) at init


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_updates_params(arch):
    cfg = configs.get_config(arch).reduced()
    params = init_params(cfg, prng.prng_key(1), dtype=torch.float32)
    opt = adamw_init(params)
    step = make_train_step(cfg, q_chunk=32, ssm_chunk=16, lr=1e-3)
    pb, _ = _batch(cfg, seed=1)
    new_params, new_opt, stats = step(params, opt, pb)
    assert torch.isfinite(stats["loss"])
    assert torch.isfinite(stats["grad_norm"]) and float(stats["grad_norm"]) > 0
    assert int(new_opt.step) == 1
    moved = any(not torch.equal(a, b)
                for a, b in zip(tree_leaves(params), tree_leaves(new_params)))
    assert moved, f"{arch}: no parameter changed"
