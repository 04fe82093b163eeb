"""The port's LM stack for every family (dense, vlm, moe, ssm, hybrid,
audio) against the JAX package's, on the CPU in f32.

* ``init_params`` bitwise, leaf by leaf, for every architecture at its
  ``reduced()`` size, in f32 and in the JAX default bf16 (leaf dtypes
  included: the router and Mamba's ``dt_proj``, ``dt_bias``, ``A_log`` and
  ``D`` stay f32);
* ``forward_loss`` of the moe (both layouts), ssm, hybrid and audio
  families to ``rtol=1e-5`` (tests/test_torch_models.py's tolerance);
* the mirrors of ``tests/test_models_smoke.py``'s
  ``test_forward_loss_finite`` and ``test_train_step_updates_params`` on the
  port alone, over all ten architectures.

One ``make_train_step`` step against JAX is in
``tests/test_torch_families_step.py``; serving (prefill, decode, caches)
in ``tests/test_torch_serve.py`` and ``tests/test_torch_serve_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward_loss as jforward_loss
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import forward_loss, init_params
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import adamw_init
from repro_torch.training.checkpoint import to_numpy_tree
from repro_torch.training.train_step import make_train_step

ARCHS = configs.list_archs()
NEW = [a for a in ARCHS if configs.get_config(a).family in ("moe", "ssm", "hybrid", "audio")]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0, B=2, S=64):
    """Tokens (and a vlm's 16 prefix embeddings, an audio model's S frame
    embeddings) from numpy: the port's batch and the JAX one."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    port = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in b.items()}
    return port, {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# init: bitwise, every architecture, f32 and bf16
# ---------------------------------------------------------------------------


def _bits(x):
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bitwise_every_arch(arch, dtype):
    cfg = configs.get_config(arch).reduced()
    jtree = jinit_params(jconfigs.get_config(arch).reduced(), jax.random.PRNGKey(3),
                         dtype=getattr(jnp, dtype))
    got = init_params(cfg, prng.prng_key(3), dtype=getattr(torch, dtype))
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    want = jax.tree.leaves(jtree)
    assert len(want) == len(tree_leaves(got))
    for path, a, b in zip(paths, want, tree_leaves(got)):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype}", path
        a = np.asarray(a)
        b = b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 else b.numpy()
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=path)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "zamba2_7b", "seamless_m4t_large_v2"])
def test_checkpoint_trees_carry_the_nested_stacks(arch):
    """The moe macro (``layers.dense`` stacked twice), the hybrid's
    ``[n_macro, every, ...]`` stack and ``tail``, and the encoder-decoder's
    two stacks through numpy and ``convert.params_from_numpy`` unchanged."""
    cfg = configs.get_config(arch).reduced()
    p = init_params(cfg, prng.prng_key(2), dtype=torch.float32)
    back = params_from_numpy(to_numpy_tree(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(tree_leaves(p), tree_leaves(back)):
        assert torch.equal(a, b)
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        assert p["layers"]["mamba"]["in_proj"].shape[:2] == (cfg.n_layers // every, every)
        assert p["tail"]["ln"].shape[0] == cfg.n_layers % every


# ---------------------------------------------------------------------------
# forward_loss against JAX, the new families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_forward_loss_matches_jax(arch):
    cfg = configs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    params = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pb, jb = _batch(cfg)
    got = forward_loss(cfg, params, pb, q_chunk=32, ssm_chunk=16)
    want = jax.jit(lambda p, b: jforward_loss(jcfg, p, b, q_chunk=32, ssm_chunk=16))(jparams, jb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py, every architecture, on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_finite(arch):
    cfg = configs.get_config(arch).reduced()
    params = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    pb, _ = _batch(cfg)
    loss = forward_loss(cfg, params, pb, q_chunk=32, ssm_chunk=16)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch} loss={loss}"
    assert 1.0 < float(loss) < 20.0  # ~ln(vocab) at init


@pytest.mark.parametrize("arch", ARCHS)
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
