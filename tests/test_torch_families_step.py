"""One ``make_train_step`` step of the moe (both layouts), ssm, hybrid and
audio families in the port against the JAX package's, on the CPU in f32,
from the same parameters and batch.

Tolerances (tests/test_torch_train.py's, and where they are looser, why):

* loss: ``rtol=1e-5``.  The pre-clip grad norm: ``rtol=1e-5``, but
  ``5e-5`` for the hybrid (zamba2).  Its embedding's gradient is 20 times
  the unembedding's (norm 21.3 against 1.0 at this config) and carries the
  scan's rounding (the combine's multiply-add, fused by XLA's CPU and not
  by torch, ``tests/test_torch_ssm.py``) through Mamba2's gated RMSNorm:
  the embedding's gradient differs by 2.1e-5 of its norm, and the norm
  by 1.41e-5;
* AdamW moments: ``1e-4`` of the leaf's largest magnitude, and at least
  ``1e-8`` of the tree's largest.  Two leaves need the floor.  A top-1
  router's gradient is zero but for rounding (its one gate renormalises
  to 1), so its moments are rounding on both sides, about 1e-9 of the
  tree's largest (llama4-scout).  The hybrid's tail ``A_log`` gradient
  differs by about 5e-5 relatively (the scan's rounding again), and its
  second moment, a square, by 1.0011e-4 of the leaf's largest;
* parameters: ``0.05 * lr`` where the first moment stands above ``1e-3``
  of its leaf's largest, else ``2.2 * lr``.  A first AdamW step moves a
  lane by about ``lr * g / |g|`` whatever the gradient's size, so a lane
  whose gradient lies within rounding of zero may step the other way
  (``tests/test_torch_cuda.py::test_train_step_on_card_matches_cpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.training import adamw_init as jadamw_init
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import adamw_init
from repro_torch.training.train_step import make_train_step

NEW = [a for a in configs.list_archs()
       if configs.get_config(a).family in ("moe", "ssm", "hybrid", "audio")]
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _moments_close(got, want, kind):
    want = [np.asarray(b) for b in jax.tree.leaves(want)]
    top = max(float(np.abs(b).max()) for b in want)
    for a, b in zip(tree_leaves(got), want):
        atol = 1e-4 * max(float(np.abs(b).max()), 1e-4 * top)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol, err_msg=kind)


@pytest.mark.parametrize("arch", NEW)
def test_train_step_matches_jax(arch):
    cfg = configs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    if cfg.family == "audio":
        b["enc_embeds"] = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    pb = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in b.items()}

    jp = jinit_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp, jo, js = jax.jit(jmake_train_step(jcfg, q_chunk=32, ssm_chunk=16, lr=LR))(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    p = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    step = make_train_step(cfg, q_chunk=32, ssm_chunk=16, lr=LR)
    p, o, s = step(p, adamw_init(p), pb)

    np.testing.assert_allclose(float(s["loss"]), float(js["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(s["grad_norm"]), float(js["grad_norm"]),
                               rtol=5e-5 if cfg.family == "hybrid" else 1e-5)
    assert float(s["tokens"]) == float(js["tokens"]) == b["tokens"].size
    assert int(o.step) == 1
    _moments_close(o.mu, jo.mu, "mu")
    _moments_close(o.nu, jo.nu, "nu")
    for a, b_, m in zip(tree_leaves(p), jax.tree.leaves(jp), jax.tree.leaves(jo.mu)):
        b_, m = np.asarray(b_), np.abs(np.asarray(m))
        sure = m > 1e-3 * m.max()
        np.testing.assert_allclose(a.numpy()[sure], b_[sure], rtol=0, atol=0.05 * LR)
        np.testing.assert_allclose(a.numpy(), b_, rtol=0, atol=2.2 * LR)
