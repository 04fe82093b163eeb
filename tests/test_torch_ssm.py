"""The port's selective state-space blocks (``repro_torch.models.ssm``)
against the JAX package's, on the CPU in f32.

Tolerances:

* the scan, the conv and the Mamba blocks: ``rtol=1e-5, atol=1e-5``.  XLA's
  CPU contracts the combine's ``a2*b1 + b2`` (and the chunk's
  ``pa*h0 + pb``, the conv's ``x*w + y``) into one fused multiply-add,
  where torch rounds the product first: each step may differ by an ulp,
  and a prefix stands ``log2(chunk) + L/chunk`` steps deep.  With the
  multiply-adds fused as XLA fuses them (:func:`prng.fma`), the port's
  scan is bitwise JAX's: the pairing of ``jax.lax.associative_scan`` is
  kept exactly;
* gradients through the scan: ``rtol=1e-4`` of each leaf's largest
  magnitude (sums over the sequence, added in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.streaming import prng

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _scan_inputs(seed, L, v2):
    """Decays in (0.5, 1) and normal inputs: Mamba1's ``[B, L, Di, N]``
    pair, or Mamba2's ``[B, L, H, 1, 1]`` decay against ``[B, L, H, P, N]``."""
    rng = np.random.default_rng(seed)
    a_shape, tail = ((2, L, 3, 1, 1), (3, 4, 4)) if v2 else ((2, L, 8, 4), (8, 4))
    a = rng.uniform(0.5, 1.0, a_shape).astype(np.float32)
    b = rng.standard_normal((2, L, *tail)).astype(np.float32)
    h0 = rng.standard_normal((2, *tail)).astype(np.float32)
    return a, b, h0


SCANS = [(16, 16), (64, 16), (48, 48), (40, 5), (37, 37), (12, 4)]


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("L, chunk", SCANS)
def test_chunked_linear_scan_matches_jax(L, chunk, v2):
    a, b, h0 = _scan_inputs(L + chunk, L, v2)
    got, got_last = ssm.chunked_linear_scan(*map(torch.from_numpy, (a, b, h0)), chunk)
    want, want_last = jax.jit(lambda *x: jssm.chunked_linear_scan(*x, chunk))(a, b, h0)
    assert tuple(got.shape) == want.shape and tuple(got_last.shape) == want_last.shape
    _close(got, want)
    _close(got_last, want_last)
    np.testing.assert_array_equal(got_last.numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("L, chunk", SCANS)
def test_scan_pairing_is_jax_under_fused_multiply_adds(L, chunk, monkeypatch):
    """With each multiply-add fused as XLA's CPU fuses it, the port's
    chunked scan gives the JAX package's bits: the same prefix tree."""
    monkeypatch.setattr(ssm, "_lr_combine",
                        lambda e1, e2: (e1[0] * e2[0], prng.fma(e2[0], e1[1], e2[1])))
    monkeypatch.setattr(ssm, "_fold_state", lambda pa, h, pb: prng.fma(pa, h[:, None], pb))
    a, b, h0 = _scan_inputs(L * chunk, L, False)
    got, got_last = ssm.chunked_linear_scan(*map(torch.from_numpy, (a, b, h0)), chunk)
    want, want_last = jax.jit(lambda *x: jssm.chunked_linear_scan(*x, chunk))(a, b, h0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))


def test_chunked_linear_scan_rejects_a_ragged_chunk():
    a, b, h0 = _scan_inputs(0, 12, False)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.chunked_linear_scan(*map(torch.from_numpy, (a, b, h0)), 5)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("K", [1, 4])
def test_causal_conv1d_matches_jax(with_prev, K):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((K, 16)).astype(np.float32)
    prev = rng.standard_normal((2, K - 1, 16)).astype(np.float32) if with_prev else None
    got_y, got_tail = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                        None if prev is None else torch.from_numpy(prev))
    want_y, want_tail = jax.jit(jssm.causal_conv1d)(x, w, prev)
    _close(got_y, want_y)
    assert tuple(got_tail.shape) == want_tail.shape
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


def _dims(version):
    return ssm.SSMDims(d_model=32, d_state=8, version=version,
                       n_heads=4 if version == 2 else 0)


def _params(version, seed=0):
    d = _dims(version)
    jd = jssm.SSMDims(**{f: getattr(d, f) for f in ("d_model", "d_state", "d_conv", "expand",
                                                    "version", "n_heads")})
    p = ssm.init_mamba(prng.prng_key(seed), d, torch.float32)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jd, jnp.float32)
    return d, jd, p, jp


@pytest.mark.parametrize("version", [1, 2])
def test_init_mamba_is_jax_bitwise(version):
    _, _, p, jp = _params(version, seed=5)
    assert sorted(p) == sorted(jp)
    for k in p:
        assert p[k].dtype == torch.float32 and tuple(p[k].shape) == jp[k].shape, k
        np.testing.assert_array_equal(p[k].numpy().view(np.uint32),
                                      np.asarray(jp[k]).view(np.uint32), err_msg=k)


def test_mamba2_a_log_is_jax_bitwise_at_zamba2_heads():
    """``log(linspace(1, 16, H))`` at zamba2's 112 heads (and the reduced
    config's 4): ``torch.linspace`` differs in 44 of the 112 lanes."""
    for H in (4, 112):
        want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H).astype(jnp.float32)))
        got = prng.xla_log(ssm._linspace_f32(1.0, 16.0, H, "cpu")).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_mamba_forward_matches_jax(version, with_state):
    """``y``, ``h_last`` and the conv tail, from zero or a carried state."""
    d, jd, p, jp = _params(version)
    rng = np.random.default_rng(version)
    x = rng.standard_normal((2, 32, d.d_model)).astype(np.float32)
    state = conv = None
    if with_state:
        shape = (2, d.d_inner, d.d_state) if version == 1 else (2, d.heads, d.head_dim,
                                                                d.d_state)
        state = rng.standard_normal(shape).astype(np.float32)
        conv = rng.standard_normal((2, d.d_conv - 1, d.d_inner)).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got, (h_last, tail) = ssm.mamba_forward(p, d, t(x), state=t(state), conv_prev=t(conv),
                                            chunk=8)
    want, (jh_last, jtail) = jax.jit(
        lambda p_, x_, s_, c_: jssm.mamba_forward(p_, jd, x_, state=s_, conv_prev=c_, chunk=8)
    )(jp, x, state, conv)
    _close(got, want)
    _close(h_last, jh_last)
    _close(tail, jtail)


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_forward_grads_match_jax(version):
    """The backward through the scan: gradients of ``sum(y * w)`` with
    respect to every parameter and to ``x``."""
    d, jd, p, jp = _params(version, seed=2)
    rng = np.random.default_rng(10 + version)
    x = rng.standard_normal((2, 32, d.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 32, d.d_model)).astype(np.float32)

    def jloss(p_, x_):
        return jnp.sum(jssm.mamba_forward(p_, jd, x_, chunk=8)[0] * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (ssm.mamba_forward(leaves, d, xt, chunk=8)[0] * torch.from_numpy(w)).sum().backward()
    for k in leaves:
        want = np.asarray(jg[k])
        _close(leaves[k].grad, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    want = np.asarray(jgx)
    _close(xt.grad, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
