"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU in f32.

The integer routing maps (top-k experts, the slot of each (expert, token)
pair, ``keep``, ``tok_of_slot``) are held bitwise against the JAX
package's steps 1-4 on the same router probabilities, handed over through
numpy (tied probabilities included): end to end, two f32 routers may round
a near-tie apart.  The layer's output, its gradients and the auxiliary
loss hold to ``rtol=1e-5`` / ``1e-4`` of each leaf's largest magnitude
(tests/test_torch_models.py's tolerances: the f32 products and sums of the
two sides round differently in the last bits).  The gather function's
backward, which adds a row's terms in slot order, is bitwise the plain
scatter-add gradient of autograd's own index on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _dims(**kw):
    base = dict(d_model=32, n_experts=8, top_k=2, d_ff=16, capacity_factor=1.25)
    base.update(kw)
    return moe.MoEDims(**base), jmoe.MoEDims(**base)


@pytest.mark.parametrize("T, K, E, cf", [(128, 2, 8, 1.25), (4096, 8, 128, 1.25),
                                          (4096, 1, 16, 1.25), (7, 1, 64, 1.0),
                                          (1000, 3, 5, 2.0), (333, 2, 7, 0.5)])
def test_capacity_matches_jax(T, K, E, cf):
    d, jd = _dims(n_experts=E, top_k=K, capacity_factor=cf)
    assert moe.capacity(d, T) == jmoe.capacity(jd, T)
    assert moe.capacity(d, T) % 8 == 0


def _jax_route(probs, jd, C):
    """The JAX package's ``moe_ffn`` steps 1-4 (``src/repro/models/moe.py``
    :170-199) at one group, from given probabilities."""
    G, (Tl, E), K = 1, probs.shape, jd.top_k
    probs = jnp.asarray(probs)[None]
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    flat_e = gate_idx.reshape(G, Tl * K).astype(jnp.int32)
    flat_t = jnp.broadcast_to(jnp.repeat(jnp.arange(Tl, dtype=jnp.int32), K)[None], (G, Tl * K))
    perm0 = jnp.broadcast_to(jnp.arange(Tl * K, dtype=jnp.int32)[None], (G, Tl * K))
    se, st, perm = jax.lax.sort((flat_e, flat_t, perm0), dimension=1, num_keys=2)
    sg = jnp.take_along_axis(gate_vals.reshape(G, Tl * K), perm, axis=1)
    pos = jnp.arange(Tl * K, dtype=jnp.int32)[None]
    run_start = jax.vmap(
        lambda row: jnp.searchsorted(row, jnp.arange(E, dtype=jnp.int32), side="left"))(se)
    gi = jnp.arange(G, dtype=jnp.int32)[:, None]
    pos_in_e = pos - run_start[gi, se]
    keep = pos_in_e < C
    slot = jnp.where(keep, se * C + pos_in_e, E * C)
    tok_of_slot = jnp.full((G, E * C + 1), Tl, jnp.int32).at[gi, slot].set(st)[:, :E * C]
    gate_of_slot = jnp.zeros((G, E * C + 1), jnp.float32).at[gi, slot].set(sg)[:, :E * C]
    return {k: np.asarray(v[0]) for k, v in dict(
        gate_vals=gate_vals, gate_idx=gate_idx, keep=keep, slot=slot, tok_of_slot=tok_of_slot,
        gate_of_slot=gate_of_slot).items()}


def _probs(seed, T, E, ties):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if ties:  # few distinct values: many exact ties inside a row
        logits = np.round(logits * 2) / 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("T, E, K, cf", [(64, 8, 2, 1.25), (256, 16, 1, 1.25),
                                          (128, 32, 8, 1.25), (96, 8, 2, 0.5)])
def test_routing_maps_bitwise_on_shared_probs(T, E, K, cf, ties):
    d, jd = _dims(n_experts=E, top_k=K, capacity_factor=cf)
    C = moe.capacity(d, T)
    probs = _probs(T * E + K, T, E, ties)
    got = moe.route(torch.from_numpy(probs), d, C)
    want = _jax_route(probs, jd, C)
    np.testing.assert_array_equal(got["gate_idx"].numpy(), want["gate_idx"])
    np.testing.assert_array_equal(got["gate_vals"].numpy(), want["gate_vals"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_array_equal(got["tok_of_slot"].numpy(), want["tok_of_slot"])
    # the inverse maps: every kept pair's slot, the slot's gate and token
    slot_of_pair = got["slot_of_pair"][:, 0].numpy()
    kept = slot_of_pair < E * C
    assert kept.sum() == want["keep"].sum()
    gos = np.zeros(E * C + 1, np.float32)
    gos[slot_of_pair] = got["gate_vals"].numpy().reshape(-1)
    np.testing.assert_array_equal(gos[:E * C], want["gate_of_slot"])
    np.testing.assert_array_equal(np.sort(slot_of_pair.reshape(T, K), -1),
                                  got["slot_of_token"].numpy())
    pair_of_slot = got["pair_of_slot"].numpy()
    full = pair_of_slot < T * K
    np.testing.assert_array_equal(pair_of_slot[full] // K, want["tok_of_slot"][full])
    np.testing.assert_array_equal(slot_of_pair[pair_of_slot[full]], np.nonzero(full)[0])


def _params(d, jd, seed):
    from repro_torch.streaming import prng

    p = moe.init_moe(prng.prng_key(seed), d, torch.float32)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jd, jnp.float32)
    return p, jp


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_moe_ffn_matches_jax(K, shared):
    d, jd = _dims(top_k=K, shared_expert=shared, shared_d_ff=24)
    p, jp = _params(d, jd, seed=K)
    x = np.random.default_rng(K).standard_normal((2, 32, d.d_model)).astype(np.float32)
    got = moe.moe_ffn(p, d, torch.from_numpy(x))
    want = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, jd, x_))(jp, x)
    _close(got, want, atol=1e-6)


def test_moe_ffn_grads_match_jax():
    """Gradients of ``sum(out * w)`` with respect to every parameter (the
    router's through the gates) and to ``x``, shared expert on."""
    d, jd = _dims(top_k=2, shared_expert=True, shared_d_ff=24)
    p, jp = _params(d, jd, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, d.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 32, d.d_model)).astype(np.float32)
    jg, jgx = jax.jit(jax.grad(lambda p_, x_: jnp.sum(jmoe.moe_ffn(p_, jd, x_) * w),
                               argnums=(0, 1)))(jp, x)
    from repro_torch.models.common import tree_leaves, tree_map

    leaves = tree_map(lambda t: t.clone().requires_grad_(True), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    (moe.moe_ffn(leaves, d, xt) * torch.from_numpy(w)).sum().backward()
    for a, b in zip(tree_leaves(leaves) + [xt], jax.tree.leaves(jg) + [jgx]):
        b = np.asarray(b)
        _close(a.grad, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))


def test_overflow_drops_tokens():
    """A router that sends every token to expert 0 first: past its
    capacity the pairs are dropped, a token whose pairs all drop gets zero
    output, and the layer still matches JAX."""
    d, jd = _dims(top_k=1, capacity_factor=1.0)
    p, jp = _params(d, jd, seed=4)
    bias = np.zeros((d.d_model, d.n_experts), np.float32)
    bias[:, 0] = 5.0
    p["router"] = p["router"] + torch.from_numpy(bias)
    jp = dict(jp, router=jp["router"] + bias)
    x = np.abs(np.random.default_rng(4).standard_normal((1, 64, d.d_model))).astype(np.float32)
    C = moe.capacity(d, 64)
    probs = torch.softmax(torch.from_numpy(x[0]) @ p["router"], -1)
    r = moe.route(probs, d, C)
    dropped = (r["slot_of_token"] == d.n_experts * C).all(-1)
    assert int(dropped.sum()) == 64 - C > 0
    got = moe.moe_ffn(p, d, torch.from_numpy(x))[0]
    assert bool((got[dropped] == 0).all()) and bool((got[~dropped] != 0).any(-1).all())
    _close(got, np.asarray(jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, jd, x_))(jp, x))[0],
           atol=1e-6)


def test_aux_load_balance_loss_matches_jax():
    d, jd = _dims()
    p, jp = _params(d, jd, seed=6)
    x = np.random.default_rng(6).standard_normal((2, 32, d.d_model)).astype(np.float32)
    _close(moe.aux_load_balance_loss(p, d, torch.from_numpy(x)),
           jmoe.aux_load_balance_loss(jp, jd, jnp.asarray(x)))


@pytest.mark.parametrize("J", [1, 2, 4])
def test_gather_rows_backward_is_the_scatter_add_gradient(J):
    """``gather_rows(src, idx, inv)`` against autograd's own index of the
    zero-padded source, whose backward scatter-adds: values and gradients
    bitwise on the CPU, the J terms of a row added in slot order."""
    rng = np.random.default_rng(J)
    n, m, D = 40, 64, 8
    # every source row read by at most J positions; the rest read the pad
    idx = np.full(m, n)
    pos = rng.permutation(m)[: min(m, n * J)]
    idx[pos] = np.repeat(np.arange(n), J)[: len(pos)]
    inv = np.full((n, J), m)
    for r in range(n):
        hits = np.nonzero(idx == r)[0]
        inv[r, : len(hits)] = hits
    src = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, D)).astype(np.float32))
    a = src.clone().requires_grad_(True)
    out = moe.gather_rows(a, torch.from_numpy(idx), torch.from_numpy(inv))
    out.backward(g)
    b = src.clone().requires_grad_(True)
    ref = torch.cat([b, b.new_zeros((1, D))])[torch.from_numpy(idx)]
    ref.backward(g)
    assert torch.equal(out, ref)
    assert torch.equal(a.grad, b.grad)


def test_moe_ffn_backward_is_the_scatter_add_gradient(monkeypatch):
    """The whole layer's gradients through the gather functions against
    the same layer with plain indexing (autograd's scatter-add backward)."""
    d, jd = _dims(top_k=2, shared_expert=True, shared_d_ff=24)
    p, _ = _params(d, jd, seed=7)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 16, d.d_model))
                         .astype(np.float32))

    def plain(src, idx, inv):
        return torch.cat([src, src.new_zeros((1, *src.shape[1:]))])[idx]

    grads = []
    for fn in (moe.gather_rows, plain):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items() if k != "shared"}
        leaves["shared"] = {k: v.clone().requires_grad_(True) for k, v in p["shared"].items()}
        xt = x.clone().requires_grad_(True)
        monkeypatch.setattr(moe, "gather_rows", fn)
        moe.moe_ffn(leaves, d, xt).square().sum().backward()
        grads.append([xt.grad] + [leaves[k].grad for k in ("router", "w_down", "w_gate",
                                                            "w_up")])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
