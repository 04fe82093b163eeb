"""AdamW with f32 moments, built from scratch (port of
``repro.training.optimizer``).

Moments are f32 trees shaped like their parameters.  The update is
functional, as in the JAX package: it returns new tensors and leaves its
inputs as they are, so a caller may keep the previous step (a checkpoint,
a test's reference)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import reduced, tree_leaves, tree_map
from repro_torch.streaming import prng


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor  # i32 scalar
    mu: Any  # f32, like params
    nu: Any  # f32, like params


def adamw_init(params) -> AdamWState:
    leaf = tree_leaves(params)[0]
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaf.device), mu=zeros,
                      nu=tree_map(torch.clone, zeros))


def global_norm(grads) -> torch.Tensor:
    """The f32 global norm of a gradient tree, as the JAX package takes it:
    leaf sums of squares added in ``jax.tree.leaves`` order, plus 1e-20,
    and the correctly rounded square root.  Under a dry-run mesh each leaf's
    partial sum is all-reduced before it is added."""
    total = None
    for g in tree_leaves(grads):
        s = reduced(g.to(torch.float32).square().sum())
        total = s if total is None else total + s
    return prng.sqrt_f32(total + 1e-20)


def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """Returns (new_params, new_state, grad_norm); the norm is the one
    before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / gnorm, max=1.0)

    step = state.step + 1
    t = step.to(torch.float32)
    # the bias corrections by XLA's f32 pow (glibc's powf), which the JAX
    # package's ``b ** step`` computes
    c1 = 1.0 - prng.pow_f32(torch.tensor(b1, device=t.device), t)
    c2 = 1.0 - prng.pow_f32(torch.tensor(b2, device=t.device), t)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g.square()
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t3: t3[i], out)
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), gnorm
