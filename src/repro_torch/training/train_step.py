"""The train step factory (port of ``repro.training.train_step``).

``make_train_step`` closes over the ArchConfig and optimizer hyperparams and
returns ``step(params, opt, batch) -> (params, opt, stats)`` — forward loss
(rematerialised layers), backward, global-norm clip, AdamW.  ``stats``
carries the scalars the WCRDT metric lattice folds (loss, tokens,
grad-norm), as 0-d f32 tensors on the parameters' device.  The serve and
prefill steps are ROADMAP Queue 1, item 3.

Every op of a step on the card is deterministic run to run (the embedding's
backward sums repeated tokens in a fixed order, the xent picks its gold
logit elementwise, GQA expands kv heads by a broadcast, and there are no
atomics), so a run restored from a checkpoint continues bit for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWState, adamw_update


def make_train_step(
    cfg: ArchConfig,
    *,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    q_chunk: int = 512,
    ssm_chunk: int = 256,
    remat: bool = True,
    grad_accum: int = 1,
) -> Callable:
    def one_grad(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = lm.forward_loss(cfg, leaves, batch, q_chunk=q_chunk, ssm_chunk=ssm_chunk,
                                   remat=remat)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return loss.detach(), _unflatten(leaves, iter(grads))

    def step(params, opt: AdamWState, batch: dict):
        if grad_accum > 1:
            # microbatch over the leading batch axis, summed in f32 from zero
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            tot_loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(grad_accum):
                loss_i, g = one_grad(params, {k: v[i] for k, v in micro.items()})
                tot_loss = tot_loss + loss_i
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
            loss = tot_loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, grads = one_grad(params, batch)

        new_params, new_opt, gnorm = adamw_update(
            params, grads, opt, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip
        )
        n_tokens = torch.tensor(float(batch["tokens"].numel()), dtype=torch.float32,
                                device=loss.device)
        stats = {"loss": loss, "tokens": n_tokens, "grad_norm": gnorm}
        return new_params, new_opt, stats

    return step


def _unflatten(tree, it):
    """The leaves that ``it`` yields, in ``tree_leaves`` order, as ``tree``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)
