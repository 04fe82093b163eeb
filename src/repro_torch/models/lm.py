"""Model assembly, the training path of ``repro.models.lm`` for the dense
family: init and train-forward of the decoder-only transformer (GQA +
SwiGLU) of the ``dense`` and ``vlm`` families; vlm prepends a stub
patch-embedding prefix to the token embeddings.

The other families (moe, ssm, hybrid, audio) are ROADMAP Queue 1, item 2,
and serving (prefill, decode, caches) item 3: they raise here.  As in the
JAX package, a stack's parameters are stacked over layers and the layer
body is rematerialised in the backward pass (``torch.utils.checkpoint``,
the port's ``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import flags
from repro_torch.models.attention import AttnDims
from repro_torch.models.common import (
    embed, embed_init, init_rmsnorm, rmsnorm, tree_leaves, tree_map, unembed_loss,
)
from repro_torch.models.mlp import init_mlp, mlp_ffn
from repro_torch.streaming import prng

DENSE_FAMILIES = ("dense", "vlm")


def _not_ported(cfg: ArchConfig):
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port has the dense "
        "and vlm families; the others are ROADMAP Queue 1, item 2")


# --------------------------------------------------------------------------
# dims helpers
# --------------------------------------------------------------------------


def attn_dims(cfg: ArchConfig, causal: bool = True, sliding: int | None = None) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        d_model=cfg.d_model,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window if sliding is None else sliding,
        causal=causal,
        n_heads_padded=flags.pad_heads(cfg.n_heads),
    )


# --------------------------------------------------------------------------
# single blocks
# --------------------------------------------------------------------------


def init_dense_block(key, cfg: ArchConfig, dtype) -> dict:
    k1, k2 = prng.split(key, 2)
    lead, dev = tuple(key[0].shape), key[0].device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "attn": attn.init_attn(k1, attn_dims(cfg), dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, dtype),
    }


def dense_block(p, cfg: ArchConfig, h, *, q_chunk=512):
    h = h + attn.attn_train(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps),
                            q_chunk=q_chunk)
    h = h + mlp_ffn(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))
    return h


# --------------------------------------------------------------------------
# parameter init for the whole model
# --------------------------------------------------------------------------


def _stacked(init_fn, key, n: int):
    """``jax.vmap(init_fn)(jax.random.split(key, n))``: ``init_fn`` draws
    for the key batch of the ``n`` split keys at once."""
    return init_fn(prng.split_keys(key, n))


def init_params(cfg: ArchConfig, key: prng.Key, dtype=torch.bfloat16) -> dict:
    """The JAX package's ``init_params(cfg, key, dtype)`` bit for bit, on
    the device of ``key`` (``prng.prng_key(seed, device)``)."""
    if cfg.family not in DENSE_FAMILIES:
        raise _not_ported(cfg)
    ks = prng.split(key, 8)
    dev = key[0].device
    p: dict[str, Any] = {
        "embed": embed_init(ks[0], (cfg.vocab, cfg.d_model), dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(ks[1], (cfg.vocab, cfg.d_model), dtype)
    p["layers"] = _stacked(lambda k: init_dense_block(k, cfg, dtype), ks[2], cfg.n_layers)
    return p


# --------------------------------------------------------------------------
# forward (training / scoring): tokens -> loss
# --------------------------------------------------------------------------


def _scan_layers(stack_params, body, h, remat: bool = True):
    """``body`` over the layers of a stacked tree, in order.  The stack is
    unbound once, so its gradient is one stack of the layers' gradients."""
    layers = tree_map(lambda x: x.unbind(0), stack_params)
    for i in range(tree_leaves(stack_params)[0].shape[0]):
        p_l = tree_map(lambda xs: xs[i], layers)
        if remat and torch.is_grad_enabled():
            h = checkpoint(body, h, p_l, use_reentrant=False)
        else:
            h = body(h, p_l)
    return h


def _decoder_stack(cfg: ArchConfig, params, h, *, q_chunk=512, ssm_chunk=256, remat=True):
    if cfg.family not in DENSE_FAMILIES:
        raise _not_ported(cfg)
    return _scan_layers(params["layers"],
                        lambda hh, p: dense_block(p, cfg, hh, q_chunk=q_chunk), h, remat)


def forward_loss(
    cfg: ArchConfig,
    params,
    batch: dict,
    *,
    q_chunk: int = 512,
    ssm_chunk: int = 256,
    remat: bool = True,
) -> torch.Tensor:
    """batch: tokens [B, S_txt] (+ prefix_embeds [B, P, D] for vlm).
    Returns mean next-token NLL."""
    if cfg.family not in DENSE_FAMILIES:
        raise _not_ported(cfg)
    tokens = batch["tokens"]
    h = embed(tokens, params["embed"])
    vision = cfg.frontend == "vision" and "prefix_embeds" in batch
    if vision:
        pre = batch["prefix_embeds"].to(h.dtype)  # [B, P, D]
        h = torch.cat([pre, h], dim=1)
    h = _decoder_stack(cfg, params, h, q_chunk=q_chunk, ssm_chunk=ssm_chunk, remat=remat)
    if vision:
        h = h[:, batch["prefix_embeds"].shape[1]:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    # next-token: predict t+1 from t
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    mask[:, -1] = 0.0
    return unembed_loss(h, table, labels, mask)
