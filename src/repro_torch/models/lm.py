"""Model assembly (port of ``repro.models.lm``): init, train-forward,
prefill and decode of every family.

Families:
  dense / vlm        : decoder-only transformer (GQA + SwiGLU); vlm prepends a
                       stub patch-embedding prefix to the token embeddings.
  moe                : same skeleton, FFN replaced by MoE every
                       ``moe_every``-th layer (a macro layer of
                       ``moe_every - 1`` dense blocks and one MoE block keeps
                       the stack homogeneous).
  ssm                : pure Mamba1 stack (attention-free).
  hybrid             : Mamba2 stack with ONE shared-weight attention block
                       applied after every ``hybrid_attn_every`` mamba layers
                       (zamba2); macros of [every x mamba + shared attn],
                       plus an unscanned tail of mamba layers.  The shared
                       block's gradient is the sum over its uses, added by
                       autograd in program order.
  audio (enc-dec)    : bidirectional encoder over stub frame embeddings +
                       causal decoder with cross-attention (seamless).

As in the JAX package, a stack's parameters are stacked over layers and
the layer body is rematerialised in the backward pass
(``torch.utils.checkpoint``, the port's ``jax.checkpoint``); a nested
stack (a macro's layers) runs as a plain loop inside the checkpointed body.

Serving (``prefill``, ``prefill_encdec``, ``decode_step``) runs without
autograd, a plain loop over the layers.  Its caches have the JAX package's
layout leaf for leaf (``_cache_spec``: stacked over layers like the
parameters), but ``decode_step`` writes each layer's new keys and values,
SSM state and conv tail into the cache given, in place, where the JAX
package returns a new one: the cache passed in is consumed.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import flags
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnDims
from repro_torch.models.common import (
    BATCH, embed, embed_init, fsdp, init_rmsnorm, new_stacked, residual, rmsnorm, shard,
    tree_leaves, tree_map, unembed_logits, unembed_loss, unshard_dim0,
)
from repro_torch.models.mlp import init_mlp, mlp_ffn
from repro_torch.models.moe import MoEDims
from repro_torch.models.ssm import SSMDims
from repro_torch.streaming import prng


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


def moe_dims(cfg: ArchConfig) -> MoEDims:
    return MoEDims(
        d_model=cfg.d_model,
        n_experts=cfg.moe_experts,
        top_k=cfg.moe_top_k,
        d_ff=cfg.moe_d_ff or cfg.d_ff,
        capacity_factor=cfg.capacity_factor,
        shared_expert=cfg.moe_shared_expert,
        shared_d_ff=cfg.d_ff,
    )


def ssm_dims(cfg: ArchConfig) -> SSMDims:
    return SSMDims(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand,
        version=cfg.ssm_version,
        n_heads=cfg.ssm_heads,
    )


# --------------------------------------------------------------------------
# single blocks
# --------------------------------------------------------------------------


def _lead(key) -> tuple:
    """The key batch's shape and device: a stacked initializer's leading
    axes."""
    return tuple(key[0].shape), key[0].device


def init_dense_block(key, cfg: ArchConfig, dtype) -> dict:
    k1, k2 = prng.split(key, 2)
    lead, dev = _lead(key)
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "attn": attn.init_attn(k1, attn_dims(cfg), dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "mlp": init_mlp(k2, cfg.d_model, cfg.d_ff, dtype),
    }


def dense_block(p, cfg: ArchConfig, h, *, q_chunk=512):
    h = residual(h, attn.attn_train(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps),
                                    q_chunk=q_chunk))
    h = residual(h, mlp_ffn(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps)))
    return h


def init_moe_block(key, cfg: ArchConfig, dtype) -> dict:
    k1, k2 = prng.split(key, 2)
    lead, dev = _lead(key)
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "attn": attn.init_attn(k1, attn_dims(cfg), dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "moe": moe_lib.init_moe(k2, moe_dims(cfg), dtype),
    }


def moe_block(p, cfg: ArchConfig, h, *, q_chunk=512):
    h = residual(h, attn.attn_train(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps),
                                    q_chunk=q_chunk))
    h = residual(h, moe_lib.moe_ffn(p["moe"], moe_dims(cfg), rmsnorm(h, p["ln2"], cfg.norm_eps)))
    return h


def init_mamba_block(key, cfg: ArchConfig, dtype) -> dict:
    lead, dev = _lead(key)
    return {
        "ln": init_rmsnorm(cfg.d_model, dtype, lead, dev),
        "mamba": ssm_lib.init_mamba(key, ssm_dims(cfg), dtype),
    }


def mamba_block(p, cfg: ArchConfig, h, state=None, conv=None, chunk=256):
    y, st = ssm_lib.mamba_forward(
        p["mamba"], ssm_dims(cfg), rmsnorm(h, p["ln"], cfg.norm_eps),
        state=state, conv_prev=conv, chunk=chunk,
    )
    return residual(h, y), st


# --------------------------------------------------------------------------
# parameter init for the whole model
# --------------------------------------------------------------------------


def _stacked(init_fn, key, n: int):
    """``jax.vmap(init_fn)(jax.random.split(key, n))``: ``init_fn`` draws
    for the key batch of the ``n`` split keys at once (``key`` may itself
    be a batch, as in a stack of stacks)."""
    return init_fn(prng.split_keys(key, n))


def init_params(cfg: ArchConfig, key: prng.Key, dtype=torch.bfloat16) -> dict:
    """The JAX package's ``init_params(cfg, key, dtype)`` bit for bit, on
    the device of ``key`` (``prng.prng_key(seed, device)``)."""
    ks = prng.split(key, 8)
    dev = key[0].device
    p: dict[str, Any] = {
        "embed": embed_init(ks[0], (cfg.vocab, cfg.d_model), dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(ks[1], (cfg.vocab, cfg.d_model), dtype)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["layers"] = _stacked(lambda k: init_dense_block(k, cfg, dtype), ks[2], cfg.n_layers)
    elif fam == "moe":
        every = cfg.moe_every
        n_macro = cfg.n_layers // every
        if every == 1:
            p["layers"] = _stacked(lambda k: init_moe_block(k, cfg, dtype), ks[2], n_macro)
        else:
            # macro layer = (every-1) dense + 1 moe
            p["layers"] = _stacked(
                lambda k: {
                    "dense": _stacked(lambda kk: init_dense_block(kk, cfg, dtype), k, every - 1),
                    "moe": init_moe_block(prng.fold_in(k, 7), cfg, dtype),
                },
                ks[2],
                n_macro,
            )
    elif fam == "ssm":
        p["layers"] = _stacked(lambda k: init_mamba_block(k, cfg, dtype), ks[2], cfg.n_layers)
    elif fam == "hybrid":
        every = cfg.hybrid_attn_every
        n_macro = cfg.n_layers // every
        tail = cfg.n_layers % every
        p["layers"] = _stacked(
            lambda k: _stacked(lambda kk: init_mamba_block(kk, cfg, dtype), k, every),
            ks[2],
            n_macro,
        )
        if tail:
            p["tail"] = _stacked(lambda k: init_mamba_block(k, cfg, dtype), ks[3], tail)
        p["shared_attn"] = {
            "ln": init_rmsnorm(cfg.d_model, dtype, device=dev),
            "attn": attn.init_attn(ks[4], attn_dims(cfg), dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device=dev),
            "mlp": init_mlp(ks[5], cfg.d_model, cfg.d_ff, dtype),
        }
    elif fam == "audio":  # encoder-decoder
        def enc_layer(k):
            lead, kdev = _lead(k)
            return {
                "ln1": init_rmsnorm(cfg.d_model, dtype, lead, kdev),
                "attn": attn.init_attn(k, attn_dims(cfg, causal=False), dtype),
                "ln2": init_rmsnorm(cfg.d_model, dtype, lead, kdev),
                "mlp": init_mlp(prng.fold_in(k, 3), cfg.d_model, cfg.d_ff, dtype),
            }

        def dec_layer(k):
            lead, kdev = _lead(k)
            return {
                "ln1": init_rmsnorm(cfg.d_model, dtype, lead, kdev),
                "attn": attn.init_attn(k, attn_dims(cfg), dtype),
                "lnx": init_rmsnorm(cfg.d_model, dtype, lead, kdev),
                "xattn": attn.init_attn(prng.fold_in(k, 5), attn_dims(cfg, causal=False), dtype),
                "ln2": init_rmsnorm(cfg.d_model, dtype, lead, kdev),
                "mlp": init_mlp(prng.fold_in(k, 3), cfg.d_model, cfg.d_ff, dtype),
            }

        p["enc_layers"] = _stacked(enc_layer, ks[2], cfg.enc_layers)
        p["enc_norm"] = init_rmsnorm(cfg.d_model, dtype, device=dev)
        p["layers"] = _stacked(dec_layer, ks[3], cfg.dec_layers)
    else:
        raise ValueError(fam)
    return p


# --------------------------------------------------------------------------
# forward (training / scoring): tokens -> loss
# --------------------------------------------------------------------------


def _layers(stack_params) -> list:
    """The layers of a stacked tree, in order.  The stack is unbound once,
    so its gradient is one stack of the layers' gradients.  Under a
    dry-run mesh a leaf sharded along its layer axis (a right-aligned spec
    that reaches it, as the MoE shared expert's) is gathered first: DTensor
    cannot unbind a sharded dim."""
    layers = tree_map(lambda x: unshard_dim0(x).unbind(0), stack_params)
    n = tree_leaves(stack_params)[0].shape[0]
    return [tree_map(lambda xs: xs[i], layers) for i in range(n)]


def _gathered(stack_params):
    """:func:`_layers`, each layer's parameters gathered at use under a
    dry-run mesh (``common.fsdp``)."""
    return (fsdp(p) for p in _layers(stack_params))


def _scan_layers(stack_params, body, h, remat: bool = True):
    """``body`` over the layers of a stacked tree, in order, each layer
    rematerialised in the backward pass when ``remat`` (its parameters
    gathered inside, under a dry-run mesh, so the recompute gathers them
    again)."""

    def layer(hh, p):
        return body(hh, fsdp(p))

    for p_l in _layers(stack_params):
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer, h, p_l, use_reentrant=False)
        else:
            h = layer(h, p_l)
    return h


def _decoder_stack(cfg: ArchConfig, params, h, *, q_chunk=512, ssm_chunk=256, remat=True):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        h = _scan_layers(params["layers"],
                         lambda hh, p: dense_block(p, cfg, hh, q_chunk=q_chunk), h, remat)
    elif fam == "moe":
        if cfg.moe_every == 1:
            h = _scan_layers(params["layers"],
                             lambda hh, p: moe_block(p, cfg, hh, q_chunk=q_chunk), h, remat)
        else:

            def macro(hh, p):
                for pd in _layers(p["dense"]):
                    hh = dense_block(pd, cfg, hh, q_chunk=q_chunk)
                return moe_block(p["moe"], cfg, hh, q_chunk=q_chunk)

            h = _scan_layers(params["layers"], macro, h, remat)
    elif fam == "ssm":

        def body(hh, p):
            out, _ = mamba_block(p, cfg, hh, chunk=ssm_chunk)
            return out

        h = _scan_layers(params["layers"], body, h, remat)
    elif fam == "hybrid":
        shared = fsdp(params["shared_attn"])

        def macro(hh, p):
            for pm in _layers(p):
                hh, _ = mamba_block(pm, cfg, hh, chunk=ssm_chunk)
            hh = residual(hh, attn.attn_train(shared["attn"], attn_dims(cfg),
                                              rmsnorm(hh, shared["ln"], cfg.norm_eps),
                                              q_chunk=q_chunk))
            return residual(hh, mlp_ffn(shared["mlp"], rmsnorm(hh, shared["ln2"], cfg.norm_eps)))

        h = _scan_layers(params["layers"], macro, h, remat)
        if "tail" in params:

            def tail_body(hh, p):
                out, _ = mamba_block(p, cfg, hh, chunk=ssm_chunk)
                return out

            h = _scan_layers(params["tail"], tail_body, h, remat)
    else:
        raise ValueError(fam)
    return h


def _encoder(cfg: ArchConfig, params, enc_embeds, *, q_chunk=512, remat=True):
    """The audio family's bidirectional encoder over ``enc_embeds``, normed."""
    bidir = attn_dims(cfg, causal=False)

    def enc_body(hh, p):
        hh = residual(hh, attn.attn_train(p["attn"], bidir, rmsnorm(hh, p["ln1"], cfg.norm_eps),
                                          q_chunk=q_chunk))
        return residual(hh, mlp_ffn(p["mlp"], rmsnorm(hh, p["ln2"], cfg.norm_eps)))

    enc_h = shard(enc_embeds.to(params["embed"].dtype), BATCH, None, None)
    enc_h = _scan_layers(params["enc_layers"], enc_body, enc_h, remat)
    return rmsnorm(enc_h, params["enc_norm"], cfg.norm_eps)


def _encoder_decoder(cfg: ArchConfig, params, batch: dict, *, q_chunk=512, remat=True):
    """The audio family: the bidirectional encoder over ``enc_embeds``,
    then the causal decoder over the tokens with cross-attention to it."""
    enc_h = _encoder(cfg, params, batch["enc_embeds"], q_chunk=q_chunk, remat=remat)
    bidir = attn_dims(cfg, causal=False)  # the encoder's and the cross-attention's

    def dec_body(hh, p):
        hh = residual(hh, attn.attn_train(p["attn"], attn_dims(cfg),
                                          rmsnorm(hh, p["ln1"], cfg.norm_eps), q_chunk=q_chunk))
        kv = attn.cross_kv(p["xattn"], bidir, enc_h)
        hh = residual(hh, attn.attn_cross(p["xattn"], bidir, rmsnorm(hh, p["lnx"], cfg.norm_eps),
                                          kv, q_chunk=q_chunk))
        return residual(hh, mlp_ffn(p["mlp"], rmsnorm(hh, p["ln2"], cfg.norm_eps)))

    h = shard(embed(batch["tokens"], params["embed"]), BATCH, None, None)
    return _scan_layers(params["layers"], dec_body, h, remat)


def forward_loss(
    cfg: ArchConfig,
    params,
    batch: dict,
    *,
    q_chunk: int = 512,
    ssm_chunk: int = 256,
    remat: bool = True,
) -> torch.Tensor:
    """batch: tokens [B, S_txt] (+ prefix_embeds [B, P, D] for vlm,
    enc_embeds [B, S_enc, D] for audio).  Returns the mean next-token NLL.
    No MoE auxiliary loss is added: the JAX docstring promises one, but its
    code adds none, and the port follows the code."""
    tokens = shard(batch["tokens"], BATCH, None)
    if cfg.is_enc_dec:
        h = _encoder_decoder(cfg, params, dict(batch, tokens=tokens), q_chunk=q_chunk,
                             remat=remat)
    else:
        h = embed(tokens, params["embed"])
        vision = cfg.frontend == "vision" and "prefix_embeds" in batch
        if vision:
            # the embedding's partial sums reduced before the concatenation
            # (DTensor cannot join them to the prefix, as GSPMD does)
            h = shard(h, BATCH, None, None)
            pre = batch["prefix_embeds"].to(h.dtype)  # [B, P, D]
            h = torch.cat([pre, h], dim=1)
        h = shard(h, BATCH, None, None)
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


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------


def _zeros_stacked(lead: tuple, tree, device):
    """Zeros of ``lead + leaf.shape`` for every leaf of ``tree``."""
    return tree_map(lambda x: torch.zeros((*lead, *x.shape), dtype=x.dtype, device=device),
                    tree)


def _cache_spec(cfg: ArchConfig, B: int, T: int, dtype, device=None):
    """Initial cache tree (stacked over layers like the params), zeros on
    ``device``: the JAX package's ``_cache_spec`` leaf for leaf."""
    fam = cfg.family
    meta = torch.device("meta")  # one layer's shapes, allocated nowhere
    if fam in ("dense", "vlm", "moe"):
        n_stack = cfg.n_layers if fam != "moe" else cfg.n_layers // cfg.moe_every
        c = attn.init_cache(attn_dims(cfg), B, T, dtype, meta)
        if fam == "moe" and cfg.moe_every > 1:
            return {"dense": _zeros_stacked((n_stack, cfg.moe_every - 1), c, device),
                    "moe": _zeros_stacked((n_stack,), c, device)}
        return _zeros_stacked((n_stack,), c, device)
    if fam == "ssm":
        h, conv = ssm_lib.init_ssm_state(ssm_dims(cfg), B, dtype, meta)
        return _zeros_stacked((cfg.n_layers,), {"ssm": h, "conv": conv}, device)
    if fam == "hybrid":
        every = cfg.hybrid_attn_every
        n_macro = cfg.n_layers // every
        tail = cfg.n_layers % every
        hh, conv = ssm_lib.init_ssm_state(ssm_dims(cfg), B, dtype, meta)
        # at 500k the shared attention's cache is a ring of the window
        d = attn_dims(cfg, sliding=cfg.long_context_window if T > 65536 else cfg.sliding_window)
        kv_T = min(T, cfg.long_context_window) if T > 65536 else T
        out = _zeros_stacked((n_macro, every), {"ssm": hh, "conv": conv}, device)
        out["kv"] = _zeros_stacked((n_macro,), attn.init_cache(d, B, kv_T, dtype, meta), device)
        if tail:
            out |= _zeros_stacked((tail,), {"tail_ssm": hh, "tail_conv": conv}, device)
        return out
    if fam == "audio":
        c = attn.init_cache(attn_dims(cfg), B, T, dtype, meta)
        # cross-KV computed at prefill, carried separately
        return {"self": _zeros_stacked((cfg.dec_layers,), c, device)}
    raise ValueError(fam)


def pad_cache(cache, T: int):
    """A new cache from a prefill's: the key and value leaves (``"k"``,
    ``"v"``, time on axis -3) grown to ``T`` slots, zeros after the prompt;
    SSM states and conv tails copied.  The JAX package's decode test pads
    the same axis (``jnp.pad`` of every 5-dim leaf, its dense layout)."""
    if isinstance(cache, dict):
        return {k: (_pad_time(v, T) if k in ("k", "v") else pad_cache(v, T))
                for k, v in cache.items()}
    return cache.clone()


def _pad_time(x: torch.Tensor, T: int) -> torch.Tensor:
    out = x.new_zeros((*x.shape[:-3], T, *x.shape[-2:]))
    out[..., :x.shape[-3], :, :] = x
    return out


def _at(tree, idx):
    """The layer ``idx`` of a stacked tree: views, so an in-place write to
    one lands in the stack."""
    return tree_map(lambda x: x[idx], tree)


def _put(stack, idx: tuple, lead: tuple, tree):
    """``tree`` written as layer ``idx`` of a stacked tree of ``lead``
    layers, made at the first write (``jax.lax.scan``'s stacked outputs,
    without a second copy of them).  Returns the stack."""
    if stack is None:
        stack = tree_map(lambda x: new_stacked(x, lead), tree)
    tree_map(lambda s_, x: s_[idx].copy_(x), stack, tree)
    return stack


def _ffn(p, cfg: ArchConfig, x):
    """A block's FFN: its MoE where it has one, else its MLP."""
    if "moe" in p:
        return moe_lib.moe_ffn(p["moe"], moe_dims(cfg), x)
    return mlp_ffn(p["mlp"], x)


def _block_prefill(p, cfg: ArchConfig, h, q_chunk: int):
    """A dense or MoE block over the prompt; returns (h, its kv)."""
    a, kv = attn.attn_prefill(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps),
                              q_chunk=q_chunk)
    h = residual(h, a)
    return residual(h, _ffn(p, cfg, rmsnorm(h, p["ln2"], cfg.norm_eps))), kv


def _block_decode(p, cfg: ArchConfig, h, c, pos):
    """A dense or MoE block's decode step against its cache ``c``
    (written in place)."""
    a, _ = attn.attn_decode(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps), c,
                            pos)
    h = residual(h, a)
    return residual(h, _ffn(p, cfg, rmsnorm(h, p["ln2"], cfg.norm_eps)))


def _shared_block(shared, cfg: ArchConfig, h, attend):
    """The hybrid's shared attention + MLP block; ``attend(x)`` returns
    the attention's (out, kv)."""
    a, kv = attend(rmsnorm(h, shared["ln"], cfg.norm_eps))
    h = residual(h, a)
    return residual(h, mlp_ffn(shared["mlp"], rmsnorm(h, shared["ln2"], cfg.norm_eps))), kv


def _mamba_decode(p, cfg: ArchConfig, h, st, cv):
    """A Mamba block's decode step from the state ``st`` and conv tail
    ``cv``, which are overwritten by the new ones."""
    h, (nst, ncv) = mamba_block(p, cfg, h, state=st, conv=cv, chunk=1)
    st.copy_(nst)
    cv.copy_(ncv)
    return h


def _last_logits(cfg: ArchConfig, params, h):
    """The final norm and unembedding of the last position alone."""
    h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(h, table)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, token: torch.Tensor, position, *,
                enc_kv=None):
    """One-token serve step.  token: [B, 1] int; returns (logits [B, 1, V],
    cache).

    The cache is consumed: each layer's new keys and values go to the ring
    slot ``position % T`` of its ``"k"``/``"v"``, and its new SSM state and
    conv tail over the old, in place; the cache returned is the one given.
    ``position`` (a Python int or an integer tensor on the device) is not
    read back to the host.  ``enc_kv``: the audio family's cross-attention
    keys and values from :func:`prefill_encdec`."""
    h = shard(embed(token, params["embed"]), BATCH, None, None)
    pos = attn.position_tensor(position, h.device)
    fam = cfg.family

    if fam in ("dense", "vlm") or (fam == "moe" and cfg.moe_every == 1):
        for i, p in enumerate(_layers(params["layers"])):
            h = _block_decode(p, cfg, h, _at(cache, i), pos)
    elif fam == "moe":
        for i, p in enumerate(_layers(params["layers"])):
            for j, pd in enumerate(_layers(p["dense"])):
                h = _block_decode(pd, cfg, h, _at(cache["dense"], (i, j)), pos)
            h = _block_decode(p["moe"], cfg, h, _at(cache["moe"], i), pos)
    elif fam == "ssm":
        for i, p in enumerate(_layers(params["layers"])):
            h = _mamba_decode(p, cfg, h, cache["ssm"][i], cache["conv"][i])
    elif fam == "hybrid":
        shared = params["shared_attn"]
        # ring cache == window at 500k: the ring itself enforces the sliding
        # window, so the attention dims carry sliding=0 (see attn_decode).
        d = attn_dims(cfg, sliding=0)
        for i, p in enumerate(_layers(params["layers"])):
            for j, pm in enumerate(_layers(p)):
                h = _mamba_decode(pm, cfg, h, cache["ssm"][i, j], cache["conv"][i, j])
            h, _ = _shared_block(shared, cfg, h, lambda x: attn.attn_decode(
                shared["attn"], d, x, _at(cache["kv"], i), pos))
        if "tail" in params:
            for i, p in enumerate(_layers(params["tail"])):
                h = _mamba_decode(p, cfg, h, cache["tail_ssm"][i], cache["tail_conv"][i])
    elif fam == "audio":
        xdims = attn_dims(cfg, causal=False)
        for i, p in enumerate(_layers(params["layers"])):
            a, _ = attn.attn_decode(p["attn"], attn_dims(cfg),
                                    rmsnorm(h, p["ln1"], cfg.norm_eps), _at(cache["self"], i),
                                    pos)
            h = residual(h, a)
            h = residual(h, attn.attn_cross(p["xattn"], xdims, rmsnorm(h, p["lnx"], cfg.norm_eps),
                                            _at(enc_kv, i), q_chunk=1))
            h = residual(h, mlp_ffn(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps)))
    else:
        raise ValueError(fam)
    return _last_logits(cfg, params, h), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, *, prefix_embeds=None, q_chunk: int = 512,
            ssm_chunk: int = 256):
    """Prefill over a prompt: returns (last-position logits [B, 1, V],
    cache), the cache at the prompt's length (:func:`pad_cache` grows it
    for decode).

    ``prefix_embeds`` [B, P, D]: stub modality frontend output (vlm)
    prepended before the token embeddings; the KV cache then covers P + S
    positions."""
    h = embed(shard(tokens, BATCH, None), params["embed"])
    if prefix_embeds is not None:
        h = shard(h, BATCH, None, None)  # as in forward_loss
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    h = shard(h, BATCH, None, None)
    fam = cfg.family
    cache = None

    if fam in ("dense", "vlm") or (fam == "moe" and cfg.moe_every == 1):
        n = cfg.n_layers // (cfg.moe_every if fam == "moe" else 1)
        for i, p in enumerate(_gathered(params["layers"])):
            h, kv = _block_prefill(p, cfg, h, q_chunk)
            cache = _put(cache, (i,), (n,), kv)
    elif fam == "moe":
        n, every = cfg.n_layers // cfg.moe_every, cfg.moe_every
        dense = moe = None
        for i, p in enumerate(_gathered(params["layers"])):
            for j, pd in enumerate(_layers(p["dense"])):
                h, kv = _block_prefill(pd, cfg, h, q_chunk)
                dense = _put(dense, (i, j), (n, every - 1), kv)
            h, kv = _block_prefill(p["moe"], cfg, h, q_chunk)
            moe = _put(moe, (i,), (n,), kv)
        cache = {"dense": dense, "moe": moe}
    elif fam == "ssm":
        for i, p in enumerate(_gathered(params["layers"])):
            h, (st, cv) = mamba_block(p, cfg, h, chunk=ssm_chunk)
            cache = _put(cache, (i,), (cfg.n_layers,), {"ssm": st, "conv": cv})
    elif fam == "hybrid":
        shared = fsdp(params["shared_attn"])
        every = cfg.hybrid_attn_every
        n_macro = cfg.n_layers // every
        states = kvs = None
        for i, p in enumerate(_gathered(params["layers"])):
            for j, pm in enumerate(_layers(p)):
                h, (st, cv) = mamba_block(pm, cfg, h, chunk=ssm_chunk)
                states = _put(states, (i, j), (n_macro, every), {"ssm": st, "conv": cv})
            h, kv = _shared_block(shared, cfg, h, lambda x: attn.attn_prefill(
                shared["attn"], attn_dims(cfg), x, q_chunk=q_chunk))
            kvs = _put(kvs, (i,), (n_macro,), kv)
        cache = dict(states, kv=kvs)
        if "tail" in params:
            tail = None
            n_tail = cfg.n_layers % every
            for i, p in enumerate(_gathered(params["tail"])):
                h, (st, cv) = mamba_block(p, cfg, h, chunk=ssm_chunk)
                tail = _put(tail, (i,), (n_tail,), {"tail_ssm": st, "tail_conv": cv})
            cache |= tail
    elif fam == "audio":
        raise ValueError("audio prefill goes through prefill_encdec")
    else:
        raise ValueError(fam)
    return _last_logits(cfg, params, h), cache


@torch.no_grad()
def prefill_encdec(cfg: ArchConfig, params, enc_embeds, dec_tokens, *, q_chunk: int = 512):
    """Encoder pass + decoder prefill; returns (logits [B, 1, V],
    self-cache ``{"self": {"k", "v"}}``, cross-KV ``{"k", "v"}``: each
    decoder layer's ``cross_kv`` of the encoder output, stacked)."""
    enc_h = _encoder(cfg, params, enc_embeds, q_chunk=q_chunk, remat=False)
    bidir = attn_dims(cfg, causal=False)  # the cross-attention's
    # the vocab-parallel embedding's partial sums reduced before the norm
    # (DTensor cannot normalise them in place, as GSPMD does)
    h = shard(embed(dec_tokens, params["embed"]), BATCH, None, None)
    n = cfg.dec_layers
    self_kv = enc_kv = None
    for i, p in enumerate(_gathered(params["layers"])):
        a, kv = attn.attn_prefill(p["attn"], attn_dims(cfg), rmsnorm(h, p["ln1"], cfg.norm_eps),
                                  q_chunk=q_chunk)
        h = residual(h, a)
        ekv = attn.cross_kv(p["xattn"], bidir, enc_h)
        h = residual(h, attn.attn_cross(p["xattn"], bidir, rmsnorm(h, p["lnx"], cfg.norm_eps), ekv,
                                        q_chunk=q_chunk))
        h = residual(h, mlp_ffn(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps)))
        self_kv = _put(self_kv, (i,), (n,), kv)
        enc_kv = _put(enc_kv, (i,), (n,), ekv)
    return _last_logits(cfg, params, h), {"self": self_kv}, enc_kv
