"""Shared model building blocks: norms, RoPE, embeddings, init (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the JAX package, so a
JAX parameter tree and the port's map leaf to leaf.  Layers of a
homogeneous stack are stacked along a leading ``[L]`` axis.  The port runs
on one card, so :func:`shard` is the identity (the JAX helper is a no-op
outside a mesh too).

The initializers draw the JAX package's numbers: a key is a
``streaming.prng`` key, and a key batch (the split keys that ``jax.vmap``
maps an initializer over) draws one tensor a key, the key batch's shape
leading.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.streaming import prng

# lanes of one normal draw at a time, over the whole key batch: a
# full-width embedding table, or a stack of full-width layers, would take
# several int64 temporaries of its size otherwise
_DRAW_CHUNK = 1 << 25


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in ``jax.tree.leaves`` order (sorted
    keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """The JAX package's sharding constraint: the identity on one card."""
    return x


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------


def normal(key: prng.Key, shape: tuple) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for every key of a key
    batch: f32 ``key.shape + shape``, drawn at most ``_DRAW_CHUNK`` lanes
    at a time over all the keys (each key's lanes in runs from an offset)."""
    lead = tuple(key[0].shape)
    n = math.prod(shape)
    step = max(1, _DRAW_CHUNK // math.prod(lead))
    if n <= step:
        return prng.normal(key, n).reshape(*lead, *shape)
    out = torch.empty((*lead, n), dtype=torch.float32, device=key[0].device)
    for a in range(0, n, step):
        b = min(n, a + step)
        out[..., a:b] = prng.normal(key, b - a, offset=a)
    return out.reshape(*lead, *shape)


def dense_init(key, shape, dtype, fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    f32 = dict(dtype=torch.float32, device=key[0].device)
    scale = 1.0 / prng.sqrt_f32(torch.tensor(float(max(fan, 1)), **f32))
    return normal(key, shape).mul_(scale).to(dtype)  # in place: one f32 copy at a time


def embed_init(key, shape, dtype) -> torch.Tensor:
    return normal(key, shape).mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with an f32 variance and ``x``'s own dtype elsewhere, as the
    JAX package computes it; ``scale`` is stored as ``scale - 1``."""
    var = x.to(torch.float32).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def init_rmsnorm(d: int, dtype, lead: tuple = (), device=None) -> torch.Tensor:
    """Zeros ``lead + (d,)``: ``lead`` is the key batch's shape of a
    stacked initializer."""
    return torch.zeros((*lead, d), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    e = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / prng.pow_f32(theta, e)


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs`, made once a device: its ``pow`` is some hundred
    small ops, which a layer would otherwise issue twice a call (XLA folds
    them into a constant)."""
    return rope_freqs(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)  # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    sin = torch.sin(ang)[..., None, :]  # [..., S, 1, hd/2]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# embedding / unembedding with chunked softmax-xent (vocab can be 256k)
# --------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``.  ``F.embedding``'s backward on the card sums the
    rows of repeated tokens in a fixed order (no atomics), so a step
    repeats bit for bit."""
    return F.embedding(tokens, table)


def unembed_loss(
    h: torch.Tensor,  # [B, S, D]
    table: torch.Tensor,  # [V, D]
    labels: torch.Tensor,  # [B, S]
    mask: torch.Tensor | None = None,  # [B, S]
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean next-token cross-entropy, computed in sequence chunks so the
    [B, chunk, V] logits block (not [B, S, V]) is the live working set.
    The gold logit is picked by a one-hot select and a sum, whose backward
    is elementwise: a gather's backward scatters by atomics on the card."""
    B, S, D = h.shape
    n_chunks = max(1, S // chunk)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"seq {S} not divisible into {n_chunks} chunks")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    vocab = torch.arange(table.shape[0], device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (h[:, sl] @ table.T).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.where(vocab == labels[:, sl, None], logits, 0.0).sum(-1)
        mb = mask[:, sl].to(torch.float32)
        tot = tot + ((logz - gold) * mb).sum()
        cnt = cnt + mb.sum()
    return tot / torch.clamp(cnt, min=1.0)


def unembed_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return h @ table.T
