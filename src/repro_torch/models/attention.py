"""Attention: GQA with RoPE, chunked-causal training and prefill, KV-cache
decode, sliding windows, and the encoder-decoder's cross-attention (port of
``repro.models.attention``).

As in the JAX package, training and prefill scan over query chunks, so the
live working set is one ``[B, H, cq, S_kv]`` block, and a sliding window
slices each chunk's KV range, keeping FLOPs linear in S.  The scores, masks
and softmax are the JAX package's plain ops, not a fused attention call, so
the port holds to the JAX package on the CPU.

Decode writes the new token's keys and values into the cache in place (one
``index_copy_`` each, at the ring slot ``position % T``), where the JAX
package returns a new cache: the cache passed in is consumed.  ``position``
may be a Python int or an integer tensor on the cache's device; it is never
read back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import (
    BATCH, apply_rope, axis_size, dense_init, grad_placed, is_sharded, local_rank, mesh_axes,
    per_shard, shard, shard_like,
)
from repro_torch.streaming import prng

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full
    causal: bool = True
    n_heads_padded: int = 0  # 0 -> n_heads (set via flags.pad_heads for TP)

    @property
    def hp(self) -> int:
        return self.n_heads_padded or self.n_heads

    def kv_expand_idx(self, device=None) -> torch.Tensor:
        """Expanded-kv index map: q head h (h < H) uses kv group
        h // (H // K); pad heads map to group 0 (masked dead anyway)."""
        H, K = self.n_heads, self.n_kv_heads
        idx = torch.arange(self.hp, device=device) // max(1, H // K)
        return torch.clamp(idx, max=K - 1)

    def head_mask(self, dtype, device=None) -> torch.Tensor | None:
        if self.hp == self.n_heads:
            return None
        return (torch.arange(self.hp, device=device) < self.n_heads).to(dtype)


def init_attn(key, dims: AttnDims, dtype) -> dict:
    ks = prng.split(key, 4)
    D, Hp, K, hd = dims.d_model, dims.hp, dims.n_kv_heads, dims.head_dim
    wq = dense_init(ks[0], (D, Hp * hd), dtype)
    wo = dense_init(ks[3], (Hp * hd, D), dtype, fan_in=dims.n_heads * hd)
    if Hp != dims.n_heads:
        # pad heads are exact zeros; output-masking keeps their grads zero,
        # so they remain zero forever — the math is the unpadded architecture
        col = (torch.arange(Hp * hd, device=wq.device) // hd) < dims.n_heads
        wq = wq * col[None, :].to(wq.dtype)
        wo = wo * col[:, None].to(wo.dtype)
    return {
        "wq": wq,
        "wk": dense_init(ks[1], (D, K * hd), dtype),
        "wv": dense_init(ks[2], (D, K * hd), dtype),
        "wo": wo,
    }


def _expand_kv(x: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """``[B, T, K, hd]`` to the ``Hp`` query heads (``kv_expand_idx``).
    Without pad heads each kv head repeats ``H // K`` times in place, by a
    broadcast whose backward sums each group (an index select's backward
    adds by atomics on the card)."""
    B, T, K, hd = x.shape
    G = max(1, dims.n_heads // K)
    if is_sharded(x):
        return _expand_kv_sharded(x, dims)
    if dims.hp == dims.n_heads == K * G:
        return x[:, :, :, None].expand(B, T, K, G, hd).reshape(B, T, K * G, hd)
    return x.index_select(2, dims.kv_expand_idx(x.device))


def _expand_kv_sharded(x: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """:func:`_expand_kv` under a dry-run mesh, on each device: its query
    heads' kv heads selected from the kv heads it holds whole, the query
    heads over ``model`` where they divide it (JAX's ``take`` onto the
    constrained layout).  The gradient of the kv heads is each device's
    part, summed over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    m = axis_size("model")
    split = dims.hp % m == 0
    x = shard(x, BATCH, None, None, None)
    axes = mesh_axes()
    out = tuple(Shard(2) if n == "model" and split else p for n, p in zip(axes, x.placements))
    grad = tuple(Partial() if n == "model" and split else p for n, p in zip(axes, x.placements))
    h = dims.hp // m if split else dims.hp
    idx = dims.kv_expand_idx()[local_rank("model") * h:][:h] if split else dims.kv_expand_idx()
    return per_shard(lambda t: t.index_select(2, idx.to(t.device)), out, x,
                     grad_placements=(grad,))


def _merge_heads(o: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """``[B, S, Hp, hd]`` to ``[B, S, Hp * hd]``, the pad heads' outputs
    zeroed (so wo's pad rows stay zero-gradient); under a dry-run mesh on
    each device's heads (DTensor gathers the backward of the reshape)."""
    B, S, Hp, hd = o.shape
    if not is_sharded(o):
        return _mask_pad_heads(o, dims).reshape(B, S, Hp * hd)
    sharded = any(p.is_shard(2) for p in o.placements)
    h = Hp // axis_size("model") if sharded else Hp
    lo = local_rank("model") * h if sharded else 0
    mask = dims.head_mask(o.dtype)
    mask = None if mask is None else mask[lo:lo + h]

    def merge(t):
        t = t if mask is None else t * mask.to(t.device)[None, None, :, None]
        return t.reshape(*t.shape[:2], -1)

    return per_shard(merge, o.placements, o)


def _heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """A projection ``[B, S, n * hd]`` as ``[B, S, n, hd]``.  Under a
    dry-run mesh whose ``model`` axis does not divide ``n``, the flat dim
    is first gathered over it: DTensor cannot unflatten an uneven shard."""
    if is_sharded(y) and n % axis_size("model"):
        y = shard(y, BATCH, None, None)
    return y.reshape(*y.shape[:2], n, hd)


def _project_qkv(params, dims: AttnDims, x, positions):
    """Project + RoPE + expand KV heads to Hp (explicit GQA replication)."""
    K, hd, Hp = dims.n_kv_heads, dims.head_dim, dims.hp
    q = _heads(x @ params["wq"], Hp, hd)
    k = _heads(x @ params["wk"], K, hd)
    v = _heads(x @ params["wv"], K, hd)
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    q = shard(q, ("pod", "data"), None, "model", None)
    k = shard(_expand_kv(k, dims), ("pod", "data"), None, "model", None)
    v = shard(_expand_kv(v, dims), ("pod", "data"), None, "model", None)
    return q, k, v


def _mask_pad_heads(o, dims: AttnDims):
    """Zero the pad heads' outputs so wo's pad rows stay zero-gradient."""
    m = dims.head_mask(o.dtype, o.device)
    return o if m is None else o * m[None, None, :, None]


def _gqa_scores(q, k):  # q:[B,cq,H,hd] k:[B,T,H,hd] -> [B,H,cq,T]
    hd = q.shape[-1]
    return torch.einsum("bqhd,bthd->bhqt", q, k) / math.sqrt(hd)


def _gqa_out(p, v):  # p:[B,H,cq,T] v:[B,T,H,hd] -> [B,cq,H,hd]
    return torch.einsum("bhqt,bthd->bqhd", p, v)


def attend_chunked(q, k, v, **kw) -> torch.Tensor:
    """:func:`_attend_chunked` on each device's (batch, head) shard under a
    dry-run mesh, ``k`` and ``v`` placed as ``q``: each device's chunks
    and their backward are its own, as GSPMD partitions the einsums (a
    DTensor backward gathers the heads its forward kept sharded)."""
    k, v = shard_like(k, q), shard_like(v, q)
    return per_shard(lambda q_, k_, v_: _attend_chunked(q_, k_, v_, **kw),
                     getattr(q, "placements", None), q, k, v)


def _attend_chunked(
    q: torch.Tensor,  # [B, S, H, hd] (RoPE applied)
    k: torch.Tensor,  # [B, T, H, hd]
    v: torch.Tensor,  # [B, T, H, hd]
    *,
    causal: bool,
    sliding_window: int = 0,
    q_chunk: int = 512,
    q_offset: int = 0,  # absolute position of q[0] (prefill continuation)
) -> torch.Tensor:
    """Loop over query chunks; each chunk sees only its legal KV range.

    Full-causal: every chunk scores all T keys and masks those past its
    queries, as the JAX package's scan does.  Sliding window: the kv range
    is a fixed-width slice around the chunk, so both memory and FLOPs are
    O(S·w) instead of O(S²)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    cq = min(q_chunk, S)
    if S % cq != 0:  # fall back to the largest chunk that divides S
        cq = math.gcd(S, cq)
    n = S // cq
    dev = q.device
    out = []
    for i in range(n):
        qb = q[:, i * cq:(i + 1) * cq]
        q_abs0 = q_offset + i * cq
        qpos = q_abs0 + torch.arange(cq, device=dev)
        if sliding_window and causal:
            w = sliding_window
            kv_span = min(T, ((w + cq + cq - 1) // cq) * cq)  # window + chunk, padded
            lo = min(max(0, q_abs0 + cq - kv_span), T - kv_span)  # dynamic_slice clamps
            kb, vb = k[:, lo:lo + kv_span], v[:, lo:lo + kv_span]
            kpos = lo + torch.arange(kv_span, device=dev)
            ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - w)
        else:
            kb, vb = k, v
            ok = torch.arange(T, device=dev)[None, :] <= qpos[:, None] if causal else None
        s = _gqa_scores(qb, kb)
        if ok is not None:
            s = torch.where(ok[None, None], s, NEG)
        p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
        out.append(_gqa_out(p, vb))
    return torch.cat(out, dim=1)


def attn_train(params, dims: AttnDims, x, *, q_chunk: int = 512):
    """Self-attention over a full sequence (training / encoder)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, dims, x, pos)
    o = attend_chunked(q, k, v, causal=dims.causal, sliding_window=dims.sliding_window,
                       q_chunk=q_chunk)
    return grad_placed(_merge_heads(o, dims)) @ params["wo"]


def attn_cross(params, dims: AttnDims, x, enc_kv, *, q_chunk: int = 512):
    """Cross-attention (decoder over encoder KV, non-causal, no RoPE)."""
    B, S, _ = x.shape
    Hp, hd = dims.hp, dims.head_dim
    q = shard(_heads(x @ params["wq"], Hp, hd), ("pod", "data"), None, "model", None)
    o = attend_chunked(q, enc_kv["k"], enc_kv["v"], causal=False, q_chunk=q_chunk)
    return grad_placed(_merge_heads(o, dims)) @ params["wo"]


def cross_kv(params, dims: AttnDims, enc_out):
    """The encoder's keys and values for :func:`attn_cross`, expanded to
    the ``Hp`` query heads by :func:`_expand_kv`'s broadcast."""
    K, hd = dims.n_kv_heads, dims.head_dim
    k = _heads(enc_out @ params["wk"], K, hd)
    v = _heads(enc_out @ params["wv"], K, hd)
    return {"k": shard(_expand_kv(k, dims), ("pod", "data"), None, "model", None),
            "v": shard(_expand_kv(v, dims), ("pod", "data"), None, "model", None)}


def attn_prefill(params, dims: AttnDims, x, *, q_chunk: int = 512):
    """Causal self-attention that also returns the KV cache, ``{"k", "v"}``
    ``[B, S, Hp, hd]`` (the kv heads expanded to the query heads)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, dims, x, pos)
    o = attend_chunked(q, k, v, causal=True, sliding_window=dims.sliding_window,
                       q_chunk=q_chunk)
    return _merge_heads(o, dims) @ params["wo"], {"k": k, "v": v}


def position_tensor(position, device) -> torch.Tensor:
    """``position`` (a Python int or an integer tensor) as a one-element
    int64 tensor on ``device``, made there without a host round trip."""
    if isinstance(position, torch.Tensor):
        return position.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(position), dtype=torch.int64, device=device)


def _write_slot(c: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``c[:, slot] = new`` in place (``index_copy_``); under a dry-run
    mesh on each device's shard, ``new`` placed as the cache first
    (DTensor has no ``index_copy_`` in every version, and where it has one
    it relabels the cache rather than keep its placement)."""
    if not is_sharded(c):
        c.index_copy_(1, slot, new)
        return
    per_shard(lambda cl, nl: cl.index_copy_(1, slot, nl), c.placements, c, shard_like(new, c))


def attn_decode(params, dims: AttnDims, x, cache, position):
    """One-token decode against a fixed-size KV cache.

    cache: ``{"k": [B, T, Hp, hd], "v": ...}``, written in place: the new
    token's keys and values go to the ring slot ``position % T`` of the
    tensors given, which are returned.  ``position`` is the index of the
    new token.  Returns (out [B, 1, D], cache)."""
    pos = position_tensor(position, x.device)
    # decode 2D plan: contract D over `data` in place of FSDP weight gathers
    x = shard(x, None, None, ("data",))
    q, k_new, v_new = _project_qkv(params, dims, x, pos[None])
    # the cache stores the Hp expanded heads, as the JAX package's does (the
    # Hp/K memory amplification of low-kv archs is its known trade-off)
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    slot = pos % T
    _write_slot(ck, slot, k_new)
    _write_slot(cv, slot, v_new)

    # under a dry-run mesh on each device's (batch, head) shard, the cache
    # placed as the query (DTensor's einsums cannot take the batch-replicated
    # cache beside the batch-sharded query)
    o = per_shard(lambda q_, k_, v_: _attend_cache(q_, k_, v_, pos, dims),
                  getattr(q, "placements", None), q, shard_like(ck, q), shard_like(cv, q))
    o = shard(_merge_heads(o, dims), None, None, "model")
    return shard(o @ params["wo"], None, None, ("data",)), cache


def _attend_cache(q, ck, cv, pos, dims: AttnDims):
    """One query position ``pos`` against the cache: ``[B, 1, H, hd]``."""
    T = ck.shape[1]
    s = _gqa_scores(q, ck)  # [B,H,1,T]
    kpos = torch.arange(T, device=q.device)
    visible = kpos <= pos
    # ring semantics: when the cache is exactly the window (T <= w) every
    # resident slot is in-window by construction; only a larger cache needs
    # the explicit sliding mask.
    if dims.sliding_window and T > dims.sliding_window:
        visible = visible & (kpos > pos - dims.sliding_window)
    s = torch.where(visible, s, NEG)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return _gqa_out(p, cv)


def init_cache(dims: AttnDims, B: int, T: int, dtype, device=None) -> dict:
    Hp, hd = dims.hp, dims.head_dim
    return {
        "k": torch.zeros((B, T, Hp, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, T, Hp, hd), dtype=dtype, device=device),
    }
