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

from repro_torch.models.common import apply_rope, dense_init
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
    if dims.hp == dims.n_heads == K * G:
        return x[:, :, :, None].expand(B, T, K, G, hd).reshape(B, T, K * G, hd)
    return x.index_select(2, dims.kv_expand_idx(x.device))


def _project_qkv(params, dims: AttnDims, x, positions):
    """Project + RoPE + expand KV heads to Hp (explicit GQA replication)."""
    B, S, _ = x.shape
    K, hd, Hp = dims.n_kv_heads, dims.head_dim, dims.hp
    q = (x @ params["wq"]).reshape(B, S, Hp, hd)
    k = (x @ params["wk"]).reshape(B, S, K, hd)
    v = (x @ params["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    return q, _expand_kv(k, dims), _expand_kv(v, dims)


def _mask_pad_heads(o, dims: AttnDims):
    """Zero the pad heads' outputs so wo's pad rows stay zero-gradient."""
    m = dims.head_mask(o.dtype, o.device)
    return o if m is None else o * m[None, None, :, None]


def _gqa_scores(q, k):  # q:[B,cq,H,hd] k:[B,T,H,hd] -> [B,H,cq,T]
    hd = q.shape[-1]
    return torch.einsum("bqhd,bthd->bhqt", q, k) / math.sqrt(hd)


def _gqa_out(p, v):  # p:[B,H,cq,T] v:[B,T,H,hd] -> [B,cq,H,hd]
    return torch.einsum("bhqt,bthd->bqhd", p, v)


def attend_chunked(
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
    o = _mask_pad_heads(o, dims)
    o = o.reshape(B, S, dims.hp * dims.head_dim)
    return o @ params["wo"]


def attn_cross(params, dims: AttnDims, x, enc_kv, *, q_chunk: int = 512):
    """Cross-attention (decoder over encoder KV, non-causal, no RoPE)."""
    B, S, _ = x.shape
    Hp, hd = dims.hp, dims.head_dim
    q = (x @ params["wq"]).reshape(B, S, Hp, hd)
    o = attend_chunked(q, enc_kv["k"], enc_kv["v"], causal=False, q_chunk=q_chunk)
    o = _mask_pad_heads(o, dims)
    o = o.reshape(B, S, Hp * hd)
    return o @ params["wo"]


def cross_kv(params, dims: AttnDims, enc_out):
    """The encoder's keys and values for :func:`attn_cross`, expanded to
    the ``Hp`` query heads by :func:`_expand_kv`'s broadcast."""
    B, T, _ = enc_out.shape
    K, hd = dims.n_kv_heads, dims.head_dim
    k = (enc_out @ params["wk"]).reshape(B, T, K, hd)
    v = (enc_out @ params["wv"]).reshape(B, T, K, hd)
    return {"k": _expand_kv(k, dims), "v": _expand_kv(v, dims)}


def attn_prefill(params, dims: AttnDims, x, *, q_chunk: int = 512):
    """Causal self-attention that also returns the KV cache, ``{"k", "v"}``
    ``[B, S, Hp, hd]`` (the kv heads expanded to the query heads)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, dims, x, pos)
    o = attend_chunked(q, k, v, causal=True, sliding_window=dims.sliding_window,
                       q_chunk=q_chunk)
    o = _mask_pad_heads(o, dims)
    o = o.reshape(B, S, dims.hp * dims.head_dim)
    return o @ params["wo"], {"k": k, "v": v}


def position_tensor(position, device) -> torch.Tensor:
    """``position`` (a Python int or an integer tensor) as a one-element
    int64 tensor on ``device``, made there without a host round trip."""
    if isinstance(position, torch.Tensor):
        return position.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(position), dtype=torch.int64, device=device)


def attn_decode(params, dims: AttnDims, x, cache, position):
    """One-token decode against a fixed-size KV cache.

    cache: ``{"k": [B, T, Hp, hd], "v": ...}``, written in place: the new
    token's keys and values go to the ring slot ``position % T`` of the
    tensors given, which are returned.  ``position`` is the index of the
    new token.  Returns (out [B, 1, D], cache)."""
    B = x.shape[0]
    hd, Hp = dims.head_dim, dims.hp
    pos = position_tensor(position, x.device)
    q, k_new, v_new = _project_qkv(params, dims, x, pos[None])
    # the cache stores the Hp expanded heads, as the JAX package's does (the
    # Hp/K memory amplification of low-kv archs is its known trade-off)
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    slot = pos % T
    ck.index_copy_(1, slot, k_new)
    cv.index_copy_(1, slot, v_new)

    s = _gqa_scores(q, ck)  # [B,H,1,T]
    kpos = torch.arange(T, device=x.device)
    visible = kpos <= pos
    # ring semantics: when the cache is exactly the window (T <= w) every
    # resident slot is in-window by construction; only a larger cache needs
    # the explicit sliding mask.
    if dims.sliding_window and T > dims.sliding_window:
        visible = visible & (kpos > pos - dims.sliding_window)
    s = torch.where(visible, s, NEG)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(x.dtype)
    o = _mask_pad_heads(_gqa_out(p, cv), dims).reshape(B, 1, Hp * hd)
    return o @ params["wo"], cache


def init_cache(dims: AttnDims, B: int, T: int, dtype, device=None) -> dict:
    Hp, hd = dims.hp, dims.head_dim
    return {
        "k": torch.zeros((B, T, Hp, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, T, Hp, hd), dtype=dtype, device=device),
    }
