"""Attention: GQA with RoPE and chunked-causal training, the train path of
``repro.models.attention`` (serving's prefill, decode, cross-attention and
KV caches are ROADMAP Queue 1, item 3).

As in the JAX package, training scans over query chunks, so the live
working set is one ``[B, H, cq, S_kv]`` block, and a sliding window slices
each chunk's KV range, keeping FLOPs linear in S.  The scores, masks and
softmax are the JAX package's plain ops, not a fused attention call, so the
port holds to the JAX package on the CPU.
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
