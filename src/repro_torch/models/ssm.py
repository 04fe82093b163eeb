"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2),
port of ``repro.models.ssm``: the full-sequence forward, and decode, the
O(1) single-step update on the carried state and conv tail.

The recurrence h_t = a_t*h_{t-1} + b_t runs as the JAX package runs it, a
*chunked associative scan*: a loop over chunks carrying the [B, ..., N]
state, and inside each chunk a log-depth prefix combine of the
first-order linear-recurrence monoid

    (a1, b1) . (a2, b2) = (a1*a2, a2*b1 + b2),

paired as ``jax.lax.associative_scan`` pairs it (combine neighbours,
recurse on the half, fill in the even elements), in plain tensor ops.  So
each prefix is the same product tree as the JAX package's; XLA's CPU may
contract ``a2*b1 + b2`` into one fused multiply-add, so the two agree to
f32 rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    dense_init, is_sharded, per_shard, redistribute_to, reduced, rmsnorm, shard, shard_like,
)
from repro_torch.streaming import prng


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int
    d_conv: int = 4
    expand: int = 2
    version: int = 1  # 1 = mamba1, 2 = mamba2
    n_heads: int = 0  # mamba2: value heads; 0 -> d_inner // 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def heads(self) -> int:
        return self.n_heads or max(1, self.d_inner // 64)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.heads


# --------------------------------------------------------------------------
# linear-recurrence scan
# --------------------------------------------------------------------------


def _lr_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _fold_state(pa, h, pb):
    """h_t = pa_t * h0 + pb_t: a chunk's prefixes applied to the carried
    state."""
    return pa * h[:, None] + pb


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Elements ``even[0], odd[0], even[1], odd[1], ...`` along axis 1;
    ``even`` is as long as ``odd`` or one longer."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n else pairs


def associative_scan(elems: tuple) -> tuple:
    """Inclusive prefix combine of ``(a, b)`` along axis 1 by
    :func:`_lr_combine`, with ``jax.lax.associative_scan``'s pairing."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _lr_combine(tuple(e[:, 0:-1:2] for e in elems),
                          tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _lr_combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = _lr_combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def chunked_linear_scan(a, b, h0, chunk: int):
    """h_t = a_t * h_{t-1} + b_t along axis=1 (time).

    a, b: [B, L, ...] (``a`` may broadcast against ``b`` in the trailing
    axes); h0: [B, ...].  Returns (h_all [B, L, ...], h_last).  Under a
    dry-run mesh each device scans its own (batch, channel) shard: the
    recurrence runs along time, which no mesh axis splits, and the
    scan's thousands of small ops would each take a DTensor dispatch.
    """
    if is_sharded(b):
        from torch.distributed.tensor import Shard

        b = reduced(b)  # partial sums (a decode's D-sharded step) reduced first
        a = shard_like(a, b)
        h_pl = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim >= 2 else p
                     for p in b.placements)
        if any(p.is_shard(1) for p in b.placements):
            raise ValueError("the scan's time axis cannot be sharded")
        h0 = redistribute_to(h0, h_pl)
        return per_shard(lambda a_, b_, h_: _chunked_linear_scan(a_, b_, h_, chunk),
                         (b.placements, h_pl), a, b, h0)
    return _chunked_linear_scan(a, b, h0, chunk)


def _chunked_linear_scan(a, b, h0, chunk: int):
    L = a.shape[1]
    cl = min(chunk, L)
    if L % cl != 0:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {cl}")
    h, outs = h0, []
    for c in range(L // cl):
        # prefix-combine within the chunk (log-depth, vectorized)
        pa, pb = associative_scan((a[:, c * cl:(c + 1) * cl], b[:, c * cl:(c + 1) * cl]))
        hs = _fold_state(pa, h, pb)
        h = hs[:, -1]
        outs.append(hs)
    return torch.cat(outs, dim=1), h


def causal_conv1d(x, w, prev=None):
    """Depthwise causal conv along time.  x: [B, L, C]; w: [K, C].

    ``prev``: [B, K-1, C] left context (decode / chunk continuation).
    Returns (y [B, L, C], new_prev [B, K-1, C]).
    """
    K = w.shape[0]
    B, L, C = x.shape
    if prev is None:
        prev = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)  # [B, L+K-1, C]
    y = xp[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i]
    tail = xp[:, -(K - 1):] if K > 1 else x.new_zeros((B, 0, C))
    return y, tail


# --------------------------------------------------------------------------
# Mamba1 (falcon-mamba) and Mamba2 (zamba2)
# --------------------------------------------------------------------------


def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 for ``start == 1`` as XLA's
    CPU compiles ``start * (1 - i/d) + stop * (i/d)`` (``d = num - 1``):
    the division becomes a product by ``r = f32(1/d)``, ``stop * (i r)``
    becomes ``i * f32(stop r)``, contracted with the add into one fused
    multiply-add; ``stop`` is the last lane.  Bitwise ``jnp.linspace(1, 16,
    H)`` at the heads of the configs (4 reduced, 112 for zamba2);
    ``torch.linspace`` differs in 44 of 112 lanes."""
    if start != 1.0:
        raise ValueError("only start == 1 is XLA's folded form")
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    r = np.float32(1.0) / np.float32(num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    out = prng.fma(i, float(np.float32(stop) * r), 1.0 - i * float(r))
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def init_mamba(key, dims: SSMDims, dtype) -> dict:
    """The JAX package's ``init_mamba`` bit for bit, for a key or a key
    batch (its shape leading every leaf).  ``dt_proj``, ``dt_bias``,
    ``A_log`` and ``D`` are f32 whatever ``dtype``; ``A_log`` is XLA's
    ``log`` (:func:`prng.xla_log`)."""
    ks = prng.split(key, 8)
    lead, dev = tuple(key[0].shape), key[0].device
    D, Di, N, R = dims.d_model, dims.d_inner, dims.d_state, dims.dt_rank
    f32 = dict(dtype=torch.float32, device=dev)
    p = {
        "in_proj": dense_init(ks[0], (D, 2 * Di), dtype),
        "conv_w": dense_init(ks[1], (dims.d_conv, Di), dtype, fan_in=dims.d_conv),
        "out_proj": dense_init(ks[2], (Di, D), dtype, fan_in=Di),
        "D": torch.ones((*lead, Di), **f32),
    }
    if dims.version == 1:
        # S4D-real init: A = -(1..N) per channel
        a_log = prng.xla_log(torch.arange(1, N + 1, **f32)).expand(*lead, Di, N)
        p |= {
            "x_proj": dense_init(ks[3], (Di, R + 2 * N), dtype),
            "dt_proj": dense_init(ks[4], (R, Di), torch.float32, fan_in=R),
            "dt_bias": torch.zeros((*lead, Di), **f32),
            "A_log": a_log.contiguous(),
        }
    else:  # mamba2: per-head scalar decay + direct B,C,dt projections
        H = dims.heads
        a_log = prng.xla_log(_linspace_f32(1.0, 16.0, H, dev)).expand(*lead, H)
        p |= {
            "bc_proj": dense_init(ks[3], (D, 2 * N), dtype),
            "dt_proj": dense_init(ks[4], (D, H), torch.float32),
            "dt_bias": torch.zeros((*lead, H), **f32),
            "A_log": a_log.contiguous(),
            "gate_norm": torch.zeros((*lead, Di), dtype=dtype, device=dev),
            "D": torch.ones((*lead, H), **f32),
        }
    return p


def _mamba1_abx(params, dims: SSMDims, xc):
    """Per-step SSM coefficients from the conv output.  xc: [B, L, Di]."""
    N, R = dims.d_state, dims.dt_rank
    # the projection's partial sums over `model` reduced before the split
    proj = shard(xc @ params["x_proj"], ("pod", "data"), None, None)  # [B, L, R+2N]
    dt_r, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r.to(torch.float32) @ params["dt_proj"] + params["dt_bias"])  # [B, L, Di]
    A = -torch.exp(params["A_log"])  # [Di, N]
    a = torch.exp(dt[..., None] * A[None, None])  # [B, L, Di, N]
    bx = (dt * xc.to(torch.float32))[..., None] * Bc.to(torch.float32)[..., None, :]
    return a, bx, Cc


def _zeros_state(bx: torch.Tensor, shape: tuple, f32: dict) -> torch.Tensor:
    """A zero initial state; under a dry-run mesh placed as ``bx``'s first
    step (``bx[:, 0]``)."""
    return torch.zeros_like(bx[:, 0]) if is_sharded(bx) else torch.zeros(shape, **f32)


def mamba_forward(params, dims: SSMDims, x, state=None, conv_prev=None, chunk: int = 256):
    """Full-sequence forward.  x: [B, L, D].

    Returns (y [B, L, D], (ssm_state, conv_tail)) so prefill can hand the
    recurrent state to decode.
    """
    B, L, D = x.shape
    Di, N = dims.d_inner, dims.d_state
    f32 = dict(dtype=torch.float32, device=x.device)
    decode = L == 1
    if decode:
        # decode-2D plan: contract D over `data` in place instead of
        # gathering FSDP shards of in/out_proj per token
        x = shard(x, None, None, ("data",))
    xi, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)  # [B, L, Di] each
    xi = shard(xi, ("pod", "data"), None, "model")
    xc, conv_tail = causal_conv1d(xi, params["conv_w"], conv_prev)
    xc = F.silu(xc)

    if dims.version == 1:
        a, bx, Cc = _mamba1_abx(params, dims, xc)
        h0 = state if state is not None else _zeros_state(bx, (B, Di, N), f32)
        hs, h_last = chunked_linear_scan(a, bx, h0, chunk)
        y = torch.einsum("blin,bln->bli", hs, Cc.to(torch.float32))
        y = y + params["D"][None, None] * xc.to(torch.float32)
        y = y.to(x.dtype) * F.silu(z)
    else:
        H, P = dims.heads, dims.head_dim
        bc = x @ params["bc_proj"]
        Bc, Cc = torch.chunk(bc.to(torch.float32), 2, dim=-1)  # [B, L, N]
        dt = F.softplus(x.to(torch.float32) @ params["dt_proj"] + params["dt_bias"])  # [B, L, H]
        A = -torch.exp(params["A_log"])  # [H]
        a = torch.exp(dt * A[None, None])[..., None, None]  # [B, L, H, 1, 1]
        xh = xc.reshape(B, L, H, P).to(torch.float32)
        bx = (dt[..., None] * xh)[..., None] * Bc[:, :, None, None, :]  # [B, L, H, P, N]
        h0 = state if state is not None else _zeros_state(bx, (B, H, P, N), f32)
        hs, h_last = chunked_linear_scan(a, bx, h0, chunk)
        y = torch.einsum("blhpn,bln->blhp", hs, Cc)
        y = y + params["D"][None, None, :, None] * xh
        y = y.reshape(B, L, Di)
        y = rmsnorm(y.to(x.dtype) * F.silu(z), params["gate_norm"], 1e-5)

    yv = y.to(x.dtype)
    if decode:
        yv = shard(yv, None, None, "model")
        out = shard(yv @ params["out_proj"], None, None, ("data",))
    else:
        out = yv @ params["out_proj"]
    return out, (h_last, conv_tail)


def mamba_decode(params, dims: SSMDims, x, state, conv_prev):
    """Single-token step.  x: [B, 1, D]; O(1) state update.  Returns (y,
    (new state, new conv tail)), new tensors: the state given is not
    written."""
    return mamba_forward(params, dims, x, state=state, conv_prev=conv_prev, chunk=1)


def init_ssm_state(dims: SSMDims, B: int, dtype=torch.bfloat16, device=None):
    """Zero ``(h, conv)``: ``h`` is f32 whatever ``dtype`` (``[B, Di, N]``
    for Mamba1, ``[B, H, P, N]`` for Mamba2), the conv tail ``[B, d_conv - 1,
    Di]`` in ``dtype``."""
    if dims.version == 1:
        shape = (B, dims.d_inner, dims.d_state)
    else:
        shape = (B, dims.heads, dims.head_dim, dims.d_state)
    h = torch.zeros(shape, dtype=torch.float32, device=device)
    conv = torch.zeros((B, dims.d_conv - 1, dims.d_inner), dtype=dtype, device=device)
    return h, conv
