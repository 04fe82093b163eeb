"""Mixture-of-Experts FFN: token-choice top-k routing with sort-based
dispatch into capacity-bounded expert buffers (port of
``repro.models.moe``).

As in the JAX package:

  1. route: top-k experts per token (gates renormalized),
  2. sort (expert, token) pairs by expert id,
  3. position-in-expert from the start of each expert's run,
  4. slot maps: which token fills each slot of the ``[E, C]`` buffer
     (overflow = dropped token, capacity-factor semantics; ``E*C`` is the
     trash slot),
  5. batched per-expert FFN (SwiGLU) over ``[E, C, D]``,
  6. gather back and combine with gates.

One card has no ``pod``/``data`` axis, so there is one token group
(``G = 1``), and the decode-time path (``_moe_ffn_decode``, one token a
sequence) computes as ``moe_ffn`` does; a dry-run mesh groups the tokens
by batch shard, as the JAX package does.  Dispatch and combine move rows by
:func:`gather_rows`, whose backward is a gather too: the inverse map
(each token's at most K slots, each slot's one token) exists, so no step
of the layer, forward or backward, adds by atomics, and a step on the
card repeats bit for bit.
The combine adds a token's K expert outputs in slot order (its experts in
ascending order), the order in which XLA's CPU scatter-add visits them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    axis_size, dense_init, grad_placed, is_sharded, local_rank, mesh_axes, per_shard, shard,
)
from repro_torch.models.mlp import init_mlp, mlp_ffn
from repro_torch.streaming import prng


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    shared_expert: bool = False
    shared_d_ff: int = 0  # defaults to d_ff


def init_moe(key, dims: MoEDims, dtype) -> dict:
    """The JAX package's ``init_moe`` bit for bit (a key or a key batch);
    the router is f32 whatever ``dtype``."""
    ks = prng.split(key, 5)
    D, E, Fd = dims.d_model, dims.n_experts, dims.d_ff
    p = {
        "router": dense_init(ks[0], (D, E), torch.float32),  # router in f32
        "w_gate": dense_init(ks[1], (E, D, Fd), dtype),
        "w_up": dense_init(ks[2], (E, D, Fd), dtype),
        "w_down": dense_init(ks[3], (E, Fd, D), dtype, fan_in=Fd),
    }
    if dims.shared_expert:
        p["shared"] = init_mlp(ks[4], D, dims.shared_d_ff or Fd, dtype)
    return p


def capacity(dims: MoEDims, n_tokens: int) -> int:
    c = int(n_tokens * dims.top_k * dims.capacity_factor / dims.n_experts)
    return max(8, ((c + 7) // 8) * 8)  # 8-aligned, as the JAX package tiles


# --------------------------------------------------------------------------
# rows moved by gathers both ways
# --------------------------------------------------------------------------


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))], dim=0)


class GatherRows(torch.autograd.Function):
    """``out = src_pad[idx]``, ``src_pad`` being ``src`` with a zero row
    appended (index ``n``, for a slot or pair that holds nothing).

    ``inv [n, J]`` is the inverse map: the flat positions of ``idx`` that
    hold row ``r`` are ``inv[r]``, padded with ``idx.numel()``.  The
    backward gathers the rows of the gradient through it and adds the J
    terms in order ``j = 0, 1, ...``: a gather, in an order fixed here,
    where autograd's own backward of an index is a scatter-add
    (``index_put_`` with accumulate) whose order on the card is the
    library's choice."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        ctx.idx_shape = idx.shape
        return _pad_row(src)[idx]

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        g = _pad_row(grad.reshape(-1, *grad.shape[len(ctx.idx_shape):]))
        out = g[inv[:, 0]]
        for j in range(1, inv.shape[1]):
            out = out + g[inv[:, j]]
        return out, None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return GatherRows.apply(src, idx, inv)


# --------------------------------------------------------------------------
# routing: steps 1-4
# --------------------------------------------------------------------------


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties towards
    the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, dims: MoEDims, C: int) -> dict:
    """Steps 1-4 of ``moe_ffn`` from the router's probabilities ``[T, E]``.

    Returns the integer maps (the JAX package's ``tok_of_slot`` ``[E*C]``
    with ``T`` for an empty slot, and ``keep`` of each sorted pair) and
    their inverses: ``slot_of_token [T, K]`` (ascending, ``E*C`` for a
    dropped pair), ``pair_of_slot [E*C]`` (the pair ``t*K + k`` in a slot,
    ``T*K`` if empty), ``slot_of_pair [T*K, 1]``, ``pos_of_slot [E*C, 1]``
    (the flat position in ``slot_of_token`` that reads the slot, ``T*K``
    if none); the gates ``[T, K]`` renormalized over the top k."""
    T, E = probs.shape
    K = dims.top_k
    dev = probs.device
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # 2. sort (expert, token) pairs by expert: the keys are unique, so a
    # sort on expert * T + token is lax.sort's two-key sort
    pair = torch.arange(T * K, device=dev)
    key = gate_idx.reshape(T * K) * T + pair // K
    skey, perm = torch.sort(key)
    se, st = skey // T, skey % T

    # 3. position within expert run
    run_start = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    pos_in_e = pair - run_start[se]
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)  # E*C = trash slot

    # 4. slot-side maps and their inverses (kept slots are unique; the trash
    # slot, written many times, is cut off)
    n_slots = E * C
    tok_of_slot = torch.full((n_slots + 1,), T, dtype=torch.int64, device=dev)
    tok_of_slot[slot] = st
    pair_of_slot = torch.full((n_slots + 1,), T * K, dtype=torch.int64, device=dev)
    pair_of_slot[slot] = perm
    slot_of_pair = torch.empty(T * K, dtype=torch.int64, device=dev)
    slot_of_pair[perm] = slot
    slot_of_token = torch.sort(slot_of_pair.reshape(T, K), dim=-1).values
    pos_of_slot = torch.full((n_slots + 1,), T * K, dtype=torch.int64, device=dev)
    pos_of_slot[slot_of_token.reshape(-1)] = pair
    return {
        "gate_vals": gate_vals, "gate_idx": gate_idx, "keep": keep,
        "tok_of_slot": tok_of_slot[:n_slots], "pair_of_slot": pair_of_slot[:n_slots],
        "slot_of_pair": slot_of_pair[:, None], "slot_of_token": slot_of_token,
        "pos_of_slot": pos_of_slot[:n_slots, None],
    }


def moe_ffn(params, dims: MoEDims, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].

    The JAX package's dispatch and combine as slot-side row moves: the
    buffer slot ``s`` reads token ``tok_of_slot[s]``, and token ``t`` adds
    the gated outputs of its kept slots.  One token a sequence (``S ==
    1``) is decode, :func:`_moe_ffn_decode`, as in the JAX package.  Under
    a dry-run mesh the tokens split into one group a batch shard, as the
    JAX package's GShard-style groups (:func:`_grouped`).  No auxiliary
    load-balancing term is added here or in ``lm.forward_loss``: the JAX
    ``forward_loss`` docstring promises one, but its code adds none, and
    the port follows the code (:func:`aux_load_balance_loss` is there to
    call)."""
    B, S, D = x.shape
    if S == 1:
        return _moe_ffn_decode(params, dims, x)
    G = _dp_groups() if is_sharded(x) else 1
    if G > 1 and (B * S) % G == 0 and B % G == 0:
        return _grouped(params, dims, x, G)
    return _one_group(params, dims, x.reshape(B * S, D)).reshape(B, S, D)


def _moe_ffn_decode(params, dims: MoEDims, x: torch.Tensor) -> torch.Tensor:
    """Decode-mode MoE (``S == 1``): the ``B`` tokens as one group with
    ``C = capacity(dims, B)``.  The JAX package's decode path differs from
    its ``moe_ffn`` only in how a mesh shards it (the residual D-sharded
    over ``data``, the buffer's experts over ``model``); its combine, a
    scatter-add in slot order on XLA's CPU, is each token's gather of its K
    slots added in slot order."""
    B, S, D = x.shape
    xf = shard(x.reshape(B * S, D), None, ("data",))
    return _one_group(params, dims, xf, decode=True).reshape(B, S, D)


def _dispatch(router, dims: MoEDims, xf: torch.Tensor, C: int):
    """Steps 1-5 over the ``T`` tokens ``xf [T, D]`` as one group: the
    buffer ``[E, C, D]``, the gate of each slot ``[E*C, 1]`` and the maps
    the combine reads (``slot_of_token``, ``pos_of_slot``)."""
    T, D = xf.shape
    E, K = dims.n_experts, dims.top_k

    # 1-4. routing (f32) and the slot maps
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    r = _route(probs, dims, C)

    # the gate of each slot, from the differentiable gates by the same maps
    gate_of_slot = gather_rows(r["gate_vals"].reshape(T * K, 1), r["pair_of_slot"],
                               r["slot_of_pair"])  # [E*C, 1]

    # 5. dispatch = one gather (empty slots read the zero row)
    buf = gather_rows(xf, r["tok_of_slot"], r["slot_of_token"]).reshape(E, C, D)
    return buf, gate_of_slot, r["slot_of_token"], r["pos_of_slot"]


def _route(probs: torch.Tensor, dims: MoEDims, C: int) -> dict:
    """:func:`route`; under a dry-run mesh over the replicated
    probabilities, on each device (DTensor has no strategy for its
    ``searchsorted``)."""
    if not is_sharded(probs):
        return route(probs, dims, C)
    probs = shard(probs, None, None)
    keys = ("gate_vals", "gate_idx", "keep", "tok_of_slot", "pair_of_slot", "slot_of_pair",
            "slot_of_token", "pos_of_slot")
    out = per_shard(lambda p: tuple(route(p, dims, C)[k] for k in keys),
                    (probs.placements,) * len(keys), probs)
    return dict(zip(keys, out))


def _experts(params, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """6. The batched expert FFN (SwiGLU) over ``[E, C, D]`` (or ``[G, E,
    C, D]``, groups over the batch shards), experts over ``model`` under a
    dry-run mesh, and ``D`` over ``data`` in decode (the JAX package's 2D
    plan).  Grouped under a mesh, each device runs its groups' slots of its
    experts, the weights gathered over ``data`` (FSDP) and their gradients
    summed back over the groups."""
    if x.ndim == 4:
        spec, ein = (("pod", "data"), "model", None, None), "g"
    else:
        spec, ein = ("model", None, ("data",) if decode else None), ""
    x = shard(x, *spec)  # EP over model
    w = (params["w_gate"], params["w_up"], params["w_down"])

    def ffn(x, w_gate, w_up, w_down):
        # the partial sums of a D split over `data` (decode) reduced before the SiLU
        g_ = shard(torch.einsum(f"{ein}ecd,edf->{ein}ecf", x, w_gate), *spec[:-1], None)
        u_ = shard(torch.einsum(f"{ein}ecd,edf->{ein}ecf", x, w_up), *spec[:-1], None)
        h = F.silu(g_) * u_
        y = torch.einsum(f"{ein}ecf,efd->{ein}ecd", h, w_down)
        return shard(y, *spec)

    if not (ein and is_sharded(x)):
        return ffn(x, *w)
    from torch.distributed.tensor import Partial

    w = tuple(shard(t, "model", None, None) for t in w)
    grad = tuple(Partial() if n != "model" and p.is_shard() else q
                 for n, p, q in zip(mesh_axes(), x.placements, w[0].placements))
    return per_shard(ffn, x.placements, x, *w, grad_placements=(None, grad, grad, grad))


def _combine(y_flat: torch.Tensor, slot_of_token: torch.Tensor, pos_of_slot: torch.Tensor,
             lo: int = 0) -> torch.Tensor:
    """7. Each token gathers its K slots (dropped pairs, and slots outside
    ``[lo, lo + len(y_flat))``, read the zero row) and adds them in slot
    order: ``[T, D]``."""
    n = y_flat.shape[0]
    idx = slot_of_token - lo if lo else slot_of_token
    if lo or n < pos_of_slot.shape[0]:
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
    parts = gather_rows(y_flat, idx, pos_of_slot[lo:lo + n])  # [T, K, D]
    out = parts[:, 0]
    for k in range(1, parts.shape[1]):
        out = out + parts[:, k]
    return out


def _one_group(params, dims: MoEDims, xf: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """Steps 1-7 over the ``T`` tokens ``xf [T, D]`` as one group."""
    T, D = xf.shape
    E = dims.n_experts
    C = capacity(dims, T)
    buf, gate_of_slot, slot_of_token, pos_of_slot = _dispatch(params["router"], dims, xf, C)
    y = _experts(params, buf, decode)
    y_flat = (y.reshape(E * C, D) * gate_of_slot).to(xf.dtype)
    out = _combine(y_flat, slot_of_token, pos_of_slot)
    if decode:
        out = shard(out, None, ("data",))
    if dims.shared_expert:
        out = out + mlp_ffn(params["shared"], xf)
    return out


def _dp_groups() -> int:
    """The batch shards of the dry-run mesh (pod x data); 1 outside one."""
    return axis_size("pod") * axis_size("data")


def _grouped(params, dims: MoEDims, x: torch.Tensor, G: int) -> torch.Tensor:
    """``moe_ffn`` under a dry-run mesh: ``G`` groups of ``Tl`` tokens,
    each routed, dispatched and combined on the device that holds it
    (JAX's ``shard_map``), the expert FFN sharded over ``model`` between.
    The combine gathers a device's own experts' slots, and the partial
    sums over ``model`` reduce in one all-reduce (the JAX psum)."""
    B, S, D = x.shape
    E = dims.n_experts
    Tl = B * S // G
    C = capacity(dims, Tl)
    from torch.distributed.tensor import Partial

    # the tokens placed by batch before they split into groups (DTensor
    # would split a batch sharded over more axes than the groups unevenly)
    x = shard(x, ("pod", "data"), None, None)
    xg = shard(x.reshape(G, Tl, D), ("pod", "data"), None, None)
    router = shard(params["router"], None, None)

    def dispatch(xl, rl):
        outs = [_dispatch(rl, dims, xl[g], C) for g in range(xl.shape[0])]
        buf, gate, sot, pos = (torch.stack(o) for o in zip(*outs))
        return buf, gate.reshape(*buf.shape[:3], 1), sot, pos

    pl = xg.placements
    # the router's gradient: each group's part, summed over the batch shards
    r_grad = tuple(Partial() if p.is_shard() else p for p in pl)
    buf, gate_of_slot, slot_of_token, pos_of_slot = per_shard(
        dispatch, (pl,) * 4, xg, router, grad_placements=(None, r_grad))
    y = _experts(params, buf)  # [G, E, C, D]
    gate = shard(gate_of_slot, ("pod", "data"), "model", None, None)  # [G, E, C, 1]

    def combine(yl, gl, sl, ps):
        g, e, c, _ = yl.shape
        y_flat = (yl * gl).reshape(g, e * c, D).to(x.dtype)  # this device's experts' slots
        lo = local_rank("model") * e * c
        return torch.stack([_combine(y_flat[i], sl[i], ps[i], lo) for i in range(g)])

    part = tuple(Partial() if n == "model" else p for n, p in zip(mesh_axes(), pl))
    out = per_shard(combine, part, y, gate, slot_of_token, pos_of_slot)
    out = shard(out, ("pod", "data"), None, None)
    if dims.shared_expert:
        out = out + mlp_ffn(params["shared"], xg)
    # the gradient that comes back placed by batch, so that it splits by group
    return grad_placed(out.reshape(B, S, D))


def aux_load_balance_loss(params, dims: MoEDims, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    D = x.shape[-1]
    xf = x.reshape(-1, D).to(torch.float32)
    probs = torch.softmax(xf @ params["router"], dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    f = F.one_hot(top1, dims.n_experts).to(torch.float32).mean(0)
    p = probs.mean(0)
    return dims.n_experts * (f * p).sum()
