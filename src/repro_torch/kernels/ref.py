"""Plain PyTorch versions of the dataplane kernels (port of ``repro.kernels.ref``).

A tensor on the CPU takes these through ``kernels/ops.py``; on the card
they are the yardstick each CUDA kernel is held against.  Every function is
batched over a leading replica axis ``S``: replica ``s`` folds its own lanes
``[s, :]`` into its own state ``[s, ...]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.lattice import Reduce, as_dtype, bitwise_or_reduce, join_leaf

NEUTRAL = {"sum": 0.0, "count": 0.0, "max": float("-inf"), "min": float("inf")}


def _fold_into(out: torch.Tensor, seg: torch.Tensor, v: torch.Tensor, mask, op: str):
    """Fold lanes ``v`` into ``out[..., seg]`` in lane order, masked lanes
    into the sentinel cell ``out[..., -1]``; in place."""
    seg = torch.where(mask, seg, out.shape[-1] - 1)
    if op in ("sum", "count"):
        out.scatter_add_(-1, seg, torch.where(mask, v, 0.0))
    elif op in ("max", "min"):
        out.scatter_reduce_(-1, seg, v, "amax" if op == "max" else "amin")
    else:
        raise ValueError(op)
    return out


def _fold(lead: tuple, n: int, seg, v, mask, op: str, init) -> torch.Tensor:
    """Fold lanes into ``[..., n]`` cells: a sum, max or min starts from
    ``init`` (or the neutral element) and takes the lanes in lane order; a
    count counts from zero and adds ``init`` once, as the JAX package's
    kernels do.  One more cell takes the masked lanes and is dropped: the
    result is contiguous, as the kernels' outputs are."""
    out = torch.full((*lead, n + 1), NEUTRAL[op], dtype=torch.float32, device=v.device)
    if init is not None and op != "count":
        out[..., :n] = init.reshape(*lead, n)
    out = _fold_into(out, seg, v, mask, op)[..., :n].contiguous()
    if init is not None and op == "count":
        out = out + init.reshape(*lead, n)
    return out


def window_agg_ref(
    vals: torch.Tensor,  # f32[S, L]
    slots: torch.Tensor,  # i32[S, L] in [0, W)
    mask: torch.Tensor,  # bool[S, L]
    W: int,
    op: str = "sum",
    keys: torch.Tensor | None = None,  # i32[S, L] in [0, C)
    C: int = 1,
    init: torch.Tensor | None = None,  # f32[S, W, C] running state
) -> torch.Tensor:
    """Fold each replica's masked lanes into per-(slot, key) sum, count, max
    or min: f32 ``[S, W, C]``.  A sum folds into ``init`` in lane order on
    the CPU, as the JAX package's live scatter-add does; untouched cells
    hold ``init``, or the op's neutral element without it."""
    S, L = vals.shape
    n = W * C
    v = as_dtype(vals, torch.float32)
    if op == "count":
        v = torch.ones_like(v)
    seg = slots.to(torch.int64) * C
    if keys is not None:
        seg = seg + keys.to(torch.int64)
    return _fold((S,), n, seg, v, mask, op, init).reshape(S, W, C)


def segment_reduce_ref(
    vals: torch.Tensor,  # [N] numeric
    segs: torch.Tensor,  # i32[N] in [0, n_seg)
    mask: torch.Tensor,  # bool[N]
    n_seg: int,
    op: str = "sum",
    init: torch.Tensor | None = None,  # f32[n_seg] running state
) -> torch.Tensor:
    """f32 ``[n_seg]`` per-segment sum, count, max or min of the masked
    lanes, joined with ``init`` as :func:`window_agg_ref` does; without
    ``init`` untouched segments read the op's neutral element.  ``segs``
    under a False mask may be garbage: those lanes go to a sentinel
    segment."""
    v = as_dtype(vals, torch.float32)
    if op == "count":
        v = torch.ones_like(v)
    return _fold((), n_seg, segs.to(torch.int64), v, mask, op, init)


def actor_sum_ref(rows: torch.Tensor) -> torch.Tensor:
    """Left fold of f32 ``[S, P, ...]`` actor rows over ``P``: ``((r0 + r1) +
    r2) + ...``, ``P - 1`` elementwise adds in that order, as the JAX
    package's ``jnp.sum(axis=0)`` adds on XLA's CPU (``csrc/actor_sum.cu``
    says where a lane of -0.0 rows differs).  Elementwise adds round alike
    on every device; a torch sum over ``P`` adds in an order of its own."""
    r = rows.unbind(1)
    out = r[0]
    for x in r[1:]:
        out = out + x
    return out


def crdt_merge_ref(stack: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Lattice join of an ``[R, ...]`` replica stack over its first axis."""
    if op == "max":
        return stack.amax(0)
    if op == "min":
        return stack.amin(0)
    if op == "or":
        return bitwise_or_reduce(stack, 0)
    raise ValueError(op)


def gated_neutral(op: str, dtype: torch.dtype):
    """Join identity of a gated-out replica contribution (a Python scalar)."""
    if op == "or":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def gated_delta_merge_ref(
    wid_stack: torch.Tensor,  # i32[R, W] per-replica ring tenant wids (-1 clean)
    leaf_stack: torch.Tensor,  # [R, W, ...] matching window-leaf stack
    op: str = "max",
) -> torch.Tensor:
    """Slot-aware join of R delta replicas: per slot only replicas holding
    the newest tenant window contribute, the rest are gated to the join
    identity.  A slot clean on every replica (all wids -1) copies replica 0:
    deltas carry the identical zero state there."""
    top = wid_stack.amax(0)  # [W]
    extra = (1,) * (leaf_stack.dim() - 2)
    gate = (wid_stack == top).reshape(*wid_stack.shape, *extra)
    x = torch.where(gate, leaf_stack, gated_neutral(op, leaf_stack.dtype))
    if op == "max":
        red = x.amax(0)
    elif op == "min":
        red = x.amin(0)
    elif op == "or":
        red = bitwise_or_reduce(x, 0)
    else:
        raise ValueError(op)
    clean = (top < 0).reshape(top.shape[0], *extra)
    return torch.where(clean, leaf_stack[0], red)


def crdt_merge_rows_ref(stack: torch.Tensor, op: str = "max",
                        where: torch.Tensor | None = None) -> torch.Tensor:
    """The join of an ``[R, ...]`` stack over R, written to every row; where
    the bool scalar ``where`` is False each row keeps its own value."""
    joined = crdt_merge_ref(stack, op).expand_as(stack)
    if where is None:
        return joined.contiguous()
    return torch.where(where, joined, stack)


def delta_merge_join_ref(
    state_wid: torch.Tensor,  # i32[S, W] each replica's ring tenants
    stack_wid: torch.Tensor,  # i32[R, W] the gathered deltas' tenants (-1 clean)
    state_leaves: list,  # per window field, [S, W, ...]
    stack_leaves: list,  # per window field, [R, W, ...]
    joins: list,  # per window field, "max" / "min" / "or"
    state_meta: list,  # i32 [S, n] each (progress, folded, errors)
    stack_meta: list,  # i32 [R, n] each
) -> tuple[torch.Tensor, list, list]:
    """The merge side of a delta-sync round: the slot-gated join of the
    ``[R]`` delta stack (:func:`gated_delta_merge_ref` per field, the max of
    the wids and of the metadata), joined slot-aware into each of the ``S``
    replicas (``wcrdt._merge_wstate``): per slot the larger wid wins
    outright, equal wids join.  Returns ``(slot_wid, leaves, meta)``,
    stacked over S."""
    top = crdt_merge_ref(stack_wid, "max")  # [W]
    state_newer = state_wid > top
    same = state_wid == top
    leaves = []
    for a, b, op in zip(state_leaves, stack_leaves, joins):
        m = gated_delta_merge_ref(stack_wid, b, op).expand_as(a)
        extra = (1,) * (a.dim() - 2)
        leaves.append(torch.where(same.reshape(*same.shape, *extra), join_leaf(Reduce(op), a, m),
                                  torch.where(state_newer.reshape(*same.shape, *extra), a, m)))
    meta = [torch.maximum(a, crdt_merge_ref(b, "max")) for a, b in zip(state_meta, stack_meta)]
    return torch.maximum(state_wid, top), leaves, meta


def lex_sort(vals: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending lexicographic sort by ``(val, id)`` along the last axis: a
    stable sort by the minor key, then a stable sort by the major key."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    vals, ids = vals.gather(-1, order), ids.gather(-1, order)
    order = torch.sort(vals, dim=-1, stable=True).indices
    return vals.gather(-1, order), ids.gather(-1, order)


def lex_topk(vals: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` distinct ``(val, id)`` pairs along the last axis, descending,
    padded with ``(-inf, 0)``: exact duplicates collapse (set semantics),
    and the larger id wins a tie on the value."""
    sv, si = lex_sort(vals, ids)
    dup = torch.zeros_like(sv, dtype=torch.bool)
    dup[..., 1:] = (sv[..., 1:] == sv[..., :-1]) & (si[..., 1:] == si[..., :-1])
    sv = torch.where(dup, float("-inf"), sv)
    si = torch.where(dup, 0, si)
    sv, si = lex_sort(sv, si)
    return sv[..., -k:].flip(-1), si[..., -k:].flip(-1)


def topk_window_ref(
    state_vals: torch.Tensor,  # f32[S, W, k] desc-sorted, -inf padded
    state_ids: torch.Tensor,  # i64[S, W, k] (u32 ids)
    vals: torch.Tensor,  # f32[S, L]
    ids: torch.Tensor,  # i64[S, L]
    slots: torch.Tensor,  # i32[S, L]
    mask: torch.Tensor,  # bool[S, L]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-window top-k merge of each replica's lanes into its running state
    (Q7), with the set semantics of the Pallas kernel: the k largest
    distinct ``(val, id)`` pairs among the state row and the window's
    lanes."""
    S, W, k = state_vals.shape
    w = torch.arange(W, dtype=slots.dtype, device=slots.device)
    m = mask.unsqueeze(1) & (slots.unsqueeze(1) == w[None, :, None])  # [S, W, L]
    bv = torch.where(m, vals.to(torch.float32).unsqueeze(1), float("-inf"))
    bi = torch.where(m, ids.to(torch.int64).unsqueeze(1), 0)
    return lex_topk(torch.cat([state_vals, bv], -1), torch.cat([state_ids, bi], -1), k)


def ring_insert_ref(
    ts: torch.Tensor,  # i32[S, B] event times
    mask: torch.Tensor,  # bool[S, B]
    part: torch.Tensor,  # i64[S] each replica's partition
    bidx: torch.Tensor | None,  # i64[S] each replica's batch index, or None (no replay gate)
    slot_wid: torch.Tensor,  # i32[S, W] ring tenants, each at least -1
    progress: torch.Tensor,  # i32[S, P]
    folded: torch.Tensor,  # i32[S, P]
    errors: torch.Tensor,  # i32[S, 3] late, ring, evicted incomplete
    leaves: list,  # f32 [S, W, ...] window leaves, reset in place
    fills: list,  # each leaf's zero value
    hop: int,
    window_len: int,
):
    """The ring bookkeeping of ``wcrdt.insert`` for a replica-wide partition
    and batch index, with the advancing slots of each leaf reset in place.

    Events gated by ``bidx >= folded[part]`` (replay) and not below
    ``progress[part]`` (late) expand into ``K = window_len // hop`` lanes,
    lane ``b*K + k`` the ``k``-th newest window (``window.expand_events``;
    under K = 1 a window id below 0 stays).  Returns ``(slot i32[S, B*K],
    valid bool[S, B*K], slot_wid, folded, errors)``, the last three new
    tensors: ``slot`` each lane's ring slot, ``valid`` the lanes that fold
    (live and of their slot's new tenant), ``slot_wid`` the max per slot,
    ``folded[part]`` raised to ``bidx + 1``, and ``errors`` plus the late,
    stale and incomplete-eviction counts.  As few torch ops as it takes: on
    the CPU this is the dataplane's step."""
    S, B = ts.shape
    W = slot_wid.shape[1]
    K = window_len // hop
    col = part.unsqueeze(1)
    m = mask
    if bidx is not None:
        bidx = bidx.to(torch.int32).unsqueeze(1)
        m = m & (bidx >= folded.gather(1, col))
    late = m & (ts < progress.gather(1, col))
    m = m ^ late
    newest_first = torch.arange(0, -K, -1, dtype=torch.int32, device=ts.device)
    wid = (torch.div(ts, hop, rounding_mode="floor").unsqueeze(2) + newest_first).reshape(S, -1)
    m = m.repeat_interleave(K, 1)
    if K > 1:
        m = m & (wid >= 0)
    slot = torch.remainder(wid, W)
    idx = slot.to(torch.int64)
    new = slot_wid.scatter_reduce(1, idx, torch.where(m, wid, -1), "amax")
    adv = new > slot_wid
    gwid = (torch.div(progress.amin(1, keepdim=True) - window_len, hop, rounding_mode="floor")
            + 1).clamp(min=0)
    evict = adv & (slot_wid >= gwid)  # gwid >= 0, so an empty slot (-1) never counts
    for leaf, fill in zip(leaves, fills):
        leaf.masked_fill_(adv.reshape(S, W, *(1,) * (leaf.dim() - 2)), fill)
    stale = m & (wid < new.gather(1, idx))
    counts = torch.stack([late.sum(1), stale.sum(1), evict.sum(1)], 1)
    if bidx is not None:
        folded = folded.scatter_reduce(1, col, bidx + 1, "amax")
    return slot, m ^ stale, new, folded, errors + counts.to(torch.int32)
