"""Dispatch to the kernels (port of ``repro.kernels.ops``).

A tensor on the CPU takes the plain version in ``kernels/ref.py``; any
other tensor goes to the CUDA kernel, whose wrapper raises unless it is a
CUDA tensor of the right type and shape.  There is no fallback between the
two: the choice is made by ``tensor.device.type`` alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import crdt_merge as _merge
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_reduce as _seg
from repro_torch.kernels import topk_window as _topk
from repro_torch.kernels import window_agg as _agg

# Keyed cardinality from which a keyed fold goes to the sorted
# segment-reduce kernel instead of the dense one-hot fold: the dense fold
# compares every lane with every cell of its tile, the sorted one does work
# independent of C (as in the JAX package).
SPARSE_KEY_THRESHOLD = 1024

# every launched kernel, for launch accounting
KERNELS = {"window_agg": _agg.KERNEL, "topk_window": _topk.KERNEL,
           "gated_delta_merge": _merge.KERNEL, "segment_reduce": _seg.KERNEL,
           "crdt_merge": _merge.MERGE_KERNEL, "delta_merge_join": _merge.JOIN_KERNEL}
# the csrc/<name>.cu sources those kernels are built from
SOURCES = sorted({k.source for k in KERNELS.values()})


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def window_agg(
    vals, slots, mask, W: int, op: str = "sum", keys=None, C: int = 1, init=None,
) -> torch.Tensor:
    """Per-replica windowed fold of ``[S, L]`` lanes into f32 ``[S, W, C]``.

    A keyed fold with ``C >= SPARSE_KEY_THRESHOLD`` runs as one segment
    reduce over all ``S`` replicas, segment ``s*W*C + slot*C + key``."""
    S = vals.shape[0]
    if keys is not None and C >= SPARSE_KEY_THRESHOLD:
        n = S * W * C
        if n >= 2**31:
            raise ValueError(f"S*W*C = {n} overflows the kernel's i32 segment ids")
        base = torch.arange(S, dtype=torch.int32, device=vals.device).unsqueeze(1) * (W * C)
        segs = base + slots.to(torch.int32) * C + keys.to(torch.int32)
        out = segment_reduce(vals.reshape(-1), segs.reshape(-1), mask.reshape(-1), n, op=op,
                             init=None if init is None else init.reshape(-1))
        return out.reshape(S, W, C)
    if W * C >= 2**31:
        raise ValueError(f"W*C = {W * C} overflows the kernel's i32 cell ids")
    if _on_cpu(vals):
        return _ref.window_agg_ref(vals, slots, mask, W, op=op, keys=keys, C=C, init=init)
    return _agg.window_agg(vals, slots, mask, W, op=op, keys=keys, C=C, init=init)


def segment_reduce(vals, segs, mask, n_seg: int, op: str = "sum", init=None) -> torch.Tensor:
    """Per-segment sum/count/max/min of ``[N]`` masked lanes, folded into
    ``init`` f32 ``[n_seg]`` (or from the op's neutral element)."""
    if _on_cpu(vals):
        return _ref.segment_reduce_ref(vals, segs, mask, n_seg, op=op, init=init)
    return _seg.segment_reduce(vals, segs, mask, n_seg, op=op, init=init)


def crdt_merge(stack: torch.Tensor, op: str = "max", rows: bool = False,
               where: torch.Tensor | None = None) -> torch.Tensor:
    """Join an ``[R, ...]`` replica stack over its first axis: ``[...]``.
    With ``rows`` the join goes to every row, ``[R, ...]``, and where the
    bool scalar ``where`` is False each row keeps its own value.  Bool
    stacks join as uint8."""
    if _on_cpu(stack):
        if rows:
            return _ref.crdt_merge_rows_ref(stack, op=op, where=where)
        return _ref.crdt_merge_ref(stack, op=op)
    R = stack.shape[0]
    flat = stack.reshape(R, -1)
    flat = flat.to(torch.uint8) if stack.dtype == torch.bool else flat.contiguous()
    out = _merge.crdt_merge(flat, op=op, rows=rows, where=where).to(stack.dtype)
    return out.reshape(stack.shape if rows else stack.shape[1:])


def gated_delta_merge(wid_stack, leaf_stack, op: str = "max") -> torch.Tensor:
    """Slot-aware join of ``[R]``-stacked delta replicas.

    ``wid_stack`` i32[R, W] carries each replica's ring tenant wids (-1 for
    clean slots); ``leaf_stack`` [R, W, ...] the matching window leaf.  Per
    slot only newest-tenant replicas contribute.  Returns ``[W, ...]``.
    """
    if _on_cpu(leaf_stack):
        return _ref.gated_delta_merge_ref(wid_stack, leaf_stack, op=op)
    R, W = wid_stack.shape
    trailing = leaf_stack.shape[2:]
    flat = leaf_stack.reshape(R, W, -1).contiguous()
    return _merge.gated_delta_merge(wid_stack.contiguous(), flat, op=op).reshape(W, *trailing)


def delta_merge_join(state_wid, stack_wid, state_leaves, stack_leaves, joins, state_meta,
                     stack_meta):
    """The merge side of a delta-sync round: the slot-gated join of the
    ``[R]``-stacked deltas (``stack_*``) joined slot-aware into each of the
    ``S`` replicas (``state_*``).  Leaves ``[S|R, W, ...]``, one join each;
    metadata i32 ``[S|R, n]``, joined by max.  Returns ``(slot_wid [S, W],
    leaves, meta)``."""
    if _on_cpu(state_wid):
        return _ref.delta_merge_join_ref(state_wid, stack_wid, state_leaves, stack_leaves,
                                         joins, state_meta, stack_meta)
    return _merge.delta_merge_join(
        state_wid.contiguous(), stack_wid.contiguous(),
        [a.contiguous() for a in state_leaves], [b.contiguous() for b in stack_leaves], joins,
        [m.contiguous() for m in state_meta], [m.contiguous() for m in stack_meta])


def topk_window(state_vals, state_ids, vals, ids, slots, mask):
    """Per-window top-k merge of ``[S, L]`` lanes into ``[S, W, k]`` state."""
    if _on_cpu(state_vals):
        return _ref.topk_window_ref(state_vals, state_ids, vals, ids, slots, mask)
    return _topk.topk_window(state_vals, state_ids, vals, ids, slots, mask)
