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
from repro_torch.kernels import topk_window as _topk
from repro_torch.kernels import window_agg as _agg

# Keyed cardinality from which the JAX package routes a keyed fold to the
# sorted segment-reduce kernel instead of the dense one-hot fold; that
# kernel belongs to the keyed dataplane, which is not ported yet.
SPARSE_KEY_THRESHOLD = 1024

# every launched kernel, for launch accounting
KERNELS = {"window_agg": _agg.KERNEL, "topk_window": _topk.KERNEL,
           "gated_delta_merge": _merge.KERNEL}


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def window_agg(
    vals, slots, mask, W: int, op: str = "sum", keys=None, C: int = 1, init=None,
) -> torch.Tensor:
    """Per-replica windowed fold of ``[S, L]`` lanes into f32 ``[S, W, C]``."""
    if keys is not None and C >= SPARSE_KEY_THRESHOLD:
        raise NotImplementedError("segment_reduce: keyed slice")
    if W * C >= 2**31:
        raise ValueError(f"W*C = {W * C} overflows the kernel's i32 cell ids")
    if _on_cpu(vals):
        return _ref.window_agg_ref(vals, slots, mask, W, op=op, keys=keys, C=C, init=init)
    return _agg.window_agg(vals, slots, mask, W, op=op, keys=keys, C=C, init=init)


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


def topk_window(state_vals, state_ids, vals, ids, slots, mask):
    """Per-window top-k merge of ``[S, L]`` lanes into ``[S, W, k]`` state."""
    if _on_cpu(state_vals):
        return _ref.topk_window_ref(state_vals, state_ids, vals, ids, slots, mask)
    return _topk.topk_window(state_vals, state_ids, vals, ids, slots, mask)
