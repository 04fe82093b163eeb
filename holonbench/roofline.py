"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes each kernel launch needs, counted from the launch's shapes.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its full 700 W
(dense rates); a share is stated against them with the card's power limit
beside it.  A launch's bytes count each input byte read once and each output
byte written once, whatever the kernel reads again, and only the work these
inputs need.
"""
from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def bound_s(nbytes: float, nops: float = 0.0) -> float:
    """The least time the card could take: bytes or operations at peak."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def segment_reduce_bytes(n_seg: int, n_edges: int, has_init: bool, live: int) -> int:
    """One launch of the reduce of a sorted stream into ``n_seg`` f32
    segments, as its kernels read and write it: the i32 segment and f32
    value of each live lane, the ``n_edges`` i32 tile edges and ``init``
    read, the output written.  The lanes' mask is read by the sort before
    the launch, not by these kernels, so unlike ``PERF.md`` section 6 row 4
    it is not counted."""
    return live * 8 + n_edges * 4 + (n_seg * 4 if has_init else 0) + n_seg * 4


def segment_reduce_ops(n_seg: int, live: int) -> int:
    """One operation per live lane and per segment."""
    return live + n_seg


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def delta_merge_join_bytes(state_wid, stack_wid, state_leaves, state_meta, stack_meta,
                           gated_rows: int) -> int:
    """The merge side of one delta-sync round (``PERF.md`` section 6, row 6):
    both wid stacks, the state leaves and metadata and the stacked metadata
    read, every output (``slot_wid``, leaves, metadata, the shapes of the
    state's) written, and of the stacked leaves only the ``gated_rows``
    ``[F]`` rows the gate lets in."""
    state = nbytes(state_wid) + sum(nbytes(x) for x in state_leaves) \
        + sum(nbytes(m) for m in state_meta)
    gated = sum(gated_rows * math.prod(x.shape[2:]) * x.element_size() for x in state_leaves)
    return 2 * state + nbytes(stack_wid) + sum(nbytes(m) for m in stack_meta) + gated


def delta_merge_join_ops(state_leaves, gated_rows: int) -> int:
    """One join per gated-in element and per state element."""
    return sum((gated_rows + x.numel() // math.prod(x.shape[2:])) * math.prod(x.shape[2:])
               for x in state_leaves)


def gated_rows(stack_wid: torch.Tensor) -> torch.Tensor:
    """Rows of an ``[..., R, W]`` wid stack's leaves that the gated merge
    must read: per slot, the replicas holding its newest tenant, or replica
    0 where the slot is clean on every replica."""
    top = stack_wid.amax(-2, keepdim=True)
    return torch.where(top >= 0, (stack_wid == top).sum(-2, keepdim=True), 1).sum((-2, -1))
