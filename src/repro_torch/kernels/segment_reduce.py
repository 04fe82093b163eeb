"""Wrapper of the CUDA sorted segment-reduce kernel (``csrc/segment_reduce.cu``).

Replaces the Pallas kernel ``repro/kernels/segment_reduce.py:segment_reduce_pallas``.
As the JAX wrapper does, the sort by segment and the per-tile ranges are
computed outside the kernel (:func:`sort_lanes`); the kernel reduces the
sorted stream (:func:`reduce_sorted`), as three kernels on the current
stream that overlap by programmatic dependent launch and complete
together, so to the caller it is one operation on that stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

OPS = {"sum": 0, "count": 1, "max": 2, "min": 3}
SEG_TILE = 512  # segments per block (csrc/segment_reduce.cu kTile)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("segment_reduce", "segment_reduce_launch", [_P] * 5 + [_I] * 3)


def sort_lanes(vals: torch.Tensor, segs: torch.Tensor, mask: torch.Tensor, n_seg: int):
    """Sort the lanes by segment, stably, masked lanes last: ``(sseg i32[N],
    sval f32[N], edges i32[n_tiles + 1])`` where tile ``j``'s lanes are
    ``edges[j] .. edges[j + 1]`` of the sorted stream."""
    N = vals.shape[0]
    dev = vals.device
    check_cuda("vals", vals, torch.float32, (N,))
    check_cuda("segs", segs, torch.int32, (N,), dev)
    check_cuda("mask", mask, torch.bool, (N,), dev)
    n_tiles = -(-n_seg // SEG_TILE)
    key = torch.where(mask, segs, n_tiles * SEG_TILE)  # sentinel past every tile
    sseg, order = torch.sort(key, stable=True)
    bounds = torch.arange(0, (n_tiles + 1) * SEG_TILE, SEG_TILE, dtype=torch.int32, device=dev)
    edges = torch.searchsorted(sseg, bounds, out_int32=True)
    return sseg, vals[order], edges


def reduce_sorted(sseg, sval, edges, n_seg: int, op: str = "sum", init=None) -> torch.Tensor:
    """Launch the reduce of a sorted stream on the current stream: f32 ``[n_seg]``."""
    if op not in OPS:
        raise ValueError(f"segment_reduce: unknown op {op!r}")
    if not 0 < n_seg < 2**31:
        raise ValueError(f"segment_reduce: n_seg = {n_seg} outside the kernel's i32 range")
    N = sseg.shape[0]
    dev = sseg.device
    check_cuda("sseg", sseg, torch.int32, (N,))
    check_cuda("sval", sval, torch.float32, (N,), dev)
    check_cuda("edges", edges, torch.int32, (-(-n_seg // SEG_TILE) + 1,), dev)
    if init is not None:
        check_cuda("init", init, torch.float32, (n_seg,), dev)
    out = torch.empty(n_seg, dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(sseg), ptr(sval), ptr(edges), ptr(init), ptr(out), N, n_seg, OPS[op])
    return out


def segment_reduce(
    vals: torch.Tensor,  # f32[N]
    segs: torch.Tensor,  # i32[N] in [0, n_seg)
    mask: torch.Tensor,  # bool[N]
    n_seg: int,
    op: str = "sum",
    init: torch.Tensor | None = None,  # f32[n_seg]
) -> torch.Tensor:
    """Per-segment sum, count, max or min of the masked lanes, folded into
    ``init`` (or from the neutral element): f32 ``[n_seg]``."""
    return reduce_sorted(*sort_lanes(vals, segs, mask, n_seg), n_seg, op=op, init=init)
