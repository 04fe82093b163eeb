"""Wrapper of the CUDA per-window top-k kernel (``csrc/topk_window.cu``).

Replaces the Pallas kernel ``repro/kernels/topk_window.py:topk_window_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

K_MAX = 16  # pairs each thread keeps (csrc/topk_window.cu kKeep)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("topk_window", "topk_window_launch", [_P] * 8 + [_I] * 4)


def topk_window(
    state_vals: torch.Tensor,  # f32[S, W, k]
    state_ids: torch.Tensor,  # i64[S, W, k]
    vals: torch.Tensor,  # f32[S, L]
    ids: torch.Tensor,  # i64[S, L]
    slots: torch.Tensor,  # i32[S, L]
    mask: torch.Tensor,  # bool[S, L]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the per-window top-k merge on the current stream."""
    S, W, k = state_vals.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_window: k={k} outside [1, {K_MAX}]")
    L = vals.shape[-1]
    dev = state_vals.device
    check_cuda("state_vals", state_vals, torch.float32, (S, W, k))
    check_cuda("state_ids", state_ids, torch.int64, (S, W, k), dev)
    check_cuda("vals", vals, torch.float32, (S, L), dev)
    check_cuda("ids", ids, torch.int64, (S, L), dev)
    check_cuda("slots", slots, torch.int32, (S, L), dev)
    check_cuda("mask", mask, torch.bool, (S, L), dev)
    out_vals = torch.empty_like(state_vals)
    out_ids = torch.empty_like(state_ids)
    KERNEL(dev, ptr(state_vals), ptr(state_ids), ptr(vals), ptr(ids), ptr(slots),
           ptr(mask), ptr(out_vals), ptr(out_ids), S, L, W, k)
    return out_vals, out_ids
