"""Wrapper of the CUDA windowed-fold kernel (``csrc/window_agg.cu``).

Replaces the Pallas kernel ``repro/kernels/window_agg.py:window_agg_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

OPS = {"sum": 0, "count": 1, "max": 2, "min": 3}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("window_agg", "window_agg_launch", [_P] * 6 + [_I] * 5)


def window_agg(
    vals: torch.Tensor,  # f32[S, L]
    slots: torch.Tensor,  # i32[S, L] in [0, W)
    mask: torch.Tensor,  # bool[S, L]
    W: int,
    op: str = "sum",
    keys: torch.Tensor | None = None,  # i32[S, L] in [0, C)
    C: int = 1,
    init: torch.Tensor | None = None,  # f32[S, W, C]
) -> torch.Tensor:
    """Launch the fold on the current stream: f32 ``[S, W, C]``."""
    if op not in OPS:
        raise ValueError(f"window_agg: unknown op {op!r}")
    S, L = vals.shape
    dev = vals.device
    check_cuda("vals", vals, torch.float32, (S, L))
    check_cuda("slots", slots, torch.int32, (S, L), dev)
    check_cuda("mask", mask, torch.bool, (S, L), dev)
    if keys is not None:
        check_cuda("keys", keys, torch.int32, (S, L), dev)
    if init is not None:
        check_cuda("init", init, torch.float32, (S, W, C), dev)
    out = torch.empty((S, W, C), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(vals), ptr(slots), ptr(mask), ptr(keys), ptr(init), ptr(out),
           S, L, W, C, OPS[op])
    return out
