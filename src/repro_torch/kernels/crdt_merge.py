"""Wrapper of the CUDA gated delta-merge kernel (``csrc/gated_delta_merge.cu``).

Replaces the Pallas kernel ``repro/kernels/crdt_merge.py:gated_delta_merge_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

OPS = {"max": 0, "min": 1, "or": 2}
DTYPES = {torch.float32: 0, torch.int32: 1, torch.uint8: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("gated_delta_merge", "gated_delta_merge_launch", [_P] * 3 + [_I] * 5)


def gated_delta_merge(
    wid_stack: torch.Tensor,  # i32[R, W]
    leaf: torch.Tensor,  # [R, W, F] f32 / i32 / u8
    op: str = "max",
) -> torch.Tensor:
    """Launch the slot-gated join of R replicas on the current stream: ``[W, F]``."""
    if leaf.dtype not in DTYPES or op not in OPS or (op == "or" and leaf.dtype != torch.uint8):
        raise ValueError(f"gated_delta_merge: no kernel for op {op!r} over {leaf.dtype}")
    R, W, F = leaf.shape
    check_cuda("leaf", leaf, leaf.dtype, (R, W, F))
    check_cuda("wid_stack", wid_stack, torch.int32, (R, W), leaf.device)
    out = torch.empty((W, F), dtype=leaf.dtype, device=leaf.device)
    KERNEL(leaf.device, ptr(wid_stack), ptr(leaf), ptr(out), R, W, F,
           DTYPES[leaf.dtype], OPS[op])
    return out
