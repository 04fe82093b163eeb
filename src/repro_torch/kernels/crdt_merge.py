"""Wrappers of the CUDA replica-stack joins: ``csrc/crdt_merge.cu`` and
``csrc/gated_delta_merge.cu``.

Replace the Pallas kernels ``repro/kernels/crdt_merge.py:crdt_merge_pallas``
and ``repro/kernels/crdt_merge.py:gated_delta_merge_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

OPS = {"max": 0, "min": 1, "or": 2}
DTYPES = {torch.float32: 0, torch.int32: 1, torch.uint8: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("gated_delta_merge", "gated_delta_merge_launch", [_P] * 3 + [_I] * 5)
MERGE_KERNEL = CudaKernel("crdt_merge", "crdt_merge_launch", [_P] * 2 + [_I, ctypes.c_int64] + [_I] * 2)


def _check_op(name: str, op: str, dtype: torch.dtype) -> None:
    if dtype not in DTYPES or op not in OPS or (op == "or" and dtype != torch.uint8):
        raise ValueError(f"{name}: no kernel for op {op!r} over {dtype}")


def crdt_merge(stack: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Launch the join of an ``[R, F]`` replica stack over R on the current
    stream: ``[F]`` (f32 / i32 / u8)."""
    _check_op("crdt_merge", op, stack.dtype)
    R, F = stack.shape
    check_cuda("stack", stack, stack.dtype, (R, F))
    out = torch.empty(F, dtype=stack.dtype, device=stack.device)
    MERGE_KERNEL(stack.device, ptr(stack), ptr(out), R, F, DTYPES[stack.dtype], OPS[op])
    return out


def gated_delta_merge(
    wid_stack: torch.Tensor,  # i32[R, W]
    leaf: torch.Tensor,  # [R, W, F] f32 / i32 / u8
    op: str = "max",
) -> torch.Tensor:
    """Launch the slot-gated join of R replicas on the current stream: ``[W, F]``."""
    _check_op("gated_delta_merge", op, leaf.dtype)
    R, W, F = leaf.shape
    check_cuda("leaf", leaf, leaf.dtype, (R, W, F))
    check_cuda("wid_stack", wid_stack, torch.int32, (R, W), leaf.device)
    out = torch.empty((W, F), dtype=leaf.dtype, device=leaf.device)
    KERNEL(leaf.device, ptr(wid_stack), ptr(leaf), ptr(out), R, W, F,
           DTYPES[leaf.dtype], OPS[op])
    return out
