"""Wrapper of the CUDA actor-row fold (``csrc/actor_sum.cu``).

No Pallas kernel: it replaces the JAX package's ``jnp.sum(axis=0)`` over a
counter's actor rows (``repro/core/crdt.py:63,82,108,129``), a sequential
f32 left fold on XLA's CPU, with the same fold on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNEL = CudaKernel("actor_sum", "actor_sum_launch", [_P, _P, _I, _I, _L, _L, _L])


def actor_sum(rows: torch.Tensor) -> torch.Tensor:  # f32[S, P, K]
    """Launch the left fold of ``rows`` over ``P`` on the current stream:
    f32 ``[S, K]``.  Rows may be strided over ``S`` and ``P``; the key axis
    must be contiguous."""
    if not rows.is_cuda or rows.dtype != torch.float32 or rows.dim() != 3:
        raise ValueError(f"actor_sum: expected a CUDA f32 [S, P, K] tensor, got "
                         f"{rows.dtype} {tuple(rows.shape)} on {rows.device}")
    S, P, K = rows.shape
    if K > 1 and rows.stride(2) != 1:
        raise ValueError("actor_sum: the key axis must be contiguous")
    out = torch.empty((S, K), dtype=torch.float32, device=rows.device)
    KERNEL(rows.device, rows.data_ptr(), out.data_ptr(), S, P, K, rows.stride(0),
           rows.stride(1))
    return out
