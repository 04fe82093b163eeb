"""Wrappers of the CUDA replica-stack joins: ``csrc/crdt_merge.cu`` and
``csrc/gated_delta_merge.cu``.

Replace the Pallas kernels ``repro/kernels/crdt_merge.py:crdt_merge_pallas``
and ``repro/kernels/crdt_merge.py:gated_delta_merge_pallas``;
:func:`delta_merge_join` is the whole merge side of a delta-sync round in
one launch.
"""
from __future__ import annotations

import array
import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

OPS = {"max": 0, "min": 1, "or": 2}
DTYPES = {torch.float32: 0, torch.int32: 1, torch.uint8: 2}
MAX_FIELDS = 8  # csrc/gated_delta_merge.cu kMaxFields
MAX_META = 4  # csrc/gated_delta_merge.cu kMaxMeta

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("gated_delta_merge", "gated_delta_merge_launch", [_P] * 3 + [_I] * 5)
JOIN_KERNEL = CudaKernel("gated_delta_merge", "delta_merge_join_launch",
                         [ctypes.POINTER(ctypes.c_longlong), _I])
MERGE_KERNEL = CudaKernel("crdt_merge", "crdt_merge_launch",
                          [_P] * 3 + [_I, ctypes.c_int64] + [_I] * 3)


def _check_op(name: str, op: str, dtype: torch.dtype) -> None:
    if dtype not in DTYPES or op not in OPS or (op == "or" and dtype != torch.uint8):
        raise ValueError(f"{name}: no kernel for op {op!r} over {dtype}")


def crdt_merge(stack: torch.Tensor, op: str = "max", rows: bool = False,
               where: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the join of an ``[R, F]`` replica stack over R on the current
    stream: ``[F]`` (f32 / i32 / u8).  With ``rows`` the join is written to
    every row, ``[R, F]``; where the device bool scalar ``where`` is False,
    each row keeps its own value (read by the kernel: no host sync)."""
    _check_op("crdt_merge", op, stack.dtype)
    R, F = stack.shape
    check_cuda("stack", stack, stack.dtype, (R, F))
    if where is not None:
        if not rows:
            raise ValueError("crdt_merge: where= needs rows=True")
        check_cuda("where", where, torch.bool, (), stack.device)
    out = torch.empty((R, F) if rows else F, dtype=stack.dtype, device=stack.device)
    MERGE_KERNEL(stack.device, ptr(stack), ptr(out), ptr(where), R, F, DTYPES[stack.dtype],
                 OPS[op], int(rows))
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


def delta_merge_join(
    state_wid: torch.Tensor,  # i32[S, W]
    stack_wid: torch.Tensor,  # i32[R, W]
    state_leaves: list,  # [S, W, ...] f32 / i32 / u8
    stack_leaves: list,  # [R, W, ...], the same dtypes and shapes
    joins: list,  # "max" / "min" / "or" per field
    state_meta: list,  # i32[S, n_k]
    stack_meta: list,  # i32[R, n_k]
) -> tuple[torch.Tensor, list, list]:
    """Launch the merge side of a delta-sync round on the current stream
    (``ref.delta_merge_join_ref``): the new ``slot_wid`` ``[S, W]``, leaves
    ``[S, W, ...]`` and metadata ``[S, n_k]``, all new tensors.  Up to
    ``MAX_FIELDS`` window fields of mixed dtypes and ``MAX_META`` metadata
    fields go into one launch."""
    S, W = state_wid.shape
    R = stack_wid.shape[0]
    dev = state_wid.device
    if not 0 < len(state_leaves) <= MAX_FIELDS or len(state_meta) > MAX_META:
        raise ValueError(f"delta_merge_join: {len(state_leaves)} fields (1-{MAX_FIELDS}), "
                         f"{len(state_meta)} metadata fields (at most {MAX_META})")
    if (not len(stack_leaves) == len(joins) == len(state_leaves)
            or len(stack_meta) != len(state_meta)):
        raise ValueError("delta_merge_join: state and stack lists differ in length")
    for a, op in zip(state_leaves, joins):
        _check_op("delta_merge_join", op, a.dtype)
    check_cuda("state_wid", state_wid, torch.int32, (S, W))
    check_cuda("stack_wid", stack_wid, torch.int32, (R, W), dev)
    out_wid = torch.empty((S, W), dtype=torch.int32, device=dev)
    desc = [R, S, W, len(state_leaves), len(state_meta),
            ptr(stack_wid), ptr(state_wid), ptr(out_wid)]
    leaves = []
    for a, b, op in zip(state_leaves, stack_leaves, joins):
        rest = tuple(a.shape[2:])
        F = math.prod(rest)
        if F == 0:
            raise ValueError("delta_merge_join: a field without features")
        check_cuda("state leaf", a, a.dtype, (S, W, *rest), dev)
        check_cuda("stack leaf", b, a.dtype, (R, W, *rest), dev)
        out = torch.empty_like(a)
        leaves.append(out)
        desc += [ptr(b), ptr(a), ptr(out), F, DTYPES[a.dtype], OPS[op]]
    meta = []
    for a, b in zip(state_meta, stack_meta):
        n = a.shape[1]
        if n == 0:
            raise ValueError("delta_merge_join: an empty metadata field")
        check_cuda("state meta", a, torch.int32, (S, n), dev)
        check_cuda("stack meta", b, torch.int32, (R, n), dev)
        out = torch.empty_like(a)
        meta.append(out)
        desc += [ptr(b), ptr(a), ptr(out), n]
    # an int64 array that holds its buffer (a caller may launch it again)
    packed = (ctypes.c_longlong * len(desc)).from_buffer(array.array("q", desc))
    JOIN_KERNEL(dev, packed, len(desc))
    return out_wid, leaves, meta
