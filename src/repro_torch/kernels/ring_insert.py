"""Wrapper of the CUDA ring bookkeeping of a fold step (``csrc/ring_insert.cu``).

No Pallas kernel: it replaces the chain of torch ops that ``wcrdt.insert``
runs before the fold (the replay and late masks, the window lanes, the
scatter-max of the slot tenants, the reset of the advancing slots, the
stale mask, the error counts and the batch frontier) with one launch on a
state that the caller owns (``wcrdt.insert(owned=True)``).
"""
from __future__ import annotations

import array
import ctypes
import math
import struct

import torch

from repro_torch.kernels.build import CudaKernel, check_cuda, ptr

MAX_SLOTS = 1024  # csrc/ring_insert.cu kMaxSlots
MAX_LEAVES = 4  # csrc/ring_insert.cu kMaxLeaves

KERNEL = CudaKernel("ring_insert", "ring_insert_launch",
                    [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int])


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def ring_insert(ts, mask, part, bidx, slot_wid, progress, folded, errors, leaves, fills,
                hop: int, window_len: int):
    """Launch the ring bookkeeping on the current stream
    (``ref.ring_insert_ref``): ``(slot i32[S, B*K], valid bool[S, B*K],
    slot_wid i32[S, W], folded i32[S, P], errors i32[S, 3])``, all new
    tensors, with the advancing slots of each f32 ``[S, W, ...]`` leaf set
    to its fill in place.  ``part`` and ``bidx`` are ints or i64 ``[S]``;
    ``bidx`` None gates nothing and leaves ``folded`` as it was.  A
    partition tensor's entries must lie in ``[0, P)``: reading them here
    would stall the host on the card."""
    S, B = ts.shape
    W, P = slot_wid.shape[1], progress.shape[1]
    K = window_len // hop
    dev = ts.device
    if not 0 < len(leaves) <= MAX_LEAVES or len(fills) != len(leaves) or not 0 < W <= MAX_SLOTS:
        raise ValueError(f"ring_insert: {len(leaves)} leaves (1-{MAX_LEAVES}), W = {W} "
                         f"(1-{MAX_SLOTS})")
    if S * B * K >= 2**31:
        raise ValueError(f"ring_insert: {S} x {B * K} lanes overflow the kernel's i32 index")
    check_cuda("ts", ts, torch.int32, (S, B))
    check_cuda("mask", mask, torch.bool, (S, B), dev)
    check_cuda("slot_wid", slot_wid, torch.int32, (S, W), dev)
    check_cuda("progress", progress, torch.int32, (S, P), dev)
    check_cuda("folded", folded, torch.int32, (S, P), dev)
    check_cuda("errors", errors, torch.int32, (S, 3), dev)
    if not isinstance(part, torch.Tensor) and not 0 <= part < P:
        raise ValueError(f"ring_insert: partition {part} outside [0, {P})")
    idx = []
    for name, x in (("part", part), ("bidx", bidx)):
        if isinstance(x, torch.Tensor):
            check_cuda(name, x, torch.int64, (S,), dev)
            idx += [ptr(x), 0]
        else:
            idx += [0, 0 if x is None else int(x)]
    slot = torch.empty((S, B * K), dtype=torch.int32, device=dev)
    valid = torch.empty((S, B * K), dtype=torch.bool, device=dev)
    out_wid = torch.empty_like(slot_wid)
    out_folded = torch.empty_like(folded)
    out_errors = torch.empty_like(errors)
    desc = [S, B, W, P, K, hop, window_len, int(bidx is not None), *idx,
            ptr(ts), ptr(mask), ptr(slot_wid), ptr(progress), ptr(folded), ptr(errors),
            ptr(slot), ptr(valid), ptr(out_wid), ptr(out_folded), ptr(out_errors), len(leaves)]
    for leaf, fill in zip(leaves, fills):
        check_cuda("leaf", leaf, torch.float32, (S, W, *leaf.shape[2:]), dev)
        desc += [ptr(leaf), math.prod(leaf.shape[2:]), _f32_bits(fill)]
    # an int64 array that holds its buffer (a caller may launch it again)
    packed = (ctypes.c_longlong * len(desc)).from_buffer(array.array("q", desc))
    KERNEL(dev, packed, len(desc))
    return slot, valid, out_wid, out_folded, out_errors
