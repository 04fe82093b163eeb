"""Nexmark event model as struct-of-arrays (port of ``repro.streaming.events``).

A log is a pre-generated, deterministically indexable batch of events per
partition: ``[S, num_batches, B]`` tensors.  Auction and bidder ids are u32
values carried as int64 (torch lacks ordered uint32 ops).
"""
from __future__ import annotations

import dataclasses

import torch

KIND_PERSON = 0
KIND_AUCTION = 1
KIND_BID = 2


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """A fixed-size batch of events; invalid lanes have valid=False."""

    ts: torch.Tensor  # i32 event time (ms)
    kind: torch.Tensor  # i32 KIND_*
    auction: torch.Tensor  # i64 auction id (u32 values)
    price: torch.Tensor  # f32 bid price
    category: torch.Tensor  # i32 auction category (pre-joined)
    bidder: torch.Tensor  # i64 bidder id (u32 values)
    valid: torch.Tensor  # bool

    def batch(self, i: int) -> "EventBatch":
        """Batch ``i`` of every partition of an ``[S, num_batches, B]`` log:
        contiguous ``[S, B]`` fields."""
        return EventBatch(*(getattr(self, f.name)[:, i].contiguous()
                            for f in dataclasses.fields(self)))

    def map(self, fn) -> "EventBatch":
        return EventBatch(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def empty_batch(B: int, device=None) -> EventBatch:
    """A ``[B]`` batch with every lane invalid."""
    z = dict(device=device)
    return EventBatch(
        ts=torch.zeros((B,), dtype=torch.int32, **z),
        kind=torch.zeros((B,), dtype=torch.int32, **z),
        auction=torch.zeros((B,), dtype=torch.int64, **z),
        price=torch.zeros((B,), dtype=torch.float32, **z),
        category=torch.zeros((B,), dtype=torch.int32, **z),
        bidder=torch.zeros((B,), dtype=torch.int64, **z),
        valid=torch.zeros((B,), dtype=torch.bool, **z),
    )
