"""Nexmark global-aggregation queries over Windowed CRDTs (port of
``repro.streaming.queries``).

Each query is a :class:`Query` over stacked replicas: ``shared`` is a tuple
of WCRDT states joined in the background, ``local`` the partition-local
windowed state (a WCRDT with a single progress entry).  ``fold`` consumes
one ``[S, B]`` batch (insert + increment_watermark) with replica ``s`` as
partition ``partition[s]``; ``read`` returns every replica's value of a
window and whether it is final.  Every query also ships an ``oracle``: the
same aggregation computed directly over a whole log with plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import wcrdt as W
from repro_torch.core.wcrdt import WSpec, WState
from repro_torch.core.window import WindowAssigner, as_assigner
from repro_torch.kernels.ref import lex_sort
from repro_torch.streaming.events import KIND_BID, EventBatch
from repro_torch.streaming.generator import NUM_CATEGORIES, batch_watermark


@dataclasses.dataclass(frozen=True)
class Query:
    name: str
    num_partitions: int
    window_len: int
    assigner: WindowAssigner
    shared_specs: tuple[WSpec, ...]
    local_spec: WSpec | None
    fold: Callable[..., tuple[tuple[WState, ...], WState | None]]
    read: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    oracle: Callable[..., Any]
    out_width: int  # f32 output lanes per (partition, window)

    def init_shared(self, device=None) -> tuple[WState, ...]:
        return tuple(s.zero(self.num_partitions, device) for s in self.shared_specs)

    def init_local(self, device=None) -> WState | None:
        if self.local_spec is None:
            return None
        return self.local_spec.zero(self.num_partitions, device)


def _local_gcounter(window_len: int, num_slots: int, assigner) -> WSpec:
    return W.wgcounter(window_len, num_slots, 1, assigner=assigner)


def _bid_mask(log: EventBatch, assigner, wid: int) -> torch.Tensor:
    return log.valid & (log.kind == KIND_BID) & assigner.contains(wid, log.ts)


# ---------------------------------------------------------------------------
# Q0: pass-through (per-window event counts of each partition)
# ---------------------------------------------------------------------------


def make_q0(num_partitions: int, window_len: int = 1000, num_slots: int = 16,
            hop: int | None = None) -> Query:
    assigner = as_assigner(window_len, hop)
    lspec = _local_gcounter(window_len, num_slots, assigner)

    def fold(shared, local, batch: EventBatch, partition, batch_idx=None):
        local = W.insert(lspec, local, 0, batch.ts, batch.valid, batch_idx=batch_idx,
                         actor=0, amounts=torch.ones_like(batch.price))
        local = W.increment_watermark(lspec, local, 0, batch_watermark(batch))
        return shared, local

    def read(shared, local, wid: int):
        v, ok = W.window_value(lspec, local, wid)
        return v.reshape(-1, 1), ok

    def oracle(log: EventBatch, wid: int, partition=None):
        m = log.valid & assigner.contains(wid, log.ts)
        if partition is not None:
            m = m[partition]
        return m.sum().to(torch.float32)

    return Query("q0", num_partitions, window_len, assigner, (), lspec,
                 fold, read, oracle, out_width=1)


# ---------------------------------------------------------------------------
# Q4: average price per category (global, keyed, no shuffle)
# ---------------------------------------------------------------------------


def make_q4(num_partitions: int, window_len: int = 1000, num_slots: int = 16,
            num_categories: int = NUM_CATEGORIES, hop: int | None = None) -> Query:
    assigner = as_assigner(window_len, hop)
    sum_spec = W.wgcounter(window_len, num_slots, num_partitions,
                           key_shape=(num_categories,), assigner=assigner)
    cnt_spec = W.wgcounter(window_len, num_slots, num_partitions,
                           key_shape=(num_categories,), assigner=assigner)

    def fold(shared, local, batch: EventBatch, partition, batch_idx=None):
        s, c = shared
        is_bid = batch.valid & (batch.kind == KIND_BID)
        wm = batch_watermark(batch)
        s = W.insert(sum_spec, s, partition, batch.ts, is_bid, batch_idx=batch_idx,
                     actor=partition, amounts=batch.price, keys=batch.category)
        s = W.increment_watermark(sum_spec, s, partition, wm)
        c = W.insert(cnt_spec, c, partition, batch.ts, is_bid, batch_idx=batch_idx,
                     actor=partition, amounts=torch.ones_like(batch.price), keys=batch.category)
        c = W.increment_watermark(cnt_spec, c, partition, wm)
        return (s, c), local

    def read(shared, local, wid: int):
        s, c = shared
        sv, ok1 = W.window_value(sum_spec, s, wid)
        cv, ok2 = W.window_value(cnt_spec, c, wid)
        return sv / cv.clamp(min=1.0), ok1 & ok2

    def oracle(log: EventBatch, wid: int, partition=None):
        # the JAX oracle's f32 sums of one-hot products (each factor 0.0 or
        # 1.0, so every product is exact), one category at a time
        m = _bid_mask(log, assigner, wid)
        sums, cnts = [], []
        for c in range(num_categories):
            w = (m & (log.category == c)).to(torch.float32)
            sums.append((w * log.price).sum())
            cnts.append(w.sum())
        return torch.stack(sums) / torch.stack(cnts).clamp(min=1.0)

    return Query("q4", num_partitions, window_len, assigner, (sum_spec, cnt_spec), None,
                 fold, read, oracle, out_width=num_categories)


# ---------------------------------------------------------------------------
# Q7: highest bids (global top-k per window)
# ---------------------------------------------------------------------------


def make_q7(num_partitions: int, window_len: int = 1000, num_slots: int = 16, k: int = 8,
            topk_active: int = 4, hop: int | None = None) -> Query:
    """``topk_active``: window offsets folded per batch (see the JAX
    package's ``make_q7``); under a hopping assigner the active span grows
    by ``window_len // hop``, clamped to the ring size."""
    assigner = as_assigner(window_len, hop)
    if topk_active is not None:
        topk_active = min(topk_active * assigner.windows_per_event, num_slots)
    topk_spec = W.wtopk(window_len, num_slots, num_partitions, k,
                        max_active_windows=topk_active, assigner=assigner)

    def fold(shared, local, batch: EventBatch, partition, batch_idx=None):
        (t,) = shared
        is_bid = batch.valid & (batch.kind == KIND_BID)
        t = W.insert(topk_spec, t, partition, batch.ts, is_bid, batch_idx=batch_idx,
                     vals=batch.price, ids=batch.auction)
        t = W.increment_watermark(topk_spec, t, partition, batch_watermark(batch))
        return (t,), local

    def read(shared, local, wid: int):
        (t,) = shared
        (vals, ids), ok = W.window_value(topk_spec, t, wid)
        return torch.cat([vals, ids.to(torch.float32)], -1), ok

    def oracle(log: EventBatch, wid: int, partition=None):
        # top k of the window's (price, auction) pairs in lexicographic order,
        # duplicates kept; only pairs at or above the k-th largest price can
        # be among them, so only those are sorted
        m = _bid_mask(log, assigner, wid).reshape(-1)
        prices = torch.where(m, log.price.reshape(-1), float("-inf"))
        kth = torch.topk(prices, k).values[-1]
        cand = m & (prices >= kth)
        sv, si = lex_sort(prices[cand], log.auction.reshape(-1)[cand])
        pad = max(0, k - sv.shape[0])
        sv = torch.cat([torch.full((pad,), float("-inf"), device=sv.device), sv])
        si = torch.cat([torch.zeros(pad, dtype=si.dtype, device=si.device), si])
        return sv[-k:].flip(0), si[-k:].flip(0)

    return Query("q7", num_partitions, window_len, assigner, (topk_spec,), None,
                 fold, read, oracle, out_width=2 * k)


# ---------------------------------------------------------------------------
# Query 1 (paper Listing 2): local/global bid-count ratio
# ---------------------------------------------------------------------------


def make_q1_ratio(num_partitions: int, window_len: int = 1000, num_slots: int = 16,
                  hop: int | None = None) -> Query:
    assigner = as_assigner(window_len, hop)
    gspec = W.wgcounter(window_len, num_slots, num_partitions, assigner=assigner)
    lspec = _local_gcounter(window_len, num_slots, assigner)

    def fold(shared, local, batch: EventBatch, partition, batch_idx=None):
        (g,) = shared
        is_bid = batch.valid & (batch.kind == KIND_BID)
        wm = batch_watermark(batch)
        ones = torch.ones_like(batch.price)
        g = W.insert(gspec, g, partition, batch.ts, is_bid, batch_idx=batch_idx,
                     actor=partition, amounts=ones)
        g = W.increment_watermark(gspec, g, partition, wm)
        local = W.insert(lspec, local, 0, batch.ts, is_bid, batch_idx=batch_idx,
                         actor=0, amounts=ones)
        local = W.increment_watermark(lspec, local, 0, wm)
        return (g,), local

    def read(shared, local, wid: int):
        (g,) = shared
        gv, ok1 = W.window_value(gspec, g, wid)
        lv, ok2 = W.window_value(lspec, local, wid)
        return (lv / gv.clamp(min=1.0)).reshape(-1, 1), ok1 & ok2

    def oracle(log: EventBatch, wid: int, partition=None):
        m = _bid_mask(log, assigner, wid)
        total = m.sum().to(torch.float32)
        if partition is None:
            return total
        return m[partition].sum().to(torch.float32) / total.clamp(min=1.0)

    return Query("q1_ratio", num_partitions, window_len, assigner, (gspec,), lspec,
                 fold, read, oracle, out_width=1)


# ---------------------------------------------------------------------------
# Q5: hot items — top-1 auction bucket by bid count over a hopping window
# ---------------------------------------------------------------------------


def make_q5(num_partitions: int, window_len: int = 1000, num_slots: int = 16,
            hop: int | None = None, num_auctions: int = 64) -> Query:
    """Which auction bucket (``auction % num_auctions``) received the most
    bids in each sliding window; ``hop`` defaults to ``window_len // 2``.
    Output lanes are ``[count, bucket]``; ties go to the lowest bucket."""
    hop = window_len // 2 if hop is None else hop
    assigner = as_assigner(window_len, hop)
    cnt_spec = W.wgcounter(window_len, num_slots, num_partitions,
                           key_shape=(num_auctions,), assigner=assigner)

    def fold(shared, local, batch: EventBatch, partition, batch_idx=None):
        (c,) = shared
        is_bid = batch.valid & (batch.kind == KIND_BID)
        bucket = (batch.auction % num_auctions).to(torch.int32)
        c = W.insert(cnt_spec, c, partition, batch.ts, is_bid, batch_idx=batch_idx,
                     actor=partition, amounts=torch.ones_like(batch.price), keys=bucket)
        c = W.increment_watermark(cnt_spec, c, partition, batch_watermark(batch))
        return (c,), local

    def read(shared, local, wid: int):
        (c,) = shared
        counts, ok = W.window_value(cnt_spec, c, wid)
        hot = counts.argmax(-1)
        top = counts.gather(-1, hot.unsqueeze(-1)).squeeze(-1)
        return torch.stack([top, hot.to(torch.float32)], -1), ok

    def oracle(log: EventBatch, wid: int, partition=None):
        m = _bid_mask(log, assigner, wid)
        bucket = log.auction[m] % num_auctions
        cnts = torch.bincount(bucket, minlength=num_auctions).to(torch.float32)
        hot = cnts.argmax()
        return torch.stack([cnts[hot], hot.to(torch.float32)])

    return Query("q5", num_partitions, window_len, assigner, (cnt_spec,), None,
                 fold, read, oracle, out_width=2)


def q5_hot_oracle(log: EventBatch, wid: int, assigner: WindowAssigner,
                  num_keys: int) -> torch.Tensor:
    """Q5 ground truth over the full auction-id domain, the oracle of the
    hash-sharded keyed dataplane (docs/protocol.md §6): a segment sum of the
    window's bids per id, ``[count, auction_id]`` of the hottest, ties to the
    lowest id.  Counts are integers, exact in f32 below 2^24."""
    m = _bid_mask(log, assigner, wid)
    cnts = torch.bincount(log.auction[m], minlength=num_keys).to(torch.float32)
    hot = cnts.argmax()
    return torch.stack([cnts[hot], hot.to(torch.float32)])
