"""Windowed CRDTs of the catalog on stacked replicas (port of ``repro.core.crdt``).

Every class is a join-semilattice stored with a ring-slot axis ``[W]``
behind the replica axis ``[S]``: replica ``s`` folds its own batch of lanes
``[s, :]`` into its own state ``[s, ...]``.  The folds of GCounter,
PNCounter, MaxReg and MinReg run the windowed-fold kernel and TopK's runs
the per-window top-k kernel; the counters' reads fold their actor rows by
the actor-sum kernel (``kernels/ops.py``); ``merge`` is the join
declared per field in ``KINDS`` (TopK's is custom).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from repro_torch.core.lattice import (
    Reduce, as_dtype, float_to_ordered_u32, lex_join, ordered_u32_to_float,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref

NEG_INF = float("-inf")


def _per_replica(x, S: int, device) -> torch.Tensor:
    """A per-replica index: an int for every replica, or an ``[S]`` tensor."""
    if isinstance(x, torch.Tensor):
        if x.device != torch.device(device):
            x = x.to(device)
        return as_dtype(x, torch.int64).expand(S)
    return torch.full((S,), int(x), dtype=torch.int64, device=device)


def _i32(x: torch.Tensor | None) -> torch.Tensor | None:
    return None if x is None else as_dtype(x, torch.int32).contiguous()


def _actor_fold(rows_state, slot_ids, mask, actor, amounts, keys, op="sum", inplace=False):
    """Fold ``amounts`` into each replica's own actor row of a
    ``[S, W, P, *key]`` counter through the windowed-fold kernel, with that
    row as the kernel's ``init``.  Returns the new state tensor: a new
    tensor, or with ``inplace`` (a state the caller owns) ``rows_state``
    with the folded rows written back."""
    S, W, P = rows_state.shape[:3]
    key_shape = rows_state.shape[3:]
    C = math.prod(key_shape)
    args = (as_dtype(amounts, torch.float32).contiguous(), _i32(slot_ids), mask.contiguous(), W)
    if P == 1:  # one actor row (the keyed and local counters): fold it whole
        out = ops.window_agg(*args, op=op, keys=_i32(keys), C=C,
                             init=rows_state.reshape(S, W, C).contiguous())
        return out.reshape(rows_state.shape)
    rows = torch.arange(S, device=rows_state.device)
    actor = _per_replica(actor, S, rows_state.device)
    init = rows_state[rows, :, actor].reshape(S, W, C)
    out = ops.window_agg(*args, op=op, keys=_i32(keys), C=C, init=init)
    new = rows_state if inplace else rows_state.clone()
    new[rows, :, actor] = out.reshape(S, W, *key_shape)
    return new


@dataclasses.dataclass(frozen=True)
class GCounter:
    """slots[S, W, actor, *key]; merge = elementwise max; value = sum(actors)."""

    slots: torch.Tensor
    KINDS: ClassVar[dict] = {"slots": Reduce.MAX}

    @classmethod
    def zero_windows(cls, W: int, num_actors: int, key_shape=(), device=None):
        return cls(slots=torch.zeros((W, num_actors, *key_shape), device=device))

    def fold_windows(self, slot_ids, mask, actor, amounts, keys=None,
                     inplace=False) -> "GCounter":
        """Add each replica's non-negative ``amounts`` into its ``actor`` row
        (with ``inplace``, into ``self``'s tensor: see ``_actor_fold``)."""
        return GCounter(_actor_fold(self.slots, slot_ids, mask, actor, amounts, keys,
                                    inplace=inplace))

    def window_value(self, slot: int) -> torch.Tensor:
        return ops.actor_sum(self.slots[:, slot])


@dataclasses.dataclass(frozen=True)
class PNCounter:
    """Positive/negative GCounter pair — supports signed updates."""

    pos: torch.Tensor
    neg: torch.Tensor
    KINDS: ClassVar[dict] = {"pos": Reduce.MAX, "neg": Reduce.MAX}

    @classmethod
    def zero_windows(cls, W: int, num_actors: int, key_shape=(), device=None):
        z = torch.zeros((W, num_actors, *key_shape), device=device)
        return cls(pos=z, neg=z.clone())

    def fold_windows(self, slot_ids, mask, actor, amounts, keys=None,
                     inplace=False) -> "PNCounter":
        a = amounts.to(torch.float32)
        return PNCounter(
            _actor_fold(self.pos, slot_ids, mask, actor, a.clamp(min=0), keys, inplace=inplace),
            _actor_fold(self.neg, slot_ids, mask, actor, (-a).clamp(min=0), keys,
                        inplace=inplace),
        )

    def window_value(self, slot: int) -> torch.Tensor:
        return ops.actor_sum(self.pos[:, slot]) - ops.actor_sum(self.neg[:, slot])


def _reg_fold(v, slot_ids, mask, vals, keys, op):
    S, W = v.shape[:2]
    key_shape = v.shape[2:]
    C = math.prod(key_shape)
    out = ops.window_agg(
        vals.to(torch.float32).contiguous(), _i32(slot_ids), mask.contiguous(), W,
        op=op, keys=_i32(keys), C=C, init=v.reshape(S, W, C).contiguous(),
    )
    return out.reshape(S, W, *key_shape)


@dataclasses.dataclass(frozen=True)
class MaxReg:
    v: torch.Tensor  # f32[S, W, *key]
    KINDS: ClassVar[dict] = {"v": Reduce.MAX}

    @classmethod
    def zero_windows(cls, W: int, key_shape=(), device=None):
        return cls(v=torch.full((W, *key_shape), NEG_INF, device=device))

    def fold_windows(self, slot_ids, mask, vals, keys=None) -> "MaxReg":
        return MaxReg(_reg_fold(self.v, slot_ids, mask, vals, keys, "max"))

    def window_value(self, slot: int) -> torch.Tensor:
        return self.v[:, slot]


@dataclasses.dataclass(frozen=True)
class MinReg:
    v: torch.Tensor  # f32[S, W, *key]
    KINDS: ClassVar[dict] = {"v": Reduce.MIN}

    @classmethod
    def zero_windows(cls, W: int, key_shape=(), device=None):
        return cls(v=torch.full((W, *key_shape), float("inf"), device=device))

    def fold_windows(self, slot_ids, mask, vals, keys=None) -> "MinReg":
        return MinReg(_reg_fold(self.v, slot_ids, mask, vals, keys, "min"))

    def window_value(self, slot: int) -> torch.Tensor:
        return self.v[:, slot]


@dataclasses.dataclass(frozen=True)
class GSet:
    """Bitmap G-Set over a bounded domain: u8[S, W, domain] (0/1, so
    scatter-max is or)."""

    bits: torch.Tensor
    KINDS: ClassVar[dict] = {"bits": Reduce.OR}

    @classmethod
    def zero_windows(cls, W: int, domain: int, device=None):
        return cls(bits=torch.zeros((W, domain), dtype=torch.uint8, device=device))

    def fold_windows(self, slot_ids, mask, elems) -> "GSet":
        S, W, D = self.bits.shape
        cell = slot_ids.to(torch.int64) * D + elems.to(torch.int64)
        flat = self.bits.reshape(S, W * D).scatter_reduce(
            1, cell, mask.to(torch.uint8), "amax"
        )
        return GSet(flat.reshape(S, W, D))

    def window_value(self, slot: int) -> torch.Tensor:
        return self.bits[:, slot].to(torch.bool)


@dataclasses.dataclass(frozen=True)
class LWWReg:
    """Last-writer-wins register: the lexicographic (ts, payload) lattice.

    ``val`` is the ordered-u32 payload carried as int64 (see
    ``core/lattice.py``); a float goes in through
    :func:`float_to_ordered_u32`.  Not windowed, and indifferent to leading
    dimensions, as in the JAX package."""

    ts: torch.Tensor  # i32[*key_shape]
    val: torch.Tensor  # i64[*key_shape], u32 values
    KINDS: ClassVar[dict] = {"ts": "custom", "val": "custom"}

    @classmethod
    def zero(cls, key_shape=(), device=None):
        return cls(
            ts=torch.full(key_shape, -(2**31), dtype=torch.int32, device=device),
            val=torch.zeros(key_shape, dtype=torch.int64, device=device),
        )

    def merge(self, other: "LWWReg") -> "LWWReg":
        return LWWReg(*lex_join(self.ts, self.val, other.ts, other.val))

    def set_float(self, ts, x, key=None) -> "LWWReg":
        x = torch.as_tensor(x, dtype=torch.float32, device=self.val.device)
        return self._set(ts, float_to_ordered_u32(x), key)

    def set_u32(self, ts, x, key=None) -> "LWWReg":
        return self._set(ts, torch.as_tensor(x, dtype=torch.int64, device=self.val.device), key)

    def _set(self, ts, u, key) -> "LWWReg":
        ts = torch.as_tensor(ts, dtype=torch.int32, device=self.ts.device)
        if key is None:
            return LWWReg(*lex_join(self.ts, self.val, ts, u))
        nts, nval = lex_join(self.ts[key], self.val[key], ts, u)
        new_ts, new_val = self.ts.clone(), self.val.clone()
        new_ts[key], new_val[key] = nts, nval
        return LWWReg(new_ts, new_val)

    @property
    def value_float(self) -> torch.Tensor:
        return ordered_u32_to_float(self.val)

    @property
    def value_u32(self) -> torch.Tensor:
        return self.val


def _topk_join_sorted(vals_a, ids_a, vals_b, ids_b, k: int):
    """Join two top-k sets (desc-sorted, -inf padded) into the top-k of the
    union: a two-key stable sort, duplicates collapsed (set semantics)."""
    return ref.lex_topk(torch.cat([vals_a, vals_b], -1), torch.cat([ids_a, ids_b], -1), k)


@dataclasses.dataclass(frozen=True)
class TopK:
    """Top-k (value, id) pairs per window, descending, padded with (-inf, 0).

    Ids are u32 values carried as int64 (torch has no ordered uint32 ops);
    the byte counters of ``core/wcrdt.py`` still charge 4 bytes each."""

    vals: torch.Tensor  # f32[S, W, k]
    ids: torch.Tensor  # i64[S, W, k]
    KINDS: ClassVar[dict] = {"vals": "custom", "ids": "custom"}

    @classmethod
    def zero_windows(cls, W: int, k: int, device=None):
        return cls(
            vals=torch.full((W, k), NEG_INF, device=device),
            ids=torch.zeros((W, k), dtype=torch.int64, device=device),
        )

    @property
    def k(self) -> int:
        return self.vals.shape[-1]

    def merge(self, other: "TopK") -> "TopK":
        return TopK(*_topk_join_sorted(self.vals, self.ids, other.vals, other.ids, self.k))

    def fold_windows(self, slot_ids, mask, vals, ids, lo=None, active: int = 8) -> "TopK":
        """Per-window top-k fold of each replica's batch with the top-k kernel.

        With ``lo`` (the batch's lowest window id per replica, from
        ``WSpec.max_active_windows``) only lanes of the ``active`` window
        offsets from ``lo`` that are non-negative window ids fold, as in the
        JAX package's fast path; every other slot's row comes back as it was.
        """
        if lo is not None:
            W = self.vals.shape[-2]
            off = torch.remainder(slot_ids - lo.unsqueeze(-1), W)
            mask = mask & (off < active) & (lo.unsqueeze(-1) + off >= 0)
        v, i = ops.topk_window(
            self.vals.contiguous(), self.ids.contiguous(),
            vals.to(torch.float32).contiguous(), ids.to(torch.int64).contiguous(),
            _i32(slot_ids), mask.contiguous(),
        )
        return TopK(v, i)

    def window_value(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.vals[:, slot], self.ids[:, slot]

