"""Join-semilattice machinery shared by every CRDT (port of ``repro.core.lattice``).

Each CRDT class is a frozen dataclass of tensors that declares, per field,
how the field joins (``KINDS``: field name -> :class:`Reduce`, or
``"custom"`` when the class's own ``merge`` handles it).  Those explicit
per-field maps take the place of the JAX package's pytree registry.

Every function here is indifferent to leading batch dimensions: a stacked
``[S, ...]`` replica state joins the same way a single replica does.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Callable, Sequence

import torch


class Reduce(enum.Enum):
    """Elementwise lattice join kind for one CRDT field."""

    MAX = "max"
    MIN = "min"
    OR = "or"  # boolean / bitmask join


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: ``x`` itself when it is already, with no torch op
    (a ``.to`` that changes nothing is still one dispatched op of host
    time on the hot path)."""
    return x if x.dtype == dtype else x.to(dtype)


def join_leaf(kind: Reduce, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind is Reduce.MAX:
        return torch.maximum(a, b)
    if kind is Reduce.MIN:
        return torch.minimum(a, b)
    if kind is Reduce.OR:
        if a.dtype == torch.bool:
            return a | b
        return torch.bitwise_or(a, b)
    raise ValueError(f"unknown reduce kind {kind}")


def field_kinds(obj) -> dict[str, Reduce | str]:
    """The per-field join map a CRDT class declares as ``KINDS``."""
    return obj.KINDS


def map_fields(fn: Callable[..., torch.Tensor], first, *rest):
    """Apply ``fn`` field by field across CRDTs of one class; same class out."""
    return type(first)(**{
        name: fn(getattr(first, name), *(getattr(r, name) for r in rest))
        for name in field_kinds(first)
    })


def map_tensors(fn: Callable[..., torch.Tensor], first, *rest):
    """Apply ``fn`` to every tensor of a (nested) dataclass state, such as a
    ``WState`` holding a CRDT; ``None`` fields pass through."""
    if isinstance(first, torch.Tensor):
        return fn(first, *rest)
    if first is None:
        return None
    return type(first)(**{
        f.name: map_tensors(fn, getattr(first, f.name), *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(first)
    })


def join(a, b):
    """Generic pairwise lattice join: the class's own ``merge`` when it has
    one (non-elementwise lattices), else field by field per ``KINDS``."""
    if hasattr(a, "merge"):
        return a.merge(b)
    return elementwise_join(a, b)


def elementwise_join(a, b):
    kinds = field_kinds(a)
    for name, kind in kinds.items():
        if not isinstance(kind, Reduce):
            raise ValueError(f"field {name} needs custom merge")
    return type(a)(**{
        name: join_leaf(kind, getattr(a, name), getattr(b, name))
        for name, kind in kinds.items()
    })


def join_many(states: Sequence[Any], merge_fn: Callable[[Any, Any], Any] | None = None):
    """Log-depth fold of N replica states with an associative join."""
    merge_fn = merge_fn or join
    xs = list(states)
    if not xs:
        raise ValueError("join_many of empty sequence")
    while len(xs) > 1:
        nxt = [merge_fn(xs[i], xs[i + 1]) for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2 == 1:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


def join_stacked(stacked, merge_fn: Callable[[Any, Any], Any] | None = None):
    """Join a state whose tensors carry a leading replica axis ``[R, ...]``.

    Log-depth halving: ``O(log R)`` batched merges instead of an ``O(R)``
    sequential fold (the merge functions broadcast over leading dims, so a
    half-stack merges with the other half in one call).  The replica axis is
    removed from the result.
    """
    merge_fn = merge_fn or join
    n = _first_tensor(stacked).shape[0]
    cur = stacked
    while n > 1:
        k = n // 2
        merged = merge_fn(
            map_tensors(lambda x: x[:k], cur), map_tensors(lambda x: x[k:2 * k], cur)
        )
        if n % 2 == 1:
            tail = map_tensors(lambda x: x[2 * k:], cur)
            cur = map_tensors(lambda m, t: torch.cat([m, t], 0), merged, tail)
            n = k + 1
        else:
            cur = merged
            n = k
    return map_tensors(lambda x: x[0], cur)


def _first_tensor(state) -> torch.Tensor:
    if isinstance(state, torch.Tensor):
        return state
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None:
            return _first_tensor(v)
    raise ValueError("state holds no tensor")


def bitwise_or_reduce(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Bitwise-or over one axis (torch has no or-reduction for integers)."""
    if x.dtype == torch.bool:
        return x.any(dim)
    return functools.reduce(torch.bitwise_or, x.unbind(dim))


def axis_reduce_leaf(kind: Reduce, x: torch.Tensor) -> torch.Tensor:
    """Elementwise lattice join of a leaf over its leading replica axis
    (the stacked counterpart of the JAX package's ``pmax``/``pmin``
    all-reduce): ``[R, ...] -> [...]``."""
    if kind is Reduce.MAX:
        return x.amax(0)
    if kind is Reduce.MIN:
        return x.amin(0)
    if kind is Reduce.OR:
        return bitwise_or_reduce(x, 0)
    raise ValueError(f"unknown reduce kind {kind}")


# ---------------------------------------------------------------------------
# Order-preserving packings: let lexicographic lattices (LWW, arg-max) ride a
# plain MAX reduction.
#
# The JAX package packs into uint32.  torch's uint32 has no ``>``, ``max``
# or ``where``-friendly ops, so the port carries the ordered payload as
# int64 holding the u32 value (0 <= u < 2**32): int64 order is u32 order,
# and ``convert.py`` turns it back into uint32 for the JAX side.  The
# packing is a bit reinterpretation (``Tensor.view``), so every f32 bit
# pattern survives the round trip, subnormals included: nothing here
# flushes them to zero.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def float_to_ordered_u32(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection f32 -> u32 (as int64): ``a < b  <=>  f(a) < f(b)``
    (the IEEE 754 trick: flip every bit of a negative, the sign bit of a
    positive)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where(bits >= _SIGN, ~bits & _U32, bits | _SIGN)


def ordered_u32_to_float(u: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`float_to_ordered_u32` (int64 holding u32 in)."""
    u = u.to(torch.int64)
    bits = torch.where(u < _SIGN, ~u & _U32, u & (_SIGN - 1))
    # the u32 bit pattern as an i32 of the same bits
    bits = torch.where(bits >= _SIGN, bits - (1 << 32), bits).to(torch.int32)
    return bits.contiguous().view(torch.float32)


def lex_join(ts_a: torch.Tensor, val_a: torch.Tensor, ts_b: torch.Tensor,
             val_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (timestamp, payload) join — the LWW-register lattice.

    Larger timestamp wins; ties go to the larger payload (the ordered-u32
    compare, on int64), so the join is commutative, associative and
    idempotent."""
    a_wins = (ts_a > ts_b) | ((ts_a == ts_b) & (val_a >= val_b))
    return torch.where(a_wins, ts_a, ts_b), torch.where(a_wins, val_a, val_b)
