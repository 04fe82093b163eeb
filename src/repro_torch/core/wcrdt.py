"""Windowed CRDTs — Algorithm 1 of the paper (port of ``repro.core.wcrdt``).

A WCRDT wraps a CRDT of ``crdt.py`` with a ring of ``W`` window slots,
``slot_wid[W]`` (the window id each slot holds, -1 when empty), a
``progress[P]`` map of per-partition local watermarks, the per-partition
batch frontier ``folded[P]`` and monotone error counters.

Every state here is *stacked*: each tensor has a leading replica axis
``[S]`` and replica ``s`` is the state one partition holds, so one GPU runs
the ``S`` replicas that the JAX package spreads over the ``data`` mesh.
``insert`` folds replica ``s``'s own batch row as ``partition[s]``; the
sync functions take the replica stack as their gathered input.  Semantics
are those of the JAX package, function by function.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import crdt as crdts
from repro_torch.core.crdt import _per_replica
from repro_torch.core.lattice import (
    Reduce, field_kinds, join, join_stacked, map_fields,
)
from repro_torch.core.window import Tumbling, WindowAssigner, expand_events
from repro_torch.kernels import ops

NO_WID = -1
I32_MAX = 2**31 - 1
ERR_LATE = 0  # events older than the partition's own watermark
ERR_RING = 1  # events whose window had already been evicted from the ring
ERR_EVICT_INCOMPLETE = 2  # slot reused before its window completed
NUM_ERRS = 3


@dataclasses.dataclass(frozen=True)
class WState:
    """Replica states of one Windowed CRDT, stacked over replicas."""

    slot_wid: torch.Tensor  # i32[S, W]
    windows: Any  # CRDT, tensors [S, W, ...]
    progress: torch.Tensor  # i32[S, P]
    folded: torch.Tensor  # i32[S, P]
    errors: torch.Tensor  # i32[S, NUM_ERRS]


def _slot_mask(m: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-slot mask ``[..., W]`` over a leaf ``[..., W, *rest]``."""
    return m.reshape(*m.shape, *(1,) * (leaf.dim() - m.dim()))


def _merge_wstate(a: WState, b: WState) -> WState:
    """Slot-aware lattice join: per slot the larger wid wins outright, equal
    wids join the CRDT.  ``b`` may lack ``a``'s leading replica axis (a merged
    delta joined into every replica); it broadcasts."""
    a_newer = a.slot_wid > b.slot_wid
    same = a.slot_wid == b.slot_wid
    bw = map_fields(lambda lb, la: lb.expand_as(la), b.windows, a.windows)
    joined = join(a.windows, bw)

    def pick(la, lb, lj):
        return torch.where(_slot_mask(same, la), lj,
                           torch.where(_slot_mask(a_newer, la), la, lb))

    return WState(
        slot_wid=torch.maximum(a.slot_wid, b.slot_wid),
        windows=map_fields(pick, a.windows, bw, joined),
        progress=torch.maximum(a.progress, b.progress),
        folded=torch.maximum(a.folded, b.folded),
        errors=torch.maximum(a.errors, b.errors),
    )


@dataclasses.dataclass(frozen=True)
class WSpec:
    """Static spec of a Windowed CRDT."""

    window_len: int
    num_slots: int  # ring size W
    num_partitions: int  # P — progress map size
    zero_windows: Callable[[Any], Any]  # (device) -> CRDT with [W] leading axis
    fold: Callable[..., Any]  # (windows, slot_ids, mask, **inputs) -> windows
    read: Callable[[Any, int], Any]  # (windows, slot) -> per-replica value
    # partition-ordered batches span few windows: when set, insert() finds
    # each batch's lowest window id and the fold visits only this many
    # window offsets (lanes beyond are dropped and counted as ERR_RING)
    max_active_windows: int | None = None
    assigner: WindowAssigner | None = None  # None -> Tumbling(window_len)

    def __post_init__(self):
        if self.assigner is None:
            object.__setattr__(self, "assigner", Tumbling(self.window_len))
        elif self.assigner.window_len != self.window_len:
            raise ValueError(
                f"assigner window_len {self.assigner.window_len} != spec "
                f"window_len {self.window_len}"
            )
        if self.assigner.windows_per_event > self.num_slots:
            raise ValueError(
                f"assigner spans {self.assigner.windows_per_event} concurrent "
                f"windows per event but the ring has only {self.num_slots} "
                "slots; raise num_slots or the hop"
            )

    def zero(self, num_replicas: int, device=None) -> WState:
        S, W, P = num_replicas, self.num_slots, self.num_partitions
        z = self.zero_windows(device)
        return WState(
            slot_wid=torch.full((S, W), NO_WID, dtype=torch.int32, device=device),
            windows=map_fields(lambda x: x.expand(S, *x.shape).clone(), z),
            progress=torch.zeros((S, P), dtype=torch.int32, device=device),
            folded=torch.zeros((S, P), dtype=torch.int32, device=device),
            errors=torch.zeros((S, NUM_ERRS), dtype=torch.int32, device=device),
        )


def _expand_payload(x, B: int, K: int):
    """Repeat a lane-aligned ``[S, B]`` payload into ``[S, B*K]`` lanes; a
    per-replica scalar (``actor=partition``) passes through."""
    if isinstance(x, torch.Tensor) and x.dim() == 2 and x.shape[1] == B:
        return x.repeat_interleave(K, dim=1)
    return x


def insert(
    spec: WSpec, state: WState, partition, ts: torch.Tensor, mask: torch.Tensor,
    batch_idx=None, **inputs
) -> WState:
    """Fold each replica's batch (``ts``, ``mask`` and payload ``inputs``,
    all ``[S, B]``) into its window ring as ``partition`` (an int, or
    ``[S]``).

    Events below the partition's own watermark are dropped and counted
    (ERR_LATE); slot reuse resets the slot's CRDT to zero first; events for
    evicted windows are dropped and counted (ERR_RING).  Under an
    overlapping assigner each event expands into ``windows_per_event``
    lanes.  With ``batch_idx`` the fold is a no-op unless
    ``batch_idx >= folded[partition]`` (replay idempotence).
    """
    S = ts.shape[0]
    W = spec.num_slots
    dev = ts.device
    rows = torch.arange(S, device=dev)
    part = _per_replica(partition, S, dev)
    ts = ts.to(torch.int32)
    if batch_idx is not None:
        bidx = _per_replica(batch_idx, S, dev).to(torch.int32)
        mask = mask & (bidx >= state.folded[rows, part]).unsqueeze(1)

    late = mask & (ts < state.progress[rows, part].unsqueeze(1))
    mask = mask & ~late
    n_late = late.sum(1)

    K = spec.assigner.windows_per_event
    if K == 1:
        wid = spec.assigner.window_of(ts)
    else:
        B = ts.shape[1]
        wid, mask = expand_events(spec.assigner, ts, mask)
        inputs = {k: _expand_payload(v, B, K) for k, v in inputs.items()}
    slot = torch.remainder(wid, W)

    # newest incoming window id per slot (masked lanes contribute NO_WID)
    inc_wid = torch.where(mask, wid, NO_WID)
    seg_max = torch.full((S, W), NO_WID, dtype=torch.int32, device=dev).scatter_reduce(
        1, slot.to(torch.int64), inc_wid, "amax"
    )
    new_slot_wid = torch.maximum(state.slot_wid, seg_max)

    # reset slots whose tenant window advances; flag evictions of windows
    # that were not complete yet
    advancing = new_slot_wid > state.slot_wid
    gwm_wid = spec.assigner.first_dirty_wid(global_watermark(spec, state))
    evict_bad = advancing & (state.slot_wid >= 0) & (state.slot_wid >= gwm_wid.unsqueeze(1))
    windows = map_fields(
        lambda leaf, z: torch.where(_slot_mask(advancing, leaf), z, leaf),
        state.windows, spec.zero_windows(dev),
    )

    # valid events belong to the (new) tenant window of their slot
    stale = mask & (wid < new_slot_wid.gather(1, slot.to(torch.int64)))
    valid = mask & ~stale
    n_ring = stale.sum(1)

    if spec.max_active_windows is not None:
        lo = torch.where(valid, wid, I32_MAX).amin(1)
        over = valid & (wid >= (lo + spec.max_active_windows).unsqueeze(1))
        valid = valid & ~over
        n_ring = n_ring + over.sum(1)
        windows = spec.fold(windows, slot, valid, lo=lo, **inputs)
    else:
        windows = spec.fold(windows, slot, valid, **inputs)

    errors = state.errors + torch.stack(
        [n_late, n_ring, evict_bad.sum(1)], dim=1
    ).to(torch.int32)
    folded = state.folded
    if batch_idx is not None:
        folded = folded.clone()
        folded[rows, part] = torch.maximum(folded[rows, part], bidx + 1)
    return WState(new_slot_wid, windows, state.progress, folded, errors)


def increment_watermark(spec: WSpec, state: WState, partition, ts) -> WState:
    """Raise each replica's ``progress[partition]`` to ``ts`` (``[S]``)."""
    S = state.progress.shape[0]
    dev = state.progress.device
    rows = torch.arange(S, device=dev)
    part = _per_replica(partition, S, dev)
    new = state.progress.clone()
    new[rows, part] = torch.maximum(new[rows, part], ts.to(torch.int32))
    return dataclasses.replace(state, progress=new)


def global_watermark(spec: WSpec, state: WState) -> torch.Tensor:
    return state.progress.amin(-1)


def window_complete(spec: WSpec, state: WState, wid: int) -> torch.Tensor:
    """Complete once the global watermark passes the window's end."""
    return global_watermark(spec, state) >= spec.assigner.end_ts(wid)


def window_value(spec: WSpec, state: WState, wid: int):
    """Unsafe-mode read of window ``wid`` on every replica: ``(value, ok)``.

    ok=False means not complete or already evicted.  A complete window whose
    slot holds an older tenant (or nothing) is globally empty and reads as
    the CRDT's zero aggregate, ok=True.
    """
    slot = wid % spec.num_slots
    tenant = state.slot_wid[:, slot]
    resident = tenant == wid
    ok = window_complete(spec, state, wid) & ~(tenant > wid)
    S = tenant.shape[0]
    zero = map_fields(lambda x: x.expand(S, *x.shape),
                      spec.zero_windows(tenant.device))
    val = spec.read(state.windows, slot)
    zval = spec.read(zero, slot)
    if isinstance(val, tuple):
        return tuple(_pick_rows(resident, v, z) for v, z in zip(val, zval)), ok
    return _pick_rows(resident, val, zval), ok


def _pick_rows(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(m.reshape(-1, *(1,) * (a.dim() - 1)), a, b)


def merge(spec: WSpec, a: WState, b: WState) -> WState:
    return _merge_wstate(a, b)


def axis_join(spec: WSpec, state: WState, mesh) -> WState:
    """Full-state background sync: gather every replica's state, join the
    stack (log-depth), and hand the join back to every replica."""
    joined = join_stacked(mesh.all_gather(state), merge_fn=_merge_wstate)
    return mesh.replicate(joined)


# ---------------------------------------------------------------------------
# Delta-based synchronization
# ---------------------------------------------------------------------------


def delta_since(
    spec: WSpec, state: WState, baseline_folded: torch.Tensor,
    baseline_progress: torch.Tensor,
) -> WState:
    """Each replica's sync delta: only ring slots that may have changed since
    its baseline ``(folded, progress)``; clean slots carry wid -1 and zero
    contents, the identities of the slot-aware join.

    A slot is dirty iff its tenant wid reaches
    ``assigner.first_dirty_wid(frontier)``, where the frontier is the oldest
    baseline watermark among partitions whose batch frontier advanced.
    """
    advanced = state.folded > baseline_folded
    any_adv = advanced.any(-1)
    frontier = torch.where(advanced, baseline_progress, I32_MAX).amin(-1)
    dirty_wid = spec.assigner.first_dirty_wid(frontier.clamp(min=0))
    dirty = (state.slot_wid >= dirty_wid.unsqueeze(-1)) & any_adv.unsqueeze(-1)
    windows = map_fields(
        lambda leaf, z: torch.where(_slot_mask(dirty, leaf), leaf, z),
        state.windows, spec.zero_windows(dirty.device),
    )
    return WState(
        slot_wid=torch.where(dirty, state.slot_wid, NO_WID),
        windows=windows,
        progress=state.progress,  # tiny; always shipped
        folded=state.folded,
        errors=state.errors,
    )


def _wire_itemsize(t: torch.Tensor) -> int:
    """Bytes per element on the wire: int64 tensors carry u32 ids (TopK),
    which the JAX package ships as 4 bytes."""
    return 4 if t.dtype == torch.int64 else t.element_size()


def _replica_nbytes(t: torch.Tensor) -> int:
    """Wire bytes of one replica's row of a stacked tensor."""
    return math.prod(t.shape[1:]) * _wire_itemsize(t)


def delta_nbytes(delta: WState) -> torch.Tensor:
    """Per-replica wire size of a stacked delta, f32 ``[S]``: bytes of the
    dirty slots plus the progress/folded/errors metadata."""
    per_slot = sum(
        math.prod(l.shape[2:]) * _wire_itemsize(l)
        for l in (getattr(delta.windows, n) for n in field_kinds(delta.windows))
    )
    meta = sum(_replica_nbytes(t) for t in (delta.progress, delta.folded, delta.errors))
    return (delta.slot_wid >= 0).to(torch.float32).sum(-1) * float(per_slot) + float(meta)


def state_nbytes(state: WState) -> float:
    """Full-replica wire size (every field shipped) of one replica of a
    stacked state — the delta's comparand."""
    leaves = [state.slot_wid, state.progress, state.folded, state.errors]
    leaves += [getattr(state.windows, n) for n in field_kinds(state.windows)]
    return float(sum(_replica_nbytes(t) for t in leaves))


def baseline_of(state: WState) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(folded, progress)`` marker of what ``state`` covers."""
    return (state.folded, state.progress)


def zero_baseline(spec: WSpec, num_replicas: int, device=None):
    """Baseline of peers known to hold nothing: the next delta is the full
    resident state."""
    z = torch.zeros((num_replicas, spec.num_partitions), dtype=torch.int32, device=device)
    return (z, z.clone())


def merge_delta_stack(spec: WSpec, stacked: WState) -> WState:
    """Join an ``[R]``-stacked pile of deltas slot-aware; the replica axis
    goes.  Elementwise window lattices ride the gated delta-merge kernel;
    custom ones (TopK) take the log-depth pairwise join."""
    kinds = field_kinds(stacked.windows)
    if not all(isinstance(k, Reduce) for k in kinds.values()):
        return join_stacked(stacked, merge_fn=_merge_wstate)
    wid = stacked.slot_wid
    merged = {
        name: ops.gated_delta_merge(wid, getattr(stacked.windows, name), op=kind.value)
        for name, kind in kinds.items()
    }
    return WState(
        slot_wid=wid.amax(0),
        windows=type(stacked.windows)(**merged),
        progress=stacked.progress.amax(0),
        folded=stacked.folded.amax(0),
        errors=stacked.errors.amax(0),
    )


def delta_axis_join(
    spec: WSpec, state: WState, baseline_folded: torch.Tensor,
    baseline_progress: torch.Tensor, mesh,
) -> tuple[WState, torch.Tensor]:
    """Dirty-slot-gated background sync of every replica.

    Each replica extracts its delta since the shared post-sync baseline; the
    deltas are gathered (the stack itself, on one device), the stack is
    merged once, and each replica joins the one merged delta into its own
    state — the result of ``S`` identical merges.  Returns ``(state,
    shipped)`` with ``shipped`` f32 ``[S]``, each replica's modeled wire
    bytes.
    """
    delta = delta_since(spec, state, baseline_folded, baseline_progress)
    shipped = delta_nbytes(delta)
    merged = merge_delta_stack(spec, mesh.all_gather(delta))
    return _merge_wstate(state, merged), shipped


# ---------------------------------------------------------------------------
# Spec constructors for the CRDT catalog
# ---------------------------------------------------------------------------


def wgcounter(window_len: int, num_slots: int, num_partitions: int, key_shape=(),
              assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.GCounter.zero_windows(
            num_slots, num_partitions, key_shape, device),
        fold=lambda w, s, m, actor, amounts, keys=None: w.fold_windows(s, m, actor, amounts, keys),
        read=lambda w, slot: w.window_value(slot),
    )


def wpncounter(window_len: int, num_slots: int, num_partitions: int, key_shape=(),
               assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.PNCounter.zero_windows(
            num_slots, num_partitions, key_shape, device),
        fold=lambda w, s, m, actor, amounts, keys=None: w.fold_windows(s, m, actor, amounts, keys),
        read=lambda w, slot: w.window_value(slot),
    )


def wmaxreg(window_len: int, num_slots: int, num_partitions: int, key_shape=(),
            assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.MaxReg.zero_windows(num_slots, key_shape, device),
        fold=lambda w, s, m, vals, keys=None: w.fold_windows(s, m, vals, keys),
        read=lambda w, slot: w.window_value(slot),
    )


def wminreg(window_len: int, num_slots: int, num_partitions: int, key_shape=(),
            assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.MinReg.zero_windows(num_slots, key_shape, device),
        fold=lambda w, s, m, vals, keys=None: w.fold_windows(s, m, vals, keys),
        read=lambda w, slot: w.window_value(slot),
    )


def wtopk(window_len: int, num_slots: int, num_partitions: int, k: int,
          max_active_windows: int | None = 8,
          assigner: WindowAssigner | None = None) -> WSpec:
    aw = max_active_windows
    if aw is not None and aw > num_slots:
        # more active offsets than ring slots would alias (wid % W)
        raise ValueError(f"max_active_windows={aw} exceeds num_slots={num_slots}")
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.TopK.zero_windows(num_slots, k, device),
        fold=(
            (lambda w, s, m, vals, ids, lo: w.fold_windows(s, m, vals, ids, lo=lo, active=aw))
            if aw is not None
            else (lambda w, s, m, vals, ids: w.fold_windows(s, m, vals, ids))
        ),
        read=lambda w, slot: w.window_value(slot),
        max_active_windows=aw,
    )


def wgset(window_len: int, num_slots: int, num_partitions: int, domain: int,
          assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.GSet.zero_windows(num_slots, domain, device),
        fold=lambda w, s, m, elems: w.fold_windows(s, m, elems),
        read=lambda w, slot: w.window_value(slot),
    )
