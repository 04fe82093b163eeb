"""Windowed CRDTs — Algorithm 1 of the paper (port of ``repro.core.wcrdt``).

A WCRDT wraps a CRDT of ``crdt.py`` with a ring of ``W`` window slots,
``slot_wid[W]`` (the window id each slot holds, -1 when empty), a
``progress[P]`` map of per-partition local watermarks, the per-partition
batch frontier ``folded[P]`` and monotone error counters.

Every state here is *stacked*: each tensor has a leading replica axis
``[S]`` and replica ``s`` is the state one partition holds, so one GPU runs
the ``S`` replicas that the JAX package spreads over the ``data`` mesh.
``insert`` folds replica ``s``'s own batch row as ``partition[s]`` (or,
in the keyed dataplane, each lane as its own source partition); the sync
functions join the mesh's gathered ``[R]`` stack into the ``[S_local]``
replicas a process holds (``S_local = R`` on one device; a rank's group of
partitions across processes).  The last
section holds the hash-sharded keyed state (``KeyShards``).  Semantics are
those of the JAX package, function by function.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import crdt as crdts
from repro_torch.core.crdt import _per_replica
from repro_torch.core.lattice import (
    Reduce, as_dtype, axis_reduce_leaf, field_kinds, join, join_many, join_stacked, map_fields,
)
from repro_torch.core.window import Tumbling, WindowAssigner, expand_events
from repro_torch.kernels import ops
from repro_torch.kernels import ref

NO_WID = -1
I32_MAX = 2**31 - 1
ERR_LATE = 0  # events older than the partition's own watermark
ERR_RING = 1  # events whose window had already been evicted from the ring
ERR_EVICT_INCOMPLETE = 2  # slot reused before its window completed
NUM_ERRS = 3
SCATTER_ROWS = 4096  # rows each replica's lanes split into for a scatter-max (insert)


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
    # (windows, slot_ids, mask, **inputs) -> windows; a counter's fold also
    # takes inplace=True (insert(owned=True)): the caller owns windows, so
    # the fold may write into them, not copy them
    fold: Callable[..., Any]
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


def _scatter_max(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``base.scatter_reduce(1, idx, src, "amax")`` for ``[S, n]`` cells and
    ``[S, L]`` lanes.  A batch's lanes crowd into a few cells (one or two
    ring slots, one frontier entry per source), and on the card an integer
    scatter-max is a compare-and-swap loop that serialises on a shared
    cell; so each replica's lanes scatter as up to ``SCATTER_ROWS`` rows of
    their own, joined after (the same max)."""
    S, L = idx.shape
    G = math.gcd(L, SCATTER_ROWS)
    if G == 1:
        return base.scatter_reduce(1, idx, src, "amax")
    rows = base.repeat_interleave(G, 0).scatter_reduce(
        1, idx.reshape(S * G, -1), src.reshape(S * G, -1), "amax")
    return rows.reshape(S, G, -1).amax(1)


def _lane_index(x, S: int, device) -> torch.Tensor:
    """A partition or batch index per replica (an int or ``[S]``, as
    ``[S, 1]``) or per lane (``[S, B]``, as it is): i64, broadcasting over
    the batch's lanes."""
    if isinstance(x, torch.Tensor) and x.dim() == 2:
        return x.to(device=device, dtype=torch.int64)
    return _per_replica(x, S, device).unsqueeze(1)


def insert(
    spec: WSpec, state: WState, partition, ts: torch.Tensor, mask: torch.Tensor,
    batch_idx=None, owned: bool = False, **inputs
) -> WState:
    """Fold each replica's batch (``ts``, ``mask`` and payload ``inputs``,
    all ``[S, B]``) into its window ring as ``partition``: an int, ``[S]``,
    or ``[S, B]`` per lane (the keyed dataplane, whose owners fold lanes
    routed from every source partition).

    Events below their partition's own watermark are dropped and counted
    (ERR_LATE); slot reuse resets the slot's CRDT to zero first; events for
    evicted windows are dropped and counted (ERR_RING).  Under an
    overlapping assigner each event expands into ``windows_per_event``
    lanes.  With ``batch_idx`` (same forms as ``partition``) a lane folds
    only if ``batch_idx >= folded[partition]`` (replay idempotence), and
    ``folded[partition]`` rises to ``batch_idx + 1`` for every lane, masked
    or not.

    With ``owned`` the caller owns ``state``: nothing reads it after the
    call (the dataplane's own running state).  The result is the same.
    Where the windows are a counter's or a register's (``_OWNED_RING``) and
    the partition and batch index are one a replica (an int or ``[S]``),
    the ring bookkeeping is one launch (``ops.ring_insert``) that resets
    only the advancing slots of the window leaves, in place, and a
    counter's fold writes each replica's actor row back into the leaf it
    was given.  ``slot_wid``, ``progress``, ``folded`` and ``errors`` stay
    new tensors: the sync baselines hold the old ones.
    """
    if owned:
        out = _insert_owned(spec, state, partition, ts, mask, batch_idx, inputs)
        if out is not None:
            return out
    S = ts.shape[0]
    W = spec.num_slots
    dev = ts.device
    part = _lane_index(partition, S, dev)
    ts = as_dtype(ts, torch.int32)
    if batch_idx is not None:
        bidx = _lane_index(batch_idx, S, dev).to(torch.int32)
        mask = mask & (bidx >= state.folded.gather(1, part))

    late = mask & (ts < state.progress.gather(1, part))
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
    slot64 = slot.to(torch.int64)

    # newest incoming window id per slot (masked lanes contribute NO_WID)
    new_slot_wid = _scatter_max(state.slot_wid, slot64, torch.where(mask, wid, NO_WID))

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
    stale = mask & (wid < new_slot_wid.gather(1, slot64))
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
        folded = _scatter_max(folded, *torch.broadcast_tensors(part, bidx + 1))
    return WState(new_slot_wid, windows, state.progress, folded, errors)


def _replica_index(x, S: int, device):
    """A per-replica partition or batch index as the ring launch takes it:
    an int (or None) as it is, a tensor as i64 ``[S]``."""
    if not isinstance(x, torch.Tensor) or (x.shape == (S,) and x.dtype == torch.int64
                                           and x.device == torch.device(device)):
        return x
    return _per_replica(x, S, device).contiguous()


# the window CRDTs whose ring bookkeeping ``insert(owned=True)`` runs as one
# launch: every cell of each leaf's zero, and the keywords its fold takes
# there (a counter's fold writes each replica's actor row back into the
# leaf it owns; a register's writes a new tensor either way)
_OWNED_RING = {
    crdts.GCounter: (0.0, {"inplace": True}),
    crdts.PNCounter: (0.0, {"inplace": True}),
    crdts.MaxReg: (float("-inf"), {}),
    crdts.MinReg: (float("inf"), {}),
}


def _insert_owned(spec: WSpec, state: WState, partition, ts, mask, batch_idx,
                  inputs: dict) -> WState | None:
    """:func:`insert` on a state its caller owns, with the ring bookkeeping
    in one launch; None where that does not apply: windows not in
    ``_OWNED_RING`` (TopK, GSet), an active-window cap, a ring larger than
    the kernel holds, lanes of their own partitions, leaves that are not
    contiguous f32 (a broadcast of one row)."""
    ring = _OWNED_RING.get(type(state.windows))
    if (ring is None or spec.max_active_windows is not None
            or spec.num_slots > ops.RING_MAX_SLOTS
            or any(isinstance(x, torch.Tensor) and x.dim() > 1 for x in (partition, batch_idx))):
        return None
    leaves = [getattr(state.windows, n) for n in field_kinds(state.windows)]
    if not all(l.dtype == torch.float32 and l.is_contiguous() for l in leaves):
        return None
    fill, fold_kw = ring
    S, B = ts.shape
    dev = ts.device
    a = spec.assigner
    slot, valid, slot_wid, folded, errors = ops.ring_insert(
        as_dtype(ts, torch.int32).contiguous(), mask.contiguous(),
        _replica_index(partition, S, dev), _replica_index(batch_idx, S, dev),
        state.slot_wid, state.progress, state.folded, state.errors,
        leaves, [fill] * len(leaves), a.hop, a.window_len)
    K = a.windows_per_event
    if K > 1:
        inputs = {k: _expand_payload(v, B, K) for k, v in inputs.items()}
    windows = spec.fold(state.windows, slot, valid, **fold_kw, **inputs)
    return WState(slot_wid, windows, state.progress, folded, errors)


def increment_watermark(spec: WSpec, state: WState, partition, ts) -> WState:
    """Raise each replica's ``progress[partition]`` to ``ts`` (``[S]``)."""
    S = state.progress.shape[0]
    dev = state.progress.device
    rows = torch.arange(S, device=dev)
    part = _per_replica(partition, S, dev)
    new = state.progress.clone()
    new[rows, part] = torch.maximum(new[rows, part], as_dtype(ts, torch.int32))
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
    the CRDT's zero aggregate, ok=True: each replica's slot row is picked
    from the state or the zero windows first, then read once.
    """
    slot = wid % spec.num_slots
    tenant = state.slot_wid[:, slot]
    resident = tenant == wid
    ok = window_complete(spec, state, wid) & ~(tenant > wid)

    def pick(x, z):  # the slot's rows [S, 1, ...]
        rows = x[:, slot]
        m = resident.reshape(-1, *(1,) * (rows.dim() - 1))
        return torch.where(m, rows, z[slot]).unsqueeze(1)

    picked = map_fields(pick, state.windows, spec.zero_windows(tenant.device))
    return spec.read(picked, 0), ok


def merge(spec: WSpec, a: WState, b: WState) -> WState:
    return _merge_wstate(a, b)


def axis_join(spec: WSpec, state: WState, mesh) -> WState:
    """Full-state background sync: gather every replica's state, join the
    stack (log-depth), and hand the join back to each of the mesh's
    ``local_size`` replicas."""
    joined = join_stacked(mesh.all_gather(state), merge_fn=_merge_wstate)
    return mesh.replicate(joined)


def axis_join_aligned(spec: WSpec, state: WState, mesh) -> WState:
    """Full-state sync of replicas that hold the same ``slot_wid`` (lockstep
    windows, as the step-windowed training-metrics lattice does): each
    elementwise leaf joins by its reduce over the stack (``amax``, ``amin``
    or bitwise or), broadcast back to every replica; a custom window lattice
    (TopK) joins the replicas with :func:`join_many`."""
    kinds = field_kinds(state.windows)
    if not all(isinstance(k, Reduce) for k in kinds.values()):
        whole = join_many([map_fields(lambda x: x[i:i + 1], state.windows)
                           for i in range(state.slot_wid.shape[0])])
    windows = type(state.windows)(**{
        n: axis_reduce_leaf(k, getattr(state.windows, n)) if isinstance(k, Reduce)
        else getattr(whole, n)[0]
        for n, k in kinds.items()
    })
    return mesh.replicate(WState(
        slot_wid=state.slot_wid.amax(0),
        windows=windows,
        progress=state.progress.amax(0),
        folded=state.folded.amax(0),
        errors=state.errors.amax(0),
    ))


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
    custom ones (TopK) take the log-depth pairwise join.  The dataplane
    joins the stack into its replicas with :func:`join_delta_stack`."""
    kinds = field_kinds(stacked.windows)
    if not all(isinstance(k, Reduce) for k in kinds.values()):
        return join_stacked(stacked, merge_fn=_merge_wstate)
    wid = stacked.slot_wid
    merged = {
        name: ops.gated_delta_merge(wid, getattr(stacked.windows, name), op=kind.value)
        for name, kind in kinds.items()
    }
    return WState(
        slot_wid=ops.crdt_merge(wid, "max"),
        windows=type(stacked.windows)(**merged),
        progress=ops.crdt_merge(stacked.progress, "max"),
        folded=ops.crdt_merge(stacked.folded, "max"),
        errors=ops.crdt_merge(stacked.errors, "max"),
    )


def join_delta_stack(spec: WSpec, state: WState, stacked: WState) -> WState:
    """``_merge_wstate(state, merge_delta_stack(spec, stacked))``: the
    ``[R]``-stacked deltas merged once and joined into each replica of the
    ``[S]``-stacked ``state``.  When every window field is elementwise this
    is one fused kernel launch (``ops.delta_merge_join``); TopK takes the
    two steps."""
    kinds = field_kinds(state.windows)
    if not all(isinstance(k, Reduce) for k in kinds.values()):
        return _merge_wstate(state, merge_delta_stack(spec, stacked))
    wid, leaves, (progress, folded, errors) = ops.delta_merge_join(
        state.slot_wid, stacked.slot_wid,
        [getattr(state.windows, n) for n in kinds], [getattr(stacked.windows, n) for n in kinds],
        [k.value for k in kinds.values()],
        [state.progress, state.folded, state.errors],
        [stacked.progress, stacked.folded, stacked.errors])
    return WState(wid, type(state.windows)(**dict(zip(kinds, leaves))), progress, folded, errors)


def delta_axis_join(
    spec: WSpec, state: WState, baseline_folded: torch.Tensor,
    baseline_progress: torch.Tensor, mesh,
) -> tuple[WState, torch.Tensor]:
    """Dirty-slot-gated background sync of every replica.

    Each replica extracts its delta since the shared post-sync baseline; the
    deltas are gathered into the ``[R]`` stack of every replica (the stack
    itself, on one device), the stack is merged once, and each of the
    ``S_local`` replicas held here joins the one merged delta into its own
    state — the result of ``R`` identical merges (:func:`join_delta_stack`).
    Returns ``(state, shipped)`` with ``shipped`` f32 ``[S_local]``, each
    replica's modeled wire bytes.
    """
    delta = delta_since(spec, state, baseline_folded, baseline_progress)
    shipped = delta_nbytes(delta)
    return join_delta_stack(spec, state, mesh.all_gather(delta)), shipped


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
        fold=lambda w, s, m, actor, amounts, keys=None, inplace=False: w.fold_windows(
            s, m, actor, amounts, keys, inplace=inplace),
        read=lambda w, slot: w.window_value(slot),
    )


def wpncounter(window_len: int, num_slots: int, num_partitions: int, key_shape=(),
               assigner: WindowAssigner | None = None) -> WSpec:
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.PNCounter.zero_windows(
            num_slots, num_partitions, key_shape, device),
        fold=lambda w, s, m, actor, amounts, keys=None, inplace=False: w.fold_windows(
            s, m, actor, amounts, keys, inplace=inplace),
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


# ---------------------------------------------------------------------------
# Hash-sharded keyed state (docs/protocol.md §6)
# ---------------------------------------------------------------------------


def _shard_multiplier(num_keys: int) -> int:
    """Largest ``a`` with ``a * num_keys < 2**31`` and ``gcd(a, num_keys) == 1``,
    so ``p(k) = (k * a) % num_keys`` is an i32-safe bijection on [0, C)."""
    a = max((2**31 - 1) // num_keys, 1)
    while math.gcd(a, num_keys) != 1:
        a -= 1
    return a


@dataclasses.dataclass(frozen=True)
class KeyShards:
    """Hash routing of a keyed domain [0, C) over S owner shards
    (docs/protocol.md §6).

    The hash is the multiplicative permutation ``p(k) = (k * mult) % C``;
    ``owner = p % S`` spreads consecutive (zipf-hot) keys across shards and
    ``local = p // S`` is a dense index into the owner's ``ceil(C/S)`` key
    range.  :meth:`key_table` is the inverse, ``(shard, local) -> key``.
    Key ids are u32 values carried as int64."""

    num_keys: int  # C, the global keyed domain size
    num_shards: int  # S, owner shards (the stacked partitions)
    mult: int = 0  # permutation multiplier; 0 = derive in __post_init__

    def __post_init__(self):
        if self.mult == 0:
            object.__setattr__(self, "mult", _shard_multiplier(self.num_keys))

    @property
    def width(self) -> int:
        """Local key-range size ``ceil(C/S)``: every shard's state is padded
        to it."""
        return -(-self.num_keys // self.num_shards)

    def perm(self, keys: torch.Tensor) -> torch.Tensor:
        return (keys.to(torch.int64) * self.mult) % self.num_keys

    def shard_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Owner shard id per key (the hash-routing rule)."""
        return self.perm(keys) % self.num_shards

    def local_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Dense index into the owner's local key range."""
        return torch.div(self.perm(keys), self.num_shards, rounding_mode="floor")

    def num_local(self, shard: int) -> int:
        """Real (unpadded) key count of ``shard``'s range."""
        return (self.num_keys - shard + self.num_shards - 1) // self.num_shards

    def key_table(self, device=None) -> torch.Tensor:
        """i64 ``[S, width]`` inverse map ``(shard, local) -> key``; padded
        entries (locals past the shard's real range) carry the sentinel C."""
        C, S = self.num_keys, self.num_shards
        keys = torch.arange(C, dtype=torch.int64, device=device)
        inv = torch.empty_like(keys)
        inv[self.perm(keys)] = keys
        p = (torch.arange(S, dtype=torch.int64, device=device).unsqueeze(1)
             + S * torch.arange(self.width, dtype=torch.int64, device=device))
        return torch.where(p < C, inv[p.clamp(max=C - 1)], C)


def wgcounter_sharded(window_len: int, num_slots: int, num_partitions: int,
                      shards: KeyShards, assigner: WindowAssigner | None = None) -> WSpec:
    """Keyed grow-only counter over one shard's key range
    (docs/protocol.md §6).

    Per replica the state is ``[W, 1, width]``: the key axis holds only the
    shard's ``ceil(C/S)`` locals and the actor axis collapses to 1, because
    every event for a key is routed to its one owner.  ``progress`` and
    ``folded`` keep all ``num_partitions`` source entries.  Fold inputs:
    ``amounts`` per lane and ``keys`` = local indices
    (:meth:`KeyShards.local_of`)."""
    return WSpec(
        window_len=window_len, assigner=assigner, num_slots=num_slots,
        num_partitions=num_partitions,
        zero_windows=lambda device: crdts.GCounter.zero_windows(
            num_slots, 1, (shards.width,), device),
        fold=lambda w, s, m, amounts, keys: w.fold_windows(s, m, 0, amounts, keys),
        read=lambda w, slot: w.window_value(slot),
    )


def shard_topk_read(spec: WSpec, state: WState, wid: int, key_table: torch.Tensor,
                    num_keys: int, mesh, k: int = 1):
    """Cross-shard top-k read of window ``wid`` over a sharded keyed counter
    (docs/protocol.md §6), without gathering the key ranges.

    ``state`` and ``key_table`` hold the mesh's ``L = mesh.local_size``
    shards.  Each shard reduces its ``[width]`` range to k ``(count, key)``
    candidates (padded locals masked through the ``key_table`` sentinel),
    the ``[S, k]`` candidates and every shard's ``ok`` are gathered in one
    collective, and the global top k is chosen by (count desc, global key
    asc).  Returns ``((counts f32[L, k], keys i64[L, k]), ok bool[L])``, the
    same on every shard; ``ok`` requires the window complete and unevicted
    on every shard of the mesh, not only on the ones this process holds."""
    counts, ok = window_value(spec, state, wid)  # [L, width]
    L = mesh.local_size
    masked = torch.where(key_table < num_keys, counts, float("-inf"))
    if k == 1:
        cmax = masked.amax(1, keepdim=True)
        ckey = torch.where(masked == cmax, key_table, num_keys).amin(1)
        cand_c, cand_k, oks = mesh.all_gather((cmax.squeeze(1), ckey, ok))  # [S]
        gmax = cand_c.amax()
        gkey = torch.where(cand_c == gmax, cand_k, num_keys).amin()
        top = (gmax.reshape(1), gkey.reshape(1))
    else:
        # lax.top_k: ties to the lower local index, so a stable sort
        cv, ci = torch.sort(masked, dim=1, descending=True, stable=True)
        cv, ci = cv[:, :k], ci[:, :k]
        ck = torch.where(cv > float("-inf"), key_table.gather(1, ci), num_keys)
        cand_v, cand_k, oks = mesh.all_gather((cv, ck, ok))  # [S, k]
        sv, sk = ref.lex_sort(-cand_v.reshape(-1), cand_k.reshape(-1))
        top = (-sv[:k], sk[:k])
    every = oks.all().expand(L)
    return (top[0].expand(L, k), top[1].expand(L, k)), every
