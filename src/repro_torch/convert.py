"""Carry state between numpy and the port's types.

The JAX package's arrays reach these functions as numpy (``np.asarray``),
so both packages can fold the same log from the same state; its exported
JSONL traces reach the port's trace analysis as text.  Auction,
bidder and TopK ids are u32 values that the port carries as int64; they go
back to uint32 on the way out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.wcrdt import WSpec, WState
from repro_torch.obs.records import from_jsonl
from repro_torch.runtime.storage import PartitionCheckpoint
from repro_torch.streaming.events import EventBatch
from repro_torch.training.checkpoint import TrainCheckpoint
from repro_torch.training.metrics import MetricSpec
from repro_torch.training.optimizer import AdamWState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def event_batch_from_numpy(arrays: dict, device="cpu") -> EventBatch:
    """An ``EventBatch`` from a dict of numpy arrays keyed by field name."""
    return EventBatch(**{f.name: _tensor(arrays[f.name], device)
                         for f in dataclasses.fields(EventBatch)})


def key_table_from_numpy(table, device="cpu") -> torch.Tensor:
    """A ``KeyShards.key_table`` of the JAX package (u32 ``[S, width]``) as
    the port's int64 table."""
    return _tensor(table, device)


def wstate_from_numpy(spec: WSpec, arrays: dict, device="cpu") -> WState:
    """A stacked ``WState`` from numpy arrays: ``slot_wid``, ``progress``,
    ``folded``, ``errors`` and ``windows.<field>`` per CRDT field.  An
    unstacked state (``slot_wid`` of shape ``[W]``) gains a replica axis of 1."""
    lead = () if np.ndim(arrays["slot_wid"]) == 2 else (None,)

    def get(key):
        return _tensor(arrays[key], device)[lead]

    crdt = type(spec.zero_windows("cpu"))
    return WState(
        slot_wid=get("slot_wid"),
        windows=crdt(**{n: get(f"windows.{n}") for n in crdt.KINDS}),
        progress=get("progress"),
        folded=get("folded"),
        errors=get("errors"),
    )


def wstate_to_numpy(state: WState) -> dict:
    """The reverse of :func:`wstate_from_numpy` (stacked arrays)."""

    def out(t: torch.Tensor) -> np.ndarray:
        a = t.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a

    d = {k: out(getattr(state, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    d.update({f"windows.{n}": out(getattr(state.windows, n)) for n in state.windows.KINDS})
    return d


def checkpoint_from_numpy(ckpt, shared_specs, local_spec: WSpec | None,
                          device="cpu") -> PartitionCheckpoint:
    """A runtime checkpoint of the JAX package as the port's.

    ``ckpt`` has a ``PartitionCheckpoint``'s fields, with ``shared`` a
    tuple of numpy-array dicts (the keys of :func:`wstate_from_numpy`), one
    per shared spec, and ``local`` one such dict or None.  Each state gains
    the port's replica axis of 1; the coverage marker stays host numpy
    i32."""
    baseline = ckpt.baseline
    if baseline is not None:
        baseline = tuple((np.array(f, np.int32), np.array(p, np.int32)) for f, p in baseline)
    return PartitionCheckpoint(
        nxt_idx=int(ckpt.nxt_idx),
        nxt_odx=int(ckpt.nxt_odx),
        emitted_upto=int(ckpt.emitted_upto),
        shared=tuple(wstate_from_numpy(spec, d, device)
                     for spec, d in zip(shared_specs, ckpt.shared)),
        local=None if ckpt.local is None else wstate_from_numpy(local_spec, ckpt.local, device),
        baseline=baseline,
        epoch=int(ckpt.epoch),
    )


def metric_state_from_numpy(spec: MetricSpec, arrays: dict, device="cpu") -> dict:
    """A training-metrics state (``{name: WState}``) from ``{name: numpy
    dict}`` with :func:`wstate_from_numpy`'s keys, one per metric of
    ``spec``; an unstacked JAX state gains the replica axis of 1."""
    return {k: wstate_from_numpy(s, arrays[k], device) for k, s in spec.specs().items()}


def params_from_numpy(tree, device="cpu"):
    """A parameter tree (nested dicts of numpy arrays, the JAX package's
    ``init_params`` layout) as the port's tensors, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def adamw_from_numpy(opt: dict, device="cpu") -> AdamWState:
    """An AdamW state given as ``{"step", "mu", "nu"}`` numpy trees (the
    fields of the JAX package's ``AdamWState``) as the port's."""
    return AdamWState(step=_tensor(np.asarray(opt["step"], np.int32), device),
                      mu=params_from_numpy(opt["mu"], device),
                      nu=params_from_numpy(opt["nu"], device))


def train_state_from_numpy(ckpt: TrainCheckpoint, spec: MetricSpec, device="cpu"):
    """``(params, opt, metrics)`` of a training checkpoint whose trees are
    numpy, dataclasses as dicts of their fields: a blob of the port's
    ``LocalStore``, or of the JAX package's once its ``AdamWState`` and
    ``WState``s are turned into dicts (the JAX classes unpickle only beside
    the JAX package).  A metric state is ``{name: WState fields}``, its
    ``windows`` the CRDT's fields."""
    metrics = {
        name: {**{k: v for k, v in st.items() if k != "windows"},
               **{f"windows.{f}": a for f, a in st["windows"].items()}}
        for name, st in ckpt.metrics.items()
    }
    return (params_from_numpy(ckpt.params, device), adamw_from_numpy(ckpt.opt, device),
            metric_state_from_numpy(spec, metrics, device))


# a JSONL trace the JAX runtime exported (``Telemetry.export_jsonl``) as the
# port's TraceEvents: the two packages share the line format
trace_from_jsonl = from_jsonl
