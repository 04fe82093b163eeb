"""Carry state between numpy and the port's types.

The JAX package's arrays reach these functions as numpy (``np.asarray``),
so both packages can fold the same log from the same state.  Auction,
bidder and TopK ids are u32 values that the port carries as int64; they go
back to uint32 on the way out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.wcrdt import WSpec, WState
from repro_torch.streaming.events import EventBatch


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
