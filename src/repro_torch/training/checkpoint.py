"""Decentralized checkpointing — Algorithm 2's ``sometimes do storage.put``
applied to training state (port of ``repro.training.checkpoint``).

Every worker persists its own shard ``(step, params, opt, metrics,
data_idx)`` on its own schedule; no barrier, no coordinator.  The store
applies the paper's lattice rule (largest ``step`` wins per shard key), so
concurrent or straggling writers can never regress a checkpoint.  Restore
+ deterministic data order (seeded, indexable stream) + the metric windows'
deterministic reads give exactly-once training-step semantics after any
crash.

A blob holds numpy trees only: a tensor becomes a numpy array, a dataclass
(``AdamWState``, a metric ``WState`` and its CRDT) the dict of its fields,
and nothing of torch or JAX is pickled.  :func:`repro_torch.convert.
train_state_from_numpy` turns such trees back into the port's tensors and
states, and reads a JAX ``LocalStore`` blob's trees the same way.
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Any

import torch


@dataclasses.dataclass
class TrainCheckpoint:
    step: int
    data_idx: int
    params: Any
    opt: Any
    metrics: Any
    rng_seed: int


def to_numpy_tree(tree):
    """Tensors to numpy arrays, dataclasses to dicts of their fields,
    dicts, lists and tuples kept; other leaves (ints, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_numpy_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree


class LocalStore:
    """Filesystem store; one blob per (worker/partition) key.

    put() keeps the largest-step blob (Algorithm 2 merge rule); get()
    returns the blob's numpy trees."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.ckpt"

    def put(self, key: str, ckpt: TrainCheckpoint) -> bool:
        cur = self.get_step(key)
        if cur is not None and cur > ckpt.step:
            return False
        blob = {
            "step": ckpt.step,
            "data_idx": ckpt.data_idx,
            "rng_seed": ckpt.rng_seed,
            "params": to_numpy_tree(ckpt.params),
            "opt": to_numpy_tree(ckpt.opt),
            "metrics": to_numpy_tree(ckpt.metrics),
        }
        tmp = self._path(key).with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        tmp.rename(self._path(key))  # atomic publish
        return True

    def _blob(self, key: str) -> dict | None:
        p = self._path(key)
        if not p.exists():
            return None
        with open(p, "rb") as f:
            return pickle.load(f)

    def get(self, key: str) -> TrainCheckpoint | None:
        blob = self._blob(key)
        if blob is None:
            return None
        return TrainCheckpoint(step=blob["step"], data_idx=blob["data_idx"],
                               params=blob["params"], opt=blob["opt"],
                               metrics=blob["metrics"], rng_seed=blob["rng_seed"])

    def get_step(self, key: str) -> int | None:
        blob = self._blob(key)
        return None if blob is None else blob["step"]

