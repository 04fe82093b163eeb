"""dense: the replicated Windowed CRDT dataplane, ``repro_torch.launch.stream.build_pipeline``.

Every partition is a replica of the query's shared state; a pass folds the
whole log batch by batch, runs a sync round (delta or full, as the
configuration's ``sync`` says) every ``sync_every`` batches, and reads the
windows.  The outputs are ``gather_outputs``' ``(oks [S, n], vals [S, n,
w], sync_bytes [S])``.  The query's ``read`` is wrapped to keep a reference
to the state it reads, so that the last pass's state can be checked whole
after the window (:meth:`Plane.window_counts`).
"""
from __future__ import annotations

import dataclasses
import inspect

import torch

from repro_torch.core import wcrdt as W
from repro_torch.launch.stream import MAKERS, build_pipeline, gather_outputs


class Plane:
    def __init__(self, cfg: dict, traffic: dict, mesh, log, first: int, n: int):
        maker = MAKERS[traffic["query"]]
        kw = dict(window_len=cfg["window_len_ms"], num_slots=cfg["num_slots"], hop=cfg["hop_ms"])
        if "num_auctions" in inspect.signature(maker).parameters:
            kw["num_auctions"] = cfg["num_keys"]
        query = maker(cfg["num_partitions"], **kw)
        seen = self.seen = {}  # the state the last pass read; no reference back to the Plane

        def read(shared, local, wid):
            seen["shared"] = shared
            return query.read(shared, local, wid)

        self.mesh, self.log, self.sync_every = mesh, log, cfg["sync_every"]
        self.spec, self.windows = query.shared_specs[0], range(first, first + n)
        self.copies = cfg["num_partitions"]  # every replica holds every key
        self.pipe = build_pipeline(dataclasses.replace(query, read=read), mesh,
                                   cfg["sync_every"], delta_sync=cfg["sync"] == "delta",
                                   n_windows=n, first_window=first)
        self.steps = cfg["num_batches"] // self.sync_every * self.sync_every

    def run_pass(self) -> tuple:
        self.seen.clear()  # the previous pass's state is freed before this one folds
        return gather_outputs(self.mesh, self.pipe(self.log))

    def warmup(self) -> None:
        """One sync round and every read, on the log's first batches."""
        gather_outputs(self.mesh, self.pipe(self.log.map(lambda x: x[:, :self.sync_every])))

    def window_counts(self) -> tuple:
        """The last pass's state, whole: ``(keys i64[L, K], counts f32[L, n,
        K])``, each of this process's replicas' count of every key in each
        window read, by ``W.window_value`` (the read that the query's hot
        item is taken from)."""
        (state,) = self.seen["shared"]
        counts = torch.stack([W.window_value(self.spec, state, w)[0] for w in self.windows], 1)
        keys = torch.arange(counts.shape[-1], device=counts.device)
        return keys.expand(counts.shape[0], -1), counts
