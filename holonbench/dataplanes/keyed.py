"""keyed: the hash-sharded dataplane, ``repro_torch.launch.stream.build_keyed_pipeline``.

Auction ids are hash-sharded over the partitions (``KeyShards``); a pass
routes each step's bids to their owner shards, folds them, joins the
watermarks every ``sync_every`` steps (the gated ``pmax``, every round on)
and reads each window's hottest auction across the shards, under the
failure-free schedule.  The outputs are ``gather_outputs``' ``(oks [S, n],
vals [S, n, 2], shuffle_bytes [S], sync_bytes [S])``.  The pipeline's
``read`` is wrapped to keep a reference to the state it reads, so that the
last pass's state can be checked whole after the window
(:meth:`Plane.window_counts`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import wcrdt as W
from repro_torch.core.wcrdt import KeyShards
from repro_torch.launch.stream import build_keyed_pipeline, default_fold_schedule, gather_outputs


class Plane:
    def __init__(self, cfg: dict, traffic: dict, mesh, log, first: int, n: int):
        S, nb, every = cfg["num_partitions"], cfg["num_batches"], cfg["sync_every"]
        shards = KeyShards(cfg["num_keys"], S)
        self.mesh, self.log, self.sync_every = mesh, log, every
        self.table = shards.key_table(mesh.device)
        self.sched = default_fold_schedule(S, nb)
        self.wm_sync = torch.ones(nb // every, dtype=torch.bool)
        pipe = build_keyed_pipeline(mesh, shards, window_len=cfg["window_len_ms"],
                                    num_slots=cfg["num_slots"], hop=cfg["hop_ms"],
                                    sync_every=every, n_windows=n, first_window=first)
        seen = self.seen = {}  # the state the last pass read; no reference back to the Plane

        class Recorded(type(pipe)):
            def read(self, state, key_table):
                seen["state"] = state
                return super().read(state, key_table)

        self.pipe = Recorded(**{f.name: getattr(pipe, f.name) for f in dataclasses.fields(pipe)})
        self.windows = range(first, first + n)
        self.copies = 1  # one owner shard holds each key
        self.steps = nb // every * every

    def run_pass(self) -> tuple:
        self.seen.clear()  # the previous pass's state is freed before this one folds
        return gather_outputs(self.mesh, self.pipe(self.log, self.table, self.sched, self.wm_sync))

    def warmup(self) -> None:
        """One watermark round and every read, on the log's first batches."""
        every = self.sync_every
        gather_outputs(self.mesh, self.pipe(self.log, self.table, self.sched[:, :every],
                                            self.wm_sync[:1]))

    def window_counts(self) -> tuple:
        """The last pass's state, whole: ``(keys i64[L, width], counts f32[L,
        n, width])``, each of this process's owner shards' count of every
        local key in each window read, by ``W.window_value`` (the read that
        the shards' hot items are taken from), and the global id of each
        local key by the program's ``key_table`` (``num_keys`` where a local
        is padding).  The check holds the table to cover every key once."""
        parts = self.mesh.partitions
        state = self.seen["state"]
        counts = torch.stack([W.window_value(self.pipe.spec, state, w)[0]
                              for w in self.windows], 1)
        return self.table[parts.start:parts.stop], counts
