"""The keyed dataplane's runs at the tests' small size, on any mesh.

``tests/test_torch_dist_keyed.py`` makes them on a ``DistMesh`` of gloo
ranks (each rank importing this module) and on a ``StackMesh``; the JAX
reference (``tests/_keyed_reference.py``) shares the sizes.  Imports no
JAX, so a rank process starts quickly.
"""
import numpy as np
import torch

from repro_torch.convert import wstate_to_numpy
from repro_torch.core import wcrdt as W
from repro_torch.core.window import as_assigner
from repro_torch.launch import stream
from repro_torch.streaming.generator import NexmarkConfig, generate_log

C, NB, EPB, WL, SLOTS = 10_000, 8, 256, 100, 16
S = 4  # owner shards
CHAOS_NB = 12
CHAOS_RUNS = ("clean", "crash-replay", "partition healed", "never healed")


def nexmark(nb: int) -> NexmarkConfig:
    return NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=EPB,
                         num_auctions=C, key_skew=1.1)


def read_range(nb: int) -> tuple[int, int]:
    """``(first, n)``: the last (up to 4) windows closed after ``nb`` batches."""
    a = as_assigner(WL, WL // 2)
    closed = int(a.first_dirty_wid(nb * nexmark(nb).batch_span_ms))
    n = min(closed, 4)
    return max(0, closed - n), n


def crash_schedule() -> torch.Tensor:
    """Every shard crashes after step 8 and replays batches 5-8."""
    crash = np.concatenate([np.arange(9), np.arange(5, 9), np.arange(9, CHAOS_NB)])
    return torch.from_numpy(np.tile(crash.astype(np.int32), (S, 1)))


def keyed_runs(mesh) -> dict:
    """Every run, its outputs (and state) gathered over the mesh: ``main``
    (``NB`` batches, provenance on), ``topk3`` (``shard_topk_read`` at k=3
    on ``main``'s state) and the chaos runs at ``CHAOS_NB`` batches
    (``CHAOS_RUNS``); ``main.collectives`` counts the fold's exchanges and
    gathers on a ``DistMesh``."""
    shards = W.KeyShards(C, S)
    table = shards.key_table()
    mine = table[mesh.partitions.start:mesh.partitions.stop]
    res = {}

    def keep(tag, state, outs):
        names = ("oks", "vals", "shuffle", "sync", "prov")
        got = stream.gather_outputs(mesh, (state, *outs))
        res.update({f"{tag}.state.{k}": v for k, v in wstate_to_numpy(got[0]).items()})
        res.update({f"{tag}.{k}": x.numpy() for k, x in zip(names, got[1:])})

    def pipeline(nb, sync_every=4, provenance=False):
        first, n = read_range(nb)
        return stream.build_keyed_pipeline(mesh, shards, window_len=WL, num_slots=SLOTS,
                                           sync_every=sync_every, n_windows=n,
                                           first_window=first, provenance=provenance)

    log = generate_log(nexmark(NB), mesh.device, partitions=mesh.partitions)
    pipe = pipeline(NB, provenance=True)
    stats = getattr(mesh, "stats", None)
    if stats is not None:
        stats.reset()
    state, shuffle, sync, prov = pipe.fold(log, stream.default_fold_schedule(S, NB),
                                           torch.ones(NB // 4, dtype=torch.bool))
    if stats is not None:
        res["main.collectives"] = np.array([stats.exchange.calls, stats.gather.calls])
    keep("main", state, (*pipe.read(state, table), shuffle, sync, prov))
    for w in range(pipe.first_window, pipe.first_window + pipe.n_windows):
        (cnt, key), ok = W.shard_topk_read(pipe.spec, state, w, mine, C, mesh, k=3)
        for name, x in zip(("counts", "keys", "ok"), mesh.all_gather((cnt, key, ok))):
            res[f"topk3.{w}.{name}"] = x.numpy()

    log = generate_log(nexmark(CHAOS_NB), mesh.device, partitions=mesh.partitions)
    base = stream.default_fold_schedule(S, CHAOS_NB)
    crash = crash_schedule()
    healed = torch.ones(CHAOS_NB // 2, dtype=torch.bool)
    healed[1:3] = False  # partitioned for rounds 1-2 of 6, then healed
    for tag, sched, plane, every in (
            ("clean", base, torch.ones(CHAOS_NB // 4, dtype=torch.bool), 4),
            ("crash-replay", crash, torch.ones(crash.shape[1] // 4, dtype=torch.bool), 4),
            ("partition healed", base, healed, 2),
            ("never healed", base, torch.zeros(CHAOS_NB // 2, dtype=torch.bool), 2)):
        p = pipeline(CHAOS_NB, sync_every=every)
        st, shuffle, sync, _ = p.fold(log, sched, plane)
        keep(tag, st, (*p.read(st, table), shuffle, sync))
    return res
