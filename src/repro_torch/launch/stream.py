"""Production streaming driver (port of ``repro.launch.stream``).

The whole Holon pipeline on one device: ``S`` partitions stacked on a
leading axis (``launch/mesh.py``), batched folds through the windowed-fold
and top-k kernels, and every ``sync_every`` folds one background-sync
round — delta-state by default (each replica's dirty slots, merged and
joined into every replica by one fused delta-merge launch a spec), or the
full-state join with ``delta_sync=False``.  Windows are read on the device
at the end.  :func:`build_keyed_pipeline` is the hash-sharded keyed
dataplane: keys are routed to one owner partition each, folded by the
segment-reduce kernel, and only watermarks are synced.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stream --query q4 --partitions 16
  (``--device cpu`` runs the plain versions of the kernels on the host)
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import wcrdt as W
from repro_torch.core.window import as_assigner
from repro_torch.launch.mesh import StackMesh, make_data_mesh
from repro_torch.obs.timing import WallTimer
from repro_torch.streaming.events import KIND_BID, EventBatch
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from repro_torch.streaming.queries import (
    Query,
    make_q0,
    make_q1_ratio,
    make_q4,
    make_q5,
    make_q7,
)

MAKERS = {
    "q0": make_q0,
    "q1_ratio": make_q1_ratio,
    "q4": make_q4,
    "q5": make_q5,
    "q7": make_q7,
}


def build_pipeline(
    query: Query, mesh: StackMesh, sync_every: int, delta_sync: bool = True,
    n_windows: int = 64, first_window: int = 0,
):
    """Returns fn: ``log`` (EventBatch ``[S, num_batches, B]``) ->
    ``(oks f32[S, n], vals f32[S, n, out_width], sync_bytes f32[S])``.

    Folds the batches in order; every ``sync_every`` folds runs one
    background-sync round (trailing batches that do not fill a round are not
    folded, as in the JAX package); finally reads window ids
    ``first_window .. first_window + n_windows - 1``.  ``sync_bytes`` is
    each replica's total modeled sync traffic.
    """
    S, dev = mesh.size, mesh.device
    if query.num_partitions != S:
        raise ValueError(f"query has {query.num_partitions} partitions, mesh {S}")

    def run(log: EventBatch):
        part = torch.arange(S, device=dev)
        shared = query.init_shared(dev)
        local = query.init_local(dev)
        baselines = [W.baseline_of(st) for st in shared]
        sync_bytes = torch.zeros(S, dtype=torch.float32, device=dev)
        n_rounds = log.ts.shape[1] // sync_every
        idx = 0
        for _ in range(n_rounds):
            for _ in range(sync_every):
                shared, local = query.fold(shared, local, log.batch(idx), part, batch_idx=idx)
                idx += 1
            synced = []
            for spec, st, (bf, bp) in zip(query.shared_specs, shared, baselines):
                if delta_sync:
                    st, shipped = W.delta_axis_join(spec, st, bf, bp, mesh)
                else:
                    st = W.axis_join(spec, st, mesh)
                    shipped = W.state_nbytes(st)
                sync_bytes = sync_bytes + shipped
                synced.append(st)
            shared = tuple(synced)
            baselines = [W.baseline_of(st) for st in shared]

        oks, vals = [], []
        for w in range(first_window, first_window + n_windows):
            v, ok = query.read(shared, local, w)
            oks.append(ok.to(torch.float32))
            vals.append(v.to(torch.float32))
        return torch.stack(oks, 1), torch.stack(vals, 1), sync_bytes

    return run


def default_fold_schedule(num_shards: int, num_batches: int) -> torch.Tensor:
    """Failure-free fold schedule for :func:`build_keyed_pipeline`: i32
    ``[num_shards, num_batches]``, every partition folds batch ``t`` at step
    ``t``.  A crash-replay splices a replay (``[0..k, j..k, k+1..]``) into a
    partition's row; the ``folded`` frontier makes re-folds no-ops
    (docs/protocol.md §6)."""
    return torch.arange(num_batches, dtype=torch.int32).expand(num_shards, -1).contiguous()


@dataclasses.dataclass(frozen=True)
class KeyedPipeline:
    """The hash-sharded keyed dataplane that :func:`build_keyed_pipeline`
    builds: ``fold`` runs the steps and sync rounds, ``read`` the windows,
    and a call runs both."""

    mesh: StackMesh
    shards: W.KeyShards
    spec: W.WSpec
    sync_every: int
    n_windows: int
    first_window: int
    provenance: bool

    def fold(self, log: EventBatch, sched, wm_sync):
        """Fold the scheduled batches: ``(state, shuffle_bytes f32[S],
        sync_bytes f32[S], prov i32[S_dst, S_src])``."""
        S, dev, shards, mesh = self.shards.num_shards, self.mesh.device, self.shards, self.mesh
        sched = torch.as_tensor(sched, dtype=torch.int32).to(dev)
        wm_sync = torch.as_tensor(wm_sync, dtype=torch.bool).to(dev)
        B = log.ts.shape[2]
        rows = torch.arange(S, device=dev)
        lowest = -(2**31)
        src = rows.repeat_interleave(B).expand(S, S * B)  # per received lane
        off_mine = (rows[:, None] != rows[None, :]).unsqueeze(2)  # [S_src, S_dst, 1]
        ones = torch.ones((S, S * B), dtype=torch.float32, device=dev)
        state = self.spec.zero(S, dev)
        shuffle = torch.zeros(S, dtype=torch.float32, device=dev)
        sync = torch.zeros(S, dtype=torch.float32, device=dev)
        prov = torch.full((S, S), lowest, dtype=torch.int32, device=dev)
        for r in range(sched.shape[1] // self.sync_every):
            for t in range(r * self.sync_every, (r + 1) * self.sync_every):
                col = sched[:, t]
                ts, kind, auction, valid = (getattr(log, f)[rows, col]
                                            for f in ("ts", "kind", "auction", "valid"))
                is_bid = valid & (kind == KIND_BID)
                # routing stack: [s, d, b] = source s's lane b, owned by d
                m_sb = is_bid.unsqueeze(1) & (shards.shard_of(auction).unsqueeze(1) == rows[:, None])
                r_ts = mesh.all_to_all(ts.unsqueeze(1).expand(S, S, B))
                r_loc = mesh.all_to_all(shards.local_of(auction).unsqueeze(1).expand(S, S, B))
                r_mask = mesh.all_to_all(m_sb)
                shuffle = shuffle + (m_sb & off_mine).sum((1, 2)).to(torch.float32) * 8.0
                state = W.insert(
                    self.spec, state, src, r_ts.reshape(S, S * B), r_mask.reshape(S, S * B),
                    batch_idx=col.repeat_interleave(B).expand(S, S * B), amounts=ones,
                    keys=r_loc.reshape(S, S * B),
                )
                if self.provenance:
                    prov = torch.maximum(prov, torch.where(r_mask, r_ts, lowest).amax(2))
                wm = torch.where(valid, ts, lowest).amax(1)  # each source batch's watermark
                state = W.increment_watermark(self.spec, state, rows, wm)
            on = wm_sync[r]
            state = dataclasses.replace(state, progress=mesh.pmax(state.progress, where=on))
            sync = sync + on.to(torch.float32) * float(S * 4)
        return state, shuffle, sync, prov

    def read(self, state: W.WState, key_table: torch.Tensor):
        """Every shard's hot item of each window: ``(oks f32[S, n], vals
        f32[S, n, 2])``, ``vals`` holding ``[count, auction_id]``."""
        key_table = key_table.to(self.mesh.device)
        oks, vals = [], []
        for w in range(self.first_window, self.first_window + self.n_windows):
            (cnt, key), ok = W.shard_topk_read(self.spec, state, w, key_table,
                                               self.shards.num_keys, self.mesh, k=1)
            oks.append(ok.to(torch.float32))
            vals.append(torch.stack([cnt[:, 0], key[:, 0].to(torch.float32)], -1))
        return torch.stack(oks, 1), torch.stack(vals, 1)

    def __call__(self, log: EventBatch, key_table, sched, wm_sync):
        state, shuffle, sync, prov = self.fold(log, sched, wm_sync)
        out = (*self.read(state, key_table), shuffle, sync)
        return out + (prov,) if self.provenance else out


def build_keyed_pipeline(
    mesh: StackMesh, shards: W.KeyShards, *, window_len: int = 1000,
    num_slots: int = 16, hop: int | None = None, sync_every: int = 4,
    n_windows: int = 8, first_window: int = 0, provenance: bool = False,
) -> KeyedPipeline:
    """Hash-sharded keyed dataplane (docs/protocol.md §6): per-auction bid
    counts over the whole auction-id domain and a cross-shard hot-item read.

    The result is called as ``run(log, key_table, sched, wm_sync) -> (oks
    f32[S, n], vals f32[S, n, 2], shuffle_bytes f32[S], sync_bytes f32[S][,
    prov i32[S, S]])`` where ``log`` is an EventBatch ``[S, num_batches,
    B]``, ``key_table`` is ``shards.key_table()``, ``sched`` i32 ``[S,
    n_steps]`` names the batch each partition folds at each step
    (:func:`default_fold_schedule`), and ``wm_sync`` bool ``[n_steps //
    sync_every]`` says whether round ``r``'s watermark exchange runs (False:
    partitioned, windows stall until it heals).

    Partition ``s`` owns the keys with ``shards.shard_of(k) == s``.  Each
    step every partition routes its bids to their owners
    (``mesh.all_to_all`` of the ``[S_src, S_dst, B]`` routing stack), and
    each owner folds the lanes it received as their source partition, at
    the source's scheduled batch index, into its ``[W, ceil(C/S)]`` range.
    Ownership is exclusive, so a sync round ships only the ``[S]`` progress
    map (``mesh.pmax``).  ``shuffle_bytes`` charges 8 bytes (ts, local) per
    lane sent off its partition; ``sync_bytes`` ``S * 4`` per round with the
    exchange on.  With ``provenance`` a fifth output gives each owner's
    ingest frontier per source: the largest ts among the lanes the source
    routed to it (``-2**31`` where it routed none).  Reads are
    :func:`W.shard_topk_read` with k=1.
    """
    if mesh.size != shards.num_shards:
        raise ValueError(f"{shards.num_shards} shards, mesh {mesh.size}")
    assigner = as_assigner(window_len, hop if hop else window_len // 2)
    spec = W.wgcounter_sharded(window_len, num_slots, shards.num_shards, shards,
                               assigner=assigner)
    return KeyedPipeline(mesh, shards, spec, sync_every, n_windows, first_window, provenance)


def read_window_range(query: Query, horizon_ts: float) -> tuple[int, int]:
    """``(first_wid, n_windows)`` worth reading after a ``horizon_ts`` run:
    the last ring-residency-capped window ids closing within the horizon
    (the usable span is ``num_slots - (K - 1)`` complete ids plus the one
    still-open id at the top of the range)."""
    a = query.assigner
    closed = int(a.first_dirty_wid(horizon_ts))
    rings = [st.num_slots for st in query.shared_specs]
    if query.local_spec is not None:
        rings.append(query.local_spec.num_slots)
    cap = min(rings) if rings else 64
    n = max(1, min(closed + 1, cap - (a.windows_per_event - 1)))
    return max(0, closed + 1 - n), n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q7", choices=sorted(MAKERS))
    ap.add_argument("--partitions", type=int, default=8,
                    help="partitions S, stacked on one device")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--events-per-batch", type=int, default=1024)
    ap.add_argument("--window-len", type=int, default=1000)
    ap.add_argument("--hop", type=int, default=0,
                    help="hopping-window hop; 0 = the query's default "
                         "(tumbling, except q5 which slides by window/2)")
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--full-sync", action="store_true",
                    help="full-state join instead of delta sync")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not 1 <= args.sync_every <= args.batches:
        ap.error(f"--sync-every must be in [1, --batches]; got {args.sync_every}")

    S = args.partitions
    mesh = make_data_mesh(S, args.device)
    nx = NexmarkConfig(
        num_partitions=S, num_batches=args.batches,
        events_per_batch=args.events_per_batch, seed=args.seed,
    )
    log = generate_log(nx, mesh.device)
    kw = {"hop": args.hop} if args.hop else {}
    query = MAKERS[args.query](S, window_len=args.window_len, num_slots=64, **kw)
    horizon_ts = args.batches * nx.batch_span_ms
    first_window, n_windows = read_window_range(query, horizon_ts)
    pipe = build_pipeline(query, mesh, args.sync_every, delta_sync=not args.full_sync,
                          n_windows=n_windows, first_window=first_window)
    pipe(log.map(lambda x: x[:, :args.sync_every]))  # warm-up: one sync round
    with WallTimer(mesh.device) as tm:
        oks, vals, sb = pipe(log)
    dt = tm.dt

    total_events = S * args.batches * args.events_per_batch
    done = int(oks.sum().item()) // S
    rounds = max(args.batches // args.sync_every, 1)
    sync_per_round = float(sb.mean().item()) / rounds
    a = query.assigner
    print(
        f"partitions={S} events={total_events} wall={dt*1e3:.1f}ms "
        f"throughput={total_events/dt/1e6:.2f}M ev/s "
        f"window={a.window_len}/hop={a.hop} complete_windows={done} "
        f"sync={'full' if args.full_sync else 'delta'} "
        f"sync_bytes_per_round={sync_per_round:.0f}"
    )
    return {"events_per_s": total_events / dt, "complete_windows": done,
            "sync_bytes_per_round": sync_per_round}


if __name__ == "__main__":
    main()
