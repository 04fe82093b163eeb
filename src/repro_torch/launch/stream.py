"""Production streaming driver (port of ``repro.launch.stream``).

The whole Holon pipeline on one device: ``S`` partitions stacked on a
leading axis (``launch/mesh.py``), batched folds through the windowed-fold
and top-k kernels, and every ``sync_every`` folds one background-sync
round — delta-state by default (each replica's dirty slots, merged once by
the gated delta-merge kernel and joined into every replica), or the
full-state join with ``delta_sync=False``.  Windows are read on the device
at the end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stream --query q4 --partitions 16
  (``--device cpu`` runs the plain versions of the kernels on the host)
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import wcrdt as W
from repro_torch.launch.mesh import StackMesh, make_data_mesh
from repro_torch.obs.timing import WallTimer
from repro_torch.streaming.events import EventBatch
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
