#!/usr/bin/env python3
"""Time one dense query at chip_smoke.py's full-size deployment, in one process.

  python3 scripts/dense_ab.py [--query q7] [--num-auctions N] [--src DIR]

Builds the kernels, makes the full log (16 partitions x 1,528 batches x
16,384 events), runs the query with delta sync once after a warm sync
round, holds every complete window against the oracle, and profiles 64
batches.  With ``--num-auctions`` (q5) the run is chip_smoke.py's dense q5
at that many zipf(1.1) auctions over 512 batches.  Prints one JSON line:
the log's build seconds, events/s, each kernel's launches in the timed
run, the device's busy and idle share and the device events and top-level
torch ops per batch over the profiled 64 batches.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that a parent tree unpacked beside this one
can be timed on the same card: run parent and change alternating, each in
a fresh process.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q7", choices=cs.QUERIES)
    ap.add_argument("--num-auctions", type=int, default=0,
                    help="q5 only: zipf(1.1) auction ids over this domain, 512 batches")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    if args.num_auctions and args.query != "q5":
        ap.error("--num-auctions applies to q5 only")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline, read_window_range
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    dev = torch.device("cuda")
    build.build(sorted({k.source for k in ops.KERNELS.values()}))
    nx = NexmarkConfig(num_partitions=cs.S, num_batches=cs.NUM_BATCHES,
                       events_per_batch=cs.B, rate_per_partition=cs.RATE, seed=cs.SEED)
    kw = {}
    if args.num_auctions:
        nx = dataclasses.replace(nx, num_batches=cs.SHORT_BATCHES, num_auctions=args.num_auctions,
                                 key_skew=cs.KEY_SKEW, seed=cs.SEED + 2)
        kw = {"num_auctions": args.num_auctions}
    t0 = time.perf_counter()
    the_log = generate_log(nx, dev)
    torch.cuda.synchronize()
    log_s = time.perf_counter() - t0
    q = MAKERS[args.query](cs.S, window_len=cs.WINDOW_MS, num_slots=cs.NUM_SLOTS, **kw)
    mesh = make_data_mesh(cs.S, dev)
    first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
    (oks, vals, _), dt, _ = cs.run_pipeline(q, mesh, the_log, True, first, n)
    launches = {k: kern.launches for k, kern in ops.KERNELS.items()}
    done = cs.check_against_oracle(q, the_log, oks, vals, first)
    part = the_log.map(lambda x: x[:, :64].contiguous())
    pipe = build_pipeline(q, mesh, cs.SYNC_EVERY, n_windows=1)
    prof = cs.profile_run(args.query, lambda: pipe(part))
    events = cs.S * nx.num_batches * cs.B
    print(json.dumps({"src": args.src, "query": args.query, "num_auctions": args.num_auctions,
                      "log_s": log_s, "events_per_s": events / dt, "seconds": dt,
                      "complete_windows": done, "launches": launches,
                      "wall_us_64": prof["wall_us"], "device_busy_us_64": prof["device_busy_us"],
                      "idle_share_64": prof["device_idle_share"],
                      "device_events_per_batch": prof["device_events_per_batch"],
                      "aten_ops_per_batch": prof["aten_ops_per_batch"],
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
