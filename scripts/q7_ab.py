#!/usr/bin/env python3
"""Time q7 at chip_smoke.py's full-size dense deployment, in one process.

  python3 scripts/q7_ab.py [--src DIR]

Builds the kernels, makes the full log (16 partitions x 1,528 batches x
16,384 events), runs q7 with delta sync once after a warm sync round, holds
every complete window against the oracle, and profiles 64 batches.  Prints
one JSON line: the log's build seconds, events/s, the device's busy and
idle share, and the ``topk_window`` launches of the timed run.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that a parent tree unpacked beside this one
can be timed on the same card: run parent and change alternating, each in
a fresh process.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q7_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline, read_window_range
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    dev = torch.device("cuda")
    build.build(list(ops.KERNELS))
    nx = NexmarkConfig(num_partitions=cs.S, num_batches=cs.NUM_BATCHES,
                       events_per_batch=cs.B, rate_per_partition=cs.RATE, seed=cs.SEED)
    t0 = time.perf_counter()
    the_log = generate_log(nx, dev)
    torch.cuda.synchronize()
    log_s = time.perf_counter() - t0
    q = MAKERS["q7"](cs.S, window_len=cs.WINDOW_MS, num_slots=cs.NUM_SLOTS)
    mesh = make_data_mesh(cs.S, dev)
    first, n = read_window_range(q, cs.NUM_BATCHES * nx.batch_span_ms)
    (oks, vals, _), dt, _ = cs.run_pipeline(q, mesh, the_log, True, first, n)
    launches = ops.KERNELS["topk_window"].launches
    done = cs.check_against_oracle(q, the_log, oks, vals, first)
    part = the_log.map(lambda x: x[:, :64].contiguous())
    pipe = build_pipeline(q, mesh, cs.SYNC_EVERY, n_windows=1)
    prof = cs.profile_run("q7", lambda: pipe(part))
    events = cs.S * cs.NUM_BATCHES * cs.B
    print(json.dumps({"src": args.src, "log_s": log_s, "events_per_s": events / dt,
                      "seconds": dt, "complete_windows": done, "topk_launches": launches,
                      "wall_us_64": prof["wall_us"], "device_busy_us_64": prof["device_busy_us"],
                      "idle_share_64": prof["device_idle_share"],
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
