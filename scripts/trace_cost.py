#!/usr/bin/env python3
"""What does tracing cost a runtime run on the card, with and without a
spill?

  python3 scripts/trace_cost.py [--rounds 4] [--batches 400]

Runs the port's Holon runtime (q7 at ``SimConfig()``'s deployment under a
concurrent failure of two nodes, as ``chip_smoke.py`` phase 5 does) in
three modes, each in a fresh harness: untraced; traced with the online
monitor on at the default ring, which holds the whole trace; and traced,
monitored and spilled to a spool beyond a 4,096-record ring.  Every round
runs the three modes once, in an order rotated from round to round, so
that a drift in the host's speed falls on each mode alike.  Besides each
run's wall seconds it clocks the host seconds spent inside the telemetry's
two recording calls (``Telemetry.event`` and ``Telemetry.net_msg``: the
record, the ring or the spool, and the monitor) and inside the monitor's
feed alone.  Prints the card's name and power limit, one JSON line a run,
then one JSON line of each mode's median.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MODES = ("untraced", "traced", "traced_spilled")
SPILL_CAP = 1 << 12


class Clock:
    """Host seconds inside ``fn``, summed over its calls."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batches", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.runtime import FailureScenario, HolonHarness, SimConfig
    from repro_torch.streaming.queries import make_q7

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    cfg = SimConfig(num_batches=args.batches)
    q7 = make_q7(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)
    concurrent = FailureScenario.concurrent(nodes=cfg.initial_membership[:2])
    horizon = cfg.horizon_ms + 20_000
    # the kernels build at their first launch: a short warm run first
    HolonHarness(dataclasses.replace(cfg, num_batches=20), q7, device="cuda").run()
    clocks = {name: Clock(getattr(Telemetry, name)) for name in ("event", "net_msg")}
    for name, c in clocks.items():
        setattr(Telemetry, name, lambda self, *a, _c=c, **k: _c(self, *a, **k))

    walls = {m: [] for m in MODES}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.rounds):
            for mode in MODES[r % 3:] + MODES[:r % 3]:
                run_cfg = cfg
                if mode != "untraced":
                    run_cfg = dataclasses.replace(cfg, obs=True, obs_monitor=True)
                if mode == "traced_spilled":
                    run_cfg = dataclasses.replace(
                        run_cfg, obs_trace_cap=SPILL_CAP,
                        obs_spill_path=os.path.join(tmp, f"round{r}.jsonl"))
                h = HolonHarness(run_cfg, q7, device="cuda")
                feed = None
                if h.monitor is not None:
                    feed = Clock(h.monitor.feed)
                    h.obs.unsubscribe(h.monitor.feed)
                    h.obs.subscribe(feed)
                for c in clocks.values():
                    c.seconds = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h.run(concurrent, horizon)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                walls[mode].append(wall)
                print(json.dumps({
                    "round": r, "mode": mode, "wall_s": wall,
                    "telemetry_host_s": sum(c.seconds for c in clocks.values()),
                    "monitor_host_s": feed.seconds if feed else 0.0,
                    "records": h.obs.buf.total, "spilled": h.obs.buf.spilled,
                    "dropped": h.obs.buf.dropped, "card": card}), flush=True)
    med = {m: statistics.median(w) for m, w in walls.items()}
    print(json.dumps({"batches": args.batches, "rounds": args.rounds, "median_wall_s": med,
                      "traced_minus_untraced_s": med["traced"] - med["untraced"],
                      "spilled_minus_untraced_s": med["traced_spilled"] - med["untraced"],
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
