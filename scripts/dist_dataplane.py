#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone: the dense and keyed dataplanes
across processes.

  python3 scripts/dist_dataplane.py

Builds the kernels, runs phase 4's dense runs and its keyed runs (the
full-size keyed run, the chaos schedules, dense q5 at 10,000 auctions) at
the full-size deployment (their outputs are what the ranks are held to,
handed over by file), then phase 11 and 11b: 4 rank processes of 4
partitions each, NCCL with one card a rank where the machine shows 4
cards, else gloo with the ranks sharing one.  Prints the phases' lines,
then one JSON line of phase 11's rows, 11b's last.  Needs an NVIDIA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_dataplane: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = f"[{'; '.join(smi)}]"
    cs.log(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
           f"{torch.__version__} {card}")
    report = build.build(ops.SOURCES)
    cs.log(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="dist_dataplane-") as tmp:
        tmp = Path(tmp)
        handover = tmp / "phase4"
        handover.mkdir()
        cs.run_dataplane(torch.device("cuda"), handover)
        cs.log(f"phase 4's dense runs done at {time.perf_counter() - t0:.1f} s")
        cs.run_keyed(torch.device("cuda"), handover)
        cs.log(f"phase 4's keyed runs done at {time.perf_counter() - t0:.1f} s")
        rows = cs.run_dist_dataplane(card, handover, tmp)
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"phase11": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
