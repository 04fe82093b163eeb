"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 holonbench/control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size and in one process (on a cell of
several cards, one process a rank, as ``run.py``): draw the log, run one
whole pass of the program as the window does and compare its outputs and
its state (every key's count in each window read) with the plain
reference, then compare the control's in the same way.
The control is the reference itself, put in the program's place and
computed with bf16 counters, the nearest precision below the f32 counters
the configurations state.  Prints one JSON line a seed, then the lower
reading of each number (the largest over the program's seeds) and the
upper one (the least over the control's).  The benchmark's own runs do not
run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]


def readings(cell, seeds, opt) -> list:
    """Each seed's ``{"seed", "program", "control"}`` compared numbers (on
    rank 0; ``opt`` a ``bench.Options`` whose seed is not used)."""
    from holonbench import bench

    cfg = {**cell.config, **(opt.scale or {})}
    with bench.process_group(opt) as dist:
        mesh = bench.make_mesh(cfg, opt, dist)
        rows = []
        for seed in seeds:
            fields, plane = bench.make_plane(cell, cfg, mesh, seed)
            outs = [plane.run_pass()]
            view, copies = plane.window_counts(), plane.copies
            del plane
            ok, vals, counts = bench.reference(cell, cfg, fields, opt.world)
            c_outs, c_view, c_copies = bench.control_outputs(cell, cfg, fields, opt.world,
                                                             opt.rank)
            row = {"seed": seed}
            for side, o, v, cp in (("program", outs, view, copies),
                                   ("control", [c_outs], c_view, c_copies)):
                state = bench.check_state(v, cp, ok, counts, dist)
                checks, attempted, failed = bench.compare(o, ok, vals, state)
                row[side] = {k: c["value"] for k, c in checks.items()}
                row[side + "_failed"] = f"{failed} of {attempted}"
            rows.append(row)
            del fields, outs, view, c_outs, c_view, counts
    return rows if opt.rank == 0 else []


def summary(rows: list) -> dict:
    names = rows[0]["program"]
    return {k: {"lower": max(r["program"][k] for r in rows),
                "upper": min(r["control"][k] for r in rows)} for k in names}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    import torch

    from holonbench import bench, ranks
    from holonbench.cell import find_cell

    cell = find_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    opt = bench.Options(seed=0, seconds=0.0, rank=a.rank, world=cell.chips, init_method=a.init)
    if a.rank != 0:
        readings(cell, seeds, opt)
        return 0
    if cell.chips == 1:
        rows = readings(cell, seeds, opt)
    else:
        from repro_torch.kernels import build, ops

        build.build(ops.SOURCES)
        with ranks.others(str(Path(__file__).resolve()), argv, cell.chips) as init:
            opt.init_method = init
            rows = readings(cell, seeds, opt)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": a.workload, "seconds": time.perf_counter() - T_START,
                      "readings": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
