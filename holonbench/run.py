"""Run one cell of the benchmark once and print its result line.

    python3 holonbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for (``BENCHMARK.json``; ``holonbench/README.md``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last the ``checks``, each number compared beside its limit, which also
end standard error.  On a cell of several cards this process is rank 0 and
starts the others.  It exits with another code than 0, and prints no
result, without the cards the cell needs, or when a module of JAX or of the
JAX package is loaded at the end.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the harness as the package holonbench, the program from src/; not this folder's modules
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "holonbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "holonbench" / "torch_extensions")


def card_lines(n: int) -> list[str]:
    """``nvidia-smi``'s name and power limit of the cards used."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return out.strip().splitlines()[:n]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)  # the ranks' meeting address
    a = ap.parse_args(argv)

    import torch

    from holonbench import bench, ranks
    from holonbench.cell import find_cell

    cell = find_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    opt = bench.Options(seed=a.seed, seconds=a.seconds, trace=bool(a.trace), t_start=T_START,
                        rank=a.rank, world=cell.chips, init_method=a.init)
    if a.rank != 0:
        bench.run(cell, opt)
        return 0
    if cell.chips == 1:
        result = bench.run(cell, opt)
    else:
        from repro_torch.kernels import build, ops

        build.build(ops.SOURCES)  # once, before the other ranks look for it
        with ranks.others(str(Path(__file__).resolve()), argv, cell.chips) as init:
            opt.init_method = init
            result = bench.run(cell, opt)

    bad = bench.forbidden_modules()
    if bad:
        print(f"loaded at the end of the run, and forbidden: {bad}", file=sys.stderr)
        return 3
    for line in card_lines(cell.chips):
        print(f"card: {line}", file=sys.stderr)
    print("set-up phases, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           result["setup_phases_s"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
