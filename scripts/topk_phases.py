#!/usr/bin/env python3
"""Time ``topk_window`` on q7's recorded call, whole and by phase.

  python3 scripts/topk_phases.py [VARIANT.cu[:TILE] ...]

Records the dataplane's q7 call at chip_smoke.py's full-size deployment
(``chip_smoke.main_path_calls``), then for the repository's kernel and for
each variant source given (a build of the same C interface,
``topk_window_launch``, with ``TILE`` lanes a tile, 1,024 by default):
checks it against the plain version on the call and, where it agrees, on
``check_topk_window``'s tie, 64-slot and cross-tile shapes; times it with
``chip_smoke.kernel_ms`` (three batches of 20 launches); and splits the
device time between its kernels with ``torch.profiler`` over 20 launches.
The repository's kernel must agree; a variant cut short to time a part of
the work may not, and is reported so.  Variants run in turns, first to
last and back.  Prints one JSON line each.  Needs an NVIDIA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def phases(call) -> dict:
    """Device µs per launch of each kernel the call runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_phases: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import topk_window as tw

    dev = torch.device("cuda")
    build.build(ops.SOURCES)
    calls = cs.main_path_calls(dev)
    (args, _), = calls["q7"]["topk_window"]
    want = ref.topk_window_ref(*args)
    tw.topk_window(*args)
    fns = {"repo": (tw.KERNEL._fn, tw.TILE)}
    for spec in sys.argv[1:]:
        src, _, tile = spec.partition(":")
        lib = build.BUILD_DIR / (Path(src).stem + ".variant.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), src], check=True)
        fn = ctypes.CDLL(str(lib)).topk_window_launch
        fn.argtypes = tw.KERNEL._fn.argtypes
        fn.restype = ctypes.c_int
        fns[src] = (fn, int(tile or 1024))
    order = list(fns) + list(fns)[::-1]
    for name in order:
        tw.KERNEL._fn, tw.TILE = fns[name]
        got = tw.topk_window(*args)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if name == "repo" and not same:
            raise AssertionError("topk_window differs from the plain version")
        if same:  # and on the ties, 64 slots a tile and slots across tile edges
            row = cs.check_topk_window(dev, calls["q7"])
        else:
            row = cs.kernel_ms(lambda: tw.topk_window(*args))
        print(json.dumps({"variant": name, "bitwise": same, "ms": row["ms"],
                          "ms_batches": row["ms_batches"], "host_us": row.get("host_us"),
                          "phases_us": phases(lambda: tw.topk_window(*args))}), flush=True)
    tw.KERNEL._fn, tw.TILE = fns["repo"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
