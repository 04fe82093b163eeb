#!/usr/bin/env python3
"""Host µs of a dense sync round's merge side and of its parts, on the card.

  python3 scripts/merge_host_us.py

On q4's first spec at the full-size deployment's widths (16 replicas, 64
slots, 16 actors x 5 categories), each timed by ``chip_smoke.host_us``
(mean host time of one call while a device spin keeps the card busy, so a
call only enqueues its work): the pieces a fused-merge call is made of
(an allocation, an argument check, packing the descriptor, the stream
lookup), the fused call at each layer (``kernels/crdt_merge.py``,
``kernels/ops.py``, ``wcrdt.join_delta_stack``), the parent's two-step
merge side on the standalone kernels, ``delta_since`` (the round's other
host cost) and the keyed exchange.  Prints one JSON line.  Needs an
NVIDIA card.
"""
from __future__ import annotations

import array
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("merge_host_us: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.core import wcrdt as W
    from repro_torch.kernels import build, crdt_merge, ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS

    build.build(["gated_delta_merge", "crdt_merge"])
    dev = torch.device("cuda")
    spec = MAKERS["q4"](cs.S, window_len=cs.WINDOW_MS, num_slots=cs.NUM_SLOTS).shared_specs[0]
    st = spec.zero(cs.S, dev)
    base = W.zero_baseline(spec, cs.S, dev)
    stk = W.delta_since(spec, st, *base)
    leaf = st.windows.slots
    meta, kmeta = [st.progress, st.folded, st.errors], [stk.progress, stk.folded, stk.errors]
    desc = list(range(1 << 40, (1 << 40) + 30))
    on = torch.tensor(True, device=dev)
    mesh = make_data_mesh(cs.S, dev)
    calls = {
        "torch.empty i32[16, 64]": lambda: torch.empty((16, 64), dtype=torch.int32, device=dev),
        "torch.empty_like leaf": lambda: torch.empty_like(leaf),
        "check_cuda": lambda: build.check_cuda("x", leaf, leaf.dtype, leaf.shape, leaf.device),
        "pack 30 int64s": lambda: (ctypes.c_longlong * 30).from_buffer(array.array("q", desc)),
        "stream lookup": lambda: torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()),
        "kernels/crdt_merge.delta_merge_join": lambda: crdt_merge.delta_merge_join(
            st.slot_wid, stk.slot_wid, [leaf], [stk.windows.slots], ["max"], meta, kmeta),
        "ops.delta_merge_join": lambda: ops.delta_merge_join(
            st.slot_wid, stk.slot_wid, [leaf], [stk.windows.slots], ["max"], meta, kmeta),
        "wcrdt.join_delta_stack": lambda: W.join_delta_stack(spec, st, stk),
        "parent: _merge_wstate(merge_delta_stack)": lambda: W._merge_wstate(
            st, W.merge_delta_stack(spec, stk)),
        "wcrdt.delta_since": lambda: W.delta_since(spec, st, *base),
        "keyed exchange mesh.pmax(where=)": lambda: mesh.pmax(st.progress, where=on),
    }
    # the parent's sequence and delta_since run 14-20 launches a call: 20
    # calls keep the launch queue short
    few = ("parent", "wcrdt.delta_since")
    row = {name: cs.host_us(fn, 20 if name.startswith(few) else 100)
           for name, fn in calls.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"host_us": row, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
