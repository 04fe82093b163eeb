#!/usr/bin/env python3
"""The dry run's per-device figures on small cells, to compare torch
versions: where DTensor places each op between the model's sharding
constraints decides them, so two versions agree only where the
constraints pin every placement that matters.

  PYTHONPATH=src python3 scripts/dryrun_placement.py [OUT.json]

For one architecture of each family at ``reduced()``, a train, prefill and
decode cell of batch 8 and length 64 on a 4x2 mesh (megatron; the cells of
``tests/test_torch_dryrun.py``), prints one line a cell and writes a JSON
object with the torch version and, for each cell, the per-device flops,
peak bytes and collective bytes by kind, the global flops and the per-
device bytes (by default to ``build/dryrun_placement_<torch>.json``).
Device-free: runs on any host's CPU, about 40 s.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh

FAMILIES = {"dense": "deepseek_7b", "moe": "qwen3_moe_235b_a22b", "ssm": "falcon_mamba_7b",
            "hybrid": "zamba2_7b", "audio": "seamless_m4t_large_v2", "vlm": "pixtral_12b"}


def main() -> int:
    version = torch.__version__.split("+")[0]
    out = {"torch": torch.__version__, "cells": {}}
    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"))
        for fam, arch in FAMILIES.items():
            cfg = get_config(arch).reduced()
            for kind in ("train", "prefill", "decode"):
                rec = dryrun.record(cfg, ShapeCell(kind, 64, 8, kind), mesh, arch=arch,
                                    q_chunk=32, ssm_chunk=16)
                row = {k: rec[k] for k in ("hlo_flops_per_device", "peak_bytes_per_device",
                                           "collective_bytes_per_device", "global_flops",
                                           "hlo_bytes_per_device")}
                out["cells"][f"{fam}|{kind}"] = row
                print(f"{fam:6s} {kind:7s} flops/dev {row['hlo_flops_per_device']:.0f} peak "
                      f"{row['peak_bytes_per_device']} coll "
                      f"{row['collective_bytes_per_device'].get('total', 0.0):.0f}", flush=True)
    path = Path(sys.argv[1] if len(sys.argv) > 1 else
                f"build/dryrun_placement_{version}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
