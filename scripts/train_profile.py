#!/usr/bin/env python3
"""Where a train step's time goes on the card: by default the 100m preset
at ``examples/train_lm.py --full``'s shape (batch 8 x seq 512), or with
``--arch`` an architecture at its published widths, in one process.

  python3 scripts/train_profile.py [--steps 10] [--warmup 3]
  python3 scripts/train_profile.py --arch falcon_mamba_7b --layers 4 \
      --batch 1 --seq 4096

Draws the parameters (the JAX package's for seed 0), takes ``--warmup``
steps, then times ``--steps`` steps one by one (each ending in a device
synchronise), then profiles one more with ``torch.profiler``.  With
``--arch``, ``--layers`` cuts the depth; an encoder-decoder architecture
is refused.  Prints the card's name and power limit, one JSON line (the step
times, their median, tokens/s, the profiled step's wall and device-busy
ms, its device events and top-level torch ops) and the profiler's table of
the largest device costs.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--arch", default=None, help="a configs/ architecture at published widths")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS, synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.streaming import prng
    from repro_torch.training import adamw_init, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    B, S = args.batch, args.seq
    if args.arch is None:
        cfg = PRESETS["100m"]
        step = make_train_step(cfg, q_chunk=128, ssm_chunk=64)  # the launcher's settings
    else:
        cfg = get_config(args.arch)
        if cfg.is_enc_dec:
            print(f"train_profile: {args.arch} is an encoder-decoder model", file=sys.stderr)
            return 1
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        step = make_train_step(cfg, q_chunk=512, ssm_chunk=256)  # the defaults
    params = init_params(cfg, prng.prng_key(0, dev), dtype=torch.float32)
    opt = adamw_init(params)
    secs = []
    for s in range(args.warmup + args.steps):
        batch = synthetic_batch(0, s, B, S, cfg.vocab, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, stats = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    batch = synthetic_batch(0, len(secs), B, S, cfg.vocab, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, stats = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in device) / 1e3
    ops = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None]
    med = float(np.median(secs[args.warmup:]))
    print(json.dumps({"preset": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
                      "step_s": secs[args.warmup:],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "median_step_s": med, "tokens_per_s": B * S / med,
                      "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / (wall * 1e3), "device_events": len(device),
                      "top_level_torch_ops": len(ops), "loss": float(stats["loss"]),
                      "card": smi}), flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
