"""End-to-end training launcher (port of ``repro.launch.train``).

Trains a decoder LM on a synthetic-but-deterministic token stream with the
paper's runtime features live:

  * WCRDT training-metric windows across ``--metric-workers`` virtual metric
    partitions (step-windowed lattices; a window prints exactly when the
    global watermark passes it — deterministic regardless of fold order),
  * decentralized "sometimes" checkpoints (LocalStore, largest-step merge),
  * optional mid-run crash/restore (--crash-at) demonstrating bit-exact
    continuation (exactly-once steps, deterministic replay).

Parameters and tokens are the JAX package's for the same seed.  It runs on
the card unless ``--device cpu`` asks for the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --preset tiny
  PYTHONPATH=src python -m repro_torch.launch.train --steps 300 --preset 100m
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import adamw_init
from repro_torch.training.checkpoint import LocalStore, TrainCheckpoint
from repro_torch.training.metrics import (
    MetricSpec,
    metrics_fold,
    metrics_init,
    metrics_read,
)
from repro_torch.training.train_step import make_train_step

PRESETS = {
    "tiny": ArchConfig(
        name="tiny-lm", family="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=1024, vocab=4096,
    ),
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=32_000,
    ),
}
# the port's own default (the JAX launcher's is /tmp/repro_ckpt)
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def synthetic_batch(seed: int, idx: int, B: int, S: int, vocab: int, device="cuda"):
    """Deterministic, indexable token stream (the replayable input log):
    the JAX package's ``randint`` tokens, int64 on ``device``."""
    key = prng.fold_in(prng.prng_key(seed, device), idx)
    return {"tokens": prng.randint(key, B * S, 0, vocab).reshape(B, S)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--metric-workers", type=int, default=4)
    ap.add_argument("--metric-window", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a crash+restore after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    dev = make_data_mesh(1, args.device).device
    cfg = PRESETS[args.preset]
    mspec = MetricSpec(num_workers=args.metric_workers, window_len=args.metric_window)
    store = LocalStore(args.ckpt_dir)
    step_fn = make_train_step(cfg, lr=args.lr, q_chunk=128, ssm_chunk=64)

    def fresh_state():
        params = init_params(cfg, prng.prng_key(args.seed, dev), dtype=torch.float32)
        return params, adamw_init(params), metrics_init(mspec, device=dev), 0

    def restore(ck):
        return (*train_state_from_numpy(ck, mspec, dev), ck.step)

    # resume from the freshest checkpoint if one exists
    ck = store.get("worker0")
    if ck is not None:
        print(f"[resume] restoring step {ck.step} from {args.ckpt_dir}")
        params, opt, metrics, start = restore(ck)
    else:
        params, opt, metrics, start = fresh_state()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model={cfg.name} params={n_params/1e6:.1f}M workers={args.metric_workers}")

    emitted = start // args.metric_window
    t0 = time.time()
    step = start
    while step < args.steps:
        batch = synthetic_batch(args.seed, step, args.batch, args.seq, cfg.vocab, dev)
        params, opt, stats = step_fn(params, opt, batch)
        # fold local stats into this step's metric partition (round-robin
        # stand-in for real DP workers; fold order cannot change any window)
        worker = step % args.metric_workers
        metrics = metrics_fold(
            mspec, metrics, worker, step // args.metric_workers,
            stats["loss"], stats["tokens"], stats["grad_norm"],
        )
        step += 1

        # print every metric window the global watermark has passed
        while True:
            vals, ok = metrics_read(mspec, metrics, emitted)
            if not bool(ok[0]):
                break
            dt = time.time() - t0
            print(
                f"[window {emitted:4d}] steps<{(emitted+1)*args.metric_window*args.metric_workers} "
                f"mean_loss={float(vals['mean_loss'][0]):.4f} "
                f"tokens={float(vals['tokens'][0]):.0f} "
                f"gnorm_max={float(vals['grad_norm_max'][0]):.3f} "
                f"({dt:.1f}s)"
            )
            emitted += 1

        if step % args.ckpt_every == 0:
            store.put(
                "worker0",
                TrainCheckpoint(
                    step=step, data_idx=step, params=params, opt=opt,
                    metrics=metrics, rng_seed=args.seed,
                ),
            )
        if step == args.crash_at:
            print(f"[crash] simulated failure at step {step}; recovering...")
            ck = store.get("worker0")
            if ck is None:
                params, opt, metrics, step = fresh_state()
            else:
                params, opt, metrics, step = restore(ck)
            args.crash_at = -1  # crash once

    final = stats
    print(
        f"done: {args.steps} steps in {time.time()-t0:.1f}s "
        f"final_loss={float(final['loss']):.4f}"
    )
    return float(final["loss"])


if __name__ == "__main__":
    main()
