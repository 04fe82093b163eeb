#!/usr/bin/env python3
"""How far serving's decode of a prompt's last token lies from the
prefill's logits, by depth and dtype, at published widths on the card.

  python3 scripts/serve_gaps.py

For falcon-mamba-7b (the first 4, 16 and all 64 layers, bf16; all 64 in
f32), zamba2-7b (one macro of 6 layers and all 81, bf16 and f32),
minitron-4b (32 layers, bf16 and f32) and seamless-m4t-large-v2 (24 + 24,
bf16 and f32), with the parameters for seed 0 and a prompt of 2,048
tokens (1,024 tokens beside 4,096 frames for seamless), prints one JSON
line of relative L2 distances to the prefill's logits of sequence 0 over
the whole prompt: ``batched_vs_single`` (the prefill of a batch of four,
or two, of which it is the first), ``chunks_vs_single`` (one query chunk
and SSM chunks of 64: the same function summed in another order) and
``decode_vs_single`` (its last token decoded against a cache prefilled
without it).  At random init these models amplify rounding with depth;
the distances say how much.  Needs an NVIDIA card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def cut(cfg, params, n: int):
    """The first ``n`` layers of a decoder-only stack (whole macros for
    the hybrid, its tail dropped when ``n`` is a multiple of its macro)."""
    from repro_torch.models.common import tree_map

    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    p = dict(params, layers=tree_map(lambda x: x[:n // every], params["layers"]))
    if cfg.family == "hybrid" and n % every == 0:
        p.pop("tail", None)
    return dataclasses.replace(cfg, n_layers=n), p


def gaps(arch: str, dtype, depths, dev, B: int = 4, S: int = 2048) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.streaming import prng

    cfg0 = get_config(arch)
    t0 = time.perf_counter()
    p0 = lm.init_params(cfg0, prng.prng_key(0, dev), dtype=dtype)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg0.vocab, (B, S))).to(dev)
    enc = None
    if cfg0.is_enc_dec:
        S = prompt.shape[1] // 2
        prompt = prompt[:2, :S]
        enc = torch.randn((2, 4 * S, cfg0.d_model),
                          generator=torch.Generator().manual_seed(0)).to(dev, dtype)
    for n in depths:
        cfg, p = cut(cfg0, p0, n) if not cfg0.is_enc_dec else (cfg0, p0)
        frames = 0 if enc is None else enc.shape[1]

        def prefill(toks, rows, **kw):
            if enc is not None:
                logits, cache, enc_kv = lm.prefill_encdec(cfg, p, enc[:rows], toks, **kw)
                return logits, cache, enc_kv
            kw.setdefault("ssm_chunk", 256)
            return (*lm.prefill(cfg, p, toks, **kw), None)

        batched = prefill(prompt, len(prompt))[0]
        single = prefill(prompt[:1], 1)[0]
        kw = {} if enc is not None else {"ssm_chunk": 64}
        chunks = prefill(prompt[:1], 1, q_chunk=max(S, frames), **kw)[0]
        kw = {} if enc is not None else {"ssm_chunk": 89}  # divides 2,047
        _, cache, enc_kv = prefill(prompt[:1, :S - 1], 1, q_chunk=max(S - 1, frames), **kw)
        decode, _ = lm.decode_step(cfg, p, lm.pad_cache(cache, S), prompt[:1, S - 1:], S - 1,
                                   enc_kv=enc_kv)
        print(json.dumps({"arch": arch, "dtype": str(dtype).replace("torch.", ""), "layers": n,
                          "batched_vs_single": rel(batched[:1], single),
                          "chunks_vs_single": rel(chunks, single),
                          "decode_vs_single": rel(decode, single),
                          "logit_rms": float(single.float().pow(2).mean().sqrt()),
                          "s": time.perf_counter() - t0}), flush=True)
        del batched, single, chunks, cache, enc_kv, decode
    del p0
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_gaps: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, torch.__version__, flush=True)
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    gaps("falcon_mamba_7b", bf16, [4, 16, 64], dev)
    gaps("falcon_mamba_7b", f32, [64], dev, B=1)
    gaps("zamba2_7b", bf16, [6, 81], dev, B=1)
    gaps("zamba2_7b", f32, [81], dev, B=1)
    gaps("minitron_4b", bf16, [32], dev)
    gaps("minitron_4b", f32, [32], dev, B=1)
    gaps("seamless_m4t_large_v2", bf16, [24], dev)
    gaps("seamless_m4t_large_v2", f32, [24], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
