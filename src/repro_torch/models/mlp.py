"""Dense FFN (SwiGLU), port of ``repro.models.mlp``.

Its ``S == 1`` (decode) branch differs only in its sharding constraints,
which are the identity outside a dry-run mesh."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import BATCH, dense_init, shard
from repro_torch.streaming import prng


def init_mlp(key, d_model: int, d_ff: int, dtype) -> dict:
    ks = prng.split(key, 3)
    return {
        "w_gate": dense_init(ks[0], (d_model, d_ff), dtype),
        "w_up": dense_init(ks[1], (d_model, d_ff), dtype),
        "w_down": dense_init(ks[2], (d_ff, d_model), dtype, fan_in=d_ff),
    }


def mlp_ffn(params, x: torch.Tensor) -> torch.Tensor:
    # TP: d_ff over model, and batch over (pod, data).  Decode (S == 1):
    # the 2D weight-stationary plan keeps the residual stream D-sharded over
    # `data`, so both matmuls contract sharded dims in place (the gate's and
    # the up projection's partial sums reduced before the SiLU)
    decode = x.ndim == 3 and x.shape[1] == 1
    if decode:
        x = shard(x, None, None, ("data",))
    spec = (*((None,) * (x.ndim - 1) if decode or x.ndim != 3 else (BATCH, None)), "model")
    h = F.silu(shard(x @ params["w_gate"], *spec)) * shard(x @ params["w_up"], *spec)
    y = h @ params["w_down"]
    return shard(y, None, None, ("data",)) if decode else y
