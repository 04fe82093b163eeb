"""Dense FFN (SwiGLU), the train path of ``repro.models.mlp``.

The JAX package's ``S == 1`` branch differs only in its sharding
constraints, which are the identity on one card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.streaming import prng


def init_mlp(key, d_model: int, d_ff: int, dtype) -> dict:
    ks = prng.split(key, 3)
    return {
        "w_gate": dense_init(ks[0], (d_model, d_ff), dtype),
        "w_up": dense_init(ks[1], (d_model, d_ff), dtype),
        "w_down": dense_init(ks[2], (d_ff, d_model), dtype, fan_in=d_ff),
    }


def mlp_ffn(params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
