"""Architecture configuration schema + the input-shape cells (a copy of
``repro.configs.base``: the port imports nothing of the JAX package).

One ``ArchConfig`` per assigned architecture lives in
``src/repro_torch/configs/<id>.py``; reduced variants for CPU smoke tests come from
``ArchConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    moe_every: int = 1  # every k-th layer is MoE (llama4: interleaved)
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1  # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_heads: int = 0  # mamba2 value heads (0 -> d_inner // 64)

    # --- hybrid (zamba2): one shared-weight attention block applied every
    # ``hybrid_attn_every`` mamba layers ---
    hybrid_attn_every: int = 0

    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- attention ---
    sliding_window: int = 0  # 0 = full causal
    long_context_window: int = 4096  # window used by hybrid attn at 500k
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- modality frontend stubs ---
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_prefix: int = 0  # embedding lanes supplied by the stub

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic families (DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            moe_experts=min(self.moe_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=128 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_heads=4 if self.family in ("hybrid",) else 0,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            hybrid_attn_every=3 if self.hybrid_attn_every else 0,
            frontend_prefix=min(self.frontend_prefix, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=256,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape × step-kind) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def runnable_cells(cfg: ArchConfig) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return cells
