"""Qwen3-MoE 235B-A22B: 128 experts top-8, every layer MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,          # per-expert hidden width (assignment lists d_ff=1536)
    vocab=151_936,
    head_dim=128,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    moe_every=1,
)
