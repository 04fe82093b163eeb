"""Zamba2-7B: Mamba2 backbone + shared attention block [arXiv:2411.15242; unverified].

81 mamba2 layers; one shared-weight attention+MLP block applied after every
6th mamba layer (13 applications + 3 tail mamba layers).  long_500k uses a
sliding-window ring cache for the shared attention (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32_000,
    head_dim=112,
    ssm_state=64,
    ssm_version=2,
    ssm_heads=112,       # d_inner 7168 / 64
    hybrid_attn_every=6,
    long_context_window=4096,
)
