"""Falcon-Mamba-7B: pure Mamba1, attention-free [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,              # no FFN; mamba block carries the capacity
    vocab=65_024,
    head_dim=64,
    ssm_state=16,
    ssm_version=1,
)
