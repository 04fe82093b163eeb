"""Llama-4-Scout 17B-A16E: interleaved MoE, 16 experts top-1, shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,          # dense + shared-expert FFN width
    vocab=202_048,
    head_dim=128,
    moe_experts=16,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_every=2,        # llama4 interleaves dense / MoE layers
    moe_shared_expert=True,
)
