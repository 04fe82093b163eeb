"""Pixtral-12B backbone: mistral-nemo decoder; pixtral-ViT frontend is a stub
supplying 1024 patch embeddings [hf:mistralai/Pixtral-12B-2409; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131_072,
    head_dim=128,
    frontend="vision",
    frontend_prefix=1024,
)
