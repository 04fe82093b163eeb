"""SeamlessM4T-large-v2 backbone: enc-dec transformer [arXiv:2308.11596; hf].

Assignment lists 24L; realized as 24 encoder + 24 decoder layers (the
speech-encoder/text-decoder split of the published model).  The audio
frontend is a stub: input_specs() supplies precomputed frame embeddings.
Decoder length for each shape cell is seq_len // 4 (documented in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    enc_layers=24,
    dec_layers=24,
    frontend="audio",
)
