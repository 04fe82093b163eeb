"""Assigned-architecture registry: ``get_config(name)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCell, runnable_cells

ARCHS = [
    "minitron_4b",
    "deepseek_7b",
    "deepseek_coder_33b",
    "mistral_large_123b",
    "llama4_scout_17b_a16e",
    "qwen3_moe_235b_a22b",
    "zamba2_7b",
    "falcon_mamba_7b",
    "seamless_m4t_large_v2",
    "pixtral_12b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "SHAPES", "ShapeCell", "runnable_cells", "get_config", "list_archs", "ARCHS"]
