"""Architecture registry.

Counterpart of ``repro.configs.registry``'s ``ARCHS``, ``get_config`` and
``get_reduced`` for the 10 assigned architectures.  Its input shapes
(``SHAPES``, ``Shape``, ``shape_applicable``, ``cells``) and
``input_specs`` serve the dry-run and wait for the launch tooling
(ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, reduced

__all__ = ["ARCHS", "get_config", "get_reduced"]

_MODULES = {
    "internvl2-76b": "internvl2_76b",
    "llama3-405b": "llama3_405b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-9b": "yi_9b",
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "musicgen-medium": "musicgen_medium",
}
ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
