"""Architecture registry + assigned input shapes + meta-tensor specs.

Counterpart of ``repro.configs.registry``: the 10 assigned architectures x
4 LM shapes = 40 dry-run cells.  ``decode_*`` and ``long_*`` run the decode
step (one token + cache); ``train_4k`` runs the train step;
``prefill_32k`` runs the prefill step.  ``long_500k`` is only applicable to
sub-quadratic archs (zamba2, rwkv6): the eight full-attention archs skip
it.  ``input_specs`` gives tensors on the ``meta`` device (shapes and
dtypes, nothing allocated) where the reference gives ShapeDtypeStructs.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig, reduced

__all__ = [
    "ARCHS", "SHAPES", "get_config", "get_reduced", "cells",
    "input_specs", "Shape", "shape_applicable",
]

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


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def shape_applicable(cfg: ModelConfig, shape: Shape) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def cells(include_inapplicable: bool = False):
    """All (arch, shape) dry-run cells (40 assigned; 38 applicable)."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if include_inapplicable or shape_applicable(cfg, s):
                out.append((a, s.name))
    return out


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell (the
    reference's shapes and dtypes; no allocation).  A decode cell's cache
    is the port's own ``init_decode_cache`` on the meta device: per-layer
    tensors where the reference stacks them."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.takes_embeds:
            inputs = sds((b, s, cfg.d_model), torch.bfloat16)
        else:
            inputs = sds((b, s), torch.int32)
        return {"inputs": inputs, "labels": sds((b, s), torch.int32)}
    if shape.kind == "prefill":
        if cfg.takes_embeds:
            return {"inputs": sds((b, s, cfg.d_model), torch.bfloat16)}
        return {"inputs": sds((b, s), torch.int32)}
    # decode: one new token against a cache of seq_len
    if cfg.takes_embeds:
        tok = sds((b, 1, cfg.d_model), torch.bfloat16)
    else:
        tok = sds((b, 1), torch.int32)
    from repro_torch.models.transformer import init_decode_cache  # lazy: avoids a cycle

    return {"inputs": tok, "cache": init_decode_cache(cfg, b, s, device="meta")}
