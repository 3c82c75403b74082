"""Model configuration schema for all assigned architectures.

A copy of ``repro.configs.base`` (which imports no JAX): the port keeps its
own so that it imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "reduced"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared (always-on) experts
    d_ff_shared: int = 0          # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"          # "mamba2" | "rwkv6"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64            # rwkv6 time-mix head dim
    attn_every: int = 0           # hybrid: shared attn block after every N
                                  # ssm layers (0 = never)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rope_theta: float = 5e5
    norm_eps: float = 1e-5
    attn_bias: bool = False       # qwen1.5-style qkv bias
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # "vit_stub" | "encodec_stub" (embeds in)
    sub_quadratic: bool = False   # long_500k applicability
    remat: bool = True            # activation checkpointing per layer

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def takes_embeds(self) -> bool:
        return self.frontend is not None


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family shape."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.ssm and cfg.ssm.attn_every else 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.moe:
        small["moe"] = replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=min(cfg.moe.d_ff_shared, 128) if cfg.moe.d_ff_shared else 0,
            # lossless capacity (cap >= n*top_k): smoke tests need routing to
            # be drop-free so prefill/decode exactly match the full forward
            capacity_factor=float(min(cfg.moe.num_experts, 8)),
        )
    if cfg.ssm:
        small["ssm"] = replace(
            cfg.ssm,
            d_state=16,
            head_dim=16,
            attn_every=2 if cfg.ssm.attn_every else 0,
        )
        if cfg.ssm.attn_every:
            small["num_layers"] = 4
    small.update(overrides)
    return replace(cfg, **small)
