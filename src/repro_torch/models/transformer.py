"""The decoder LM of the ``attn`` family (dense, vlm, audio).

Counterpart of ``repro.models.transformer`` for the families without MoE:

  ``forward(model, cfg, inputs, ...)``          (logits, cache | None, None)
  ``init_model(gen, cfg, device=...)``          a ``Transformer`` module
  ``init_decode_cache(cfg, batch, max_seq)``    {"layers": [per-layer cache]}

Both build on ``device``: the card by default (raising without one), the
CPU when the caller asks for it.

Each block is RMSNorm -> GQA (``models.attention``) -> RMSNorm -> SwiGLU
(GELU-MLP for ``audio``); ``vlm``/``audio`` take (B, S, D) embeddings,
cast to bfloat16 as the reference does.  The layers run as a loop over an
``nn.ModuleList``: the reference's ``lax.scan`` over stacked layers and its
remat have no counterpart here (inference only).  The cache of each layer
is updated in place.  The ``moe``, ``ssm`` (RWKV) and ``hybrid`` (Mamba)
families and ``train_loss`` raise ``NotImplementedError``: they wait for
ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    Dense, GeluMLP, RMSNorm, SwiGLU, dense, frozen, gelu_mlp, init_dense, init_device,
    init_norm, linear, rms_norm, swiglu,
)
from repro_torch.ops.sort import Device, _device

__all__ = ["Block", "Transformer", "init_model", "forward", "train_loss", "init_decode_cache"]

Cache = Dict[str, List[attn_mod.AttnCache]]


class Block(nn.Module):
    def __init__(self, ln1: RMSNorm, attn: attn_mod.Attention, ln2: RMSNorm, mlp: nn.Module):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class Transformer(nn.Module):
    """The parameters: ``embed`` (V, D) unless the config takes embeddings,
    ``layers``, ``final_norm`` and ``lm_head`` unless the embeddings are
    tied."""

    def __init__(self, layers: List[Block], final_norm: RMSNorm,
                 embed: Optional[torch.Tensor] = None, lm_head: Optional[Dense] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.embed = None if embed is None else frozen(embed)
        self.lm_head = lm_head

    @property
    def dtype(self) -> torch.dtype:
        """The weights' dtype, which the activations and the cache take."""
        return self.layers[0].attn.wq.w.dtype


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "audio") or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md queue 1 "
            "item 13); the port serves the dense, vlm and audio families"
        )


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_mlp(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    kw = dict(dtype=dtype, device=device)
    if cfg.family == "audio":  # GELU MLP
        return GeluMLP(init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                       init_dense(gen, cfg.d_ff, cfg.d_model, **kw))
    return SwiGLU(init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                  init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                  init_dense(gen, cfg.d_ff, cfg.d_model, **kw))


def init_model(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device: Device = None) -> Transformer:
    """Random parameters with the reference's distributions (normal weights
    over sqrt(d_in), a 0.02 normal embedding, unit norms, zero biases) on
    ``device`` (the card by default), drawn from ``gen`` on that device."""
    _check_family(cfg)
    device = init_device(gen, device)
    embed = None
    if not cfg.takes_embeds:
        embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             dtype=torch.float32, device=device) * 0.02).to(dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
    layers = []
    for _ in range(cfg.num_layers):
        attn = attn_mod.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
            bias=cfg.attn_bias, dtype=dtype, device=device,
        )
        layers.append(Block(init_norm(cfg.d_model, device), attn, init_norm(cfg.d_model, device),
                            _init_mlp(gen, cfg, dtype, device)))
    return Transformer(layers, init_norm(cfg.d_model, device), embed, lm_head)


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                      device: Device = None) -> Cache:
    """One linear cache of ``max_seq`` slots per layer."""
    _check_family(cfg)
    dev = _device(device)
    return {"layers": [
        attn_mod.init_cache(batch, max_seq, cfg.num_kv_heads, cfg.hd, dtype=dtype, device=dev)
        for _ in range(cfg.num_layers)
    ]}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _attn_block(blk: Block, cfg: ModelConfig, x, positions, cache):
    h, new_cache = attn_mod.attention(
        blk.attn, rms_norm(blk.ln1, x, cfg.norm_eps), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, cache=cache,
    )
    x = x + h
    y = rms_norm(blk.ln2, x, cfg.norm_eps)
    y = gelu_mlp(blk.mlp, y) if cfg.family == "audio" else swiglu(blk.mlp, y)
    return x + y, new_cache


def forward(
    model: Transformer,
    cfg: ModelConfig,
    inputs: torch.Tensor,       # (B,S) int tokens  or (B,S,D) embeds
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache], None]:
    """Returns (logits (B,S,V), the cache | None, None).  A given cache is
    updated in place (prefill for S > 1, decode for S == 1) and returned;
    the third slot is the reference's MoE aux, which this family does not
    have."""
    _check_family(cfg)
    if cfg.takes_embeds:
        x = inputs.to(torch.bfloat16)
        b, s = x.shape[:2]
    else:
        b, s = inputs.shape
        x = model.embed[inputs.to(torch.int64)]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    caches = cache["layers"] if cache is not None else [None] * len(model.layers)
    for blk, c in zip(model.layers, caches):
        x, _ = _attn_block(blk, cfg, x, positions, c)
    x = rms_norm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = linear(x, model.embed.T)
    else:
        logits = dense(model.lm_head, x)
    return logits, cache, None


def train_loss(model: Transformer, cfg: ModelConfig, batch, lb_coef: float = 0.01):
    raise NotImplementedError(
        "training and its backward kernels are not ported yet (ROADMAP.md queue 1 item 13)"
    )
