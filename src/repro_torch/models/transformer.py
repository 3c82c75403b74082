"""The decoder LM of every family: dense, moe, vlm, audio, ssm (RWKV-6) and
hybrid (zamba2).

Counterpart of ``repro.models.transformer``:

  ``forward(model, cfg, inputs, ...)``          (logits, cache | None, moe aux | None)
  ``init_model(gen, cfg, device=...)``          a ``Transformer`` module
  ``init_decode_cache(cfg, batch, max_seq)``    the family's cache (below)

Both build on ``device``: the card by default (raising without one), the
CPU when the caller asks for it.  Three block families, as in the
reference:

  * ``attn`` (dense, moe, vlm, audio): RMSNorm -> GQA (``models.attention``)
    -> RMSNorm -> SwiGLU (GELU-MLP for ``audio``, ``models.moe.moe_ffn``
    for ``moe``, whose aux ``forward`` sums over layers: ``lb_loss`` and
    ``dropped`` add, ``max_load`` takes the max); ``vlm``/``audio`` take
    (B, S, D) embeddings, cast to bfloat16 as the reference does;
  * ``rwkv`` (ssm): RMSNorm -> RWKV-6 time-mix, RMSNorm -> channel-mix
    (``models.rwkv``), with a recurrent state per layer;
  * ``hybrid``: groups of ``attn_every`` Mamba2 layers (``models.ssm``),
    each with its own SwiGLU, and after each group ONE shared attention
    block (a single parameter set) with a KV cache per group, a ring of
    ``HYBRID_ATTN_WINDOW`` slots when ``max_seq`` exceeds it.

The layers run as a loop over an ``nn.ModuleList``: the reference's
``lax.scan`` over stacked layers and its remat have no counterpart here
(inference only).  A cache is a dict of per-layer caches (``"layers"``,
and ``"attn"`` per group for the hybrid), each updated in place.
``train_loss`` raises ``NotImplementedError``: training waits for
ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Dense, GeluMLP, RMSNorm, SwiGLU, dense, frozen, gelu_mlp, init_dense, init_device,
    init_norm, linear, rms_norm, swiglu,
)
from repro_torch.ops.sort import Device, _device

__all__ = ["Block", "RwkvBlock", "MambaBlock", "Transformer", "init_model", "forward",
           "train_loss", "init_decode_cache", "reset_decode_cache", "HYBRID_ATTN_WINDOW"]

Cache = Dict[str, List[Dict[str, Any]]]

# The hybrid's shared attention runs a sliding window when the cache is
# longer than this (what makes zamba2 sub-quadratic end to end).
HYBRID_ATTN_WINDOW = 4096


class Block(nn.Module):
    """An attention block; ``mlp`` is a SwiGLU, a GELU MLP or a ``MoE``."""

    def __init__(self, ln1: RMSNorm, attn: attn_mod.Attention, ln2: RMSNorm, mlp: nn.Module):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class RwkvBlock(nn.Module):
    def __init__(self, ln1: RMSNorm, mix: rwkv_mod.RWKV6, ln2: RMSNorm):
        super().__init__()
        self.ln1, self.mix, self.ln2 = ln1, mix, ln2


class MambaBlock(nn.Module):
    def __init__(self, ln1: RMSNorm, mamba: ssm_mod.Mamba2, ln2: RMSNorm, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.mamba, self.ln2, self.mlp = ln1, mamba, ln2, mlp


class Transformer(nn.Module):
    """The parameters: ``embed`` (V, D) unless the config takes embeddings,
    ``layers``, ``final_norm``, ``lm_head`` unless the embeddings are tied,
    and the hybrid's ``shared_attn`` block."""

    def __init__(self, layers: List[nn.Module], final_norm: RMSNorm,
                 embed: Optional[torch.Tensor] = None, lm_head: Optional[Dense] = None,
                 shared_attn: Optional[Block] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.embed = None if embed is None else frozen(embed)
        self.lm_head = lm_head
        self.shared_attn = shared_attn

    @property
    def dtype(self) -> torch.dtype:
        """The weights' dtype, which the activations and the cache take."""
        return self.lm_head.w.dtype if self.lm_head is not None else self.embed.dtype


def _block_family(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid":
        return "hybrid"
    return "attn"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _swiglu(gen, cfg: ModelConfig, kw) -> SwiGLU:
    return SwiGLU(init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                  init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                  init_dense(gen, cfg.d_ff, cfg.d_model, **kw))


def _init_mlp(gen, cfg: ModelConfig, dtype, device) -> nn.Module:
    kw = dict(dtype=dtype, device=device)
    if cfg.family == "moe":
        m = cfg.moe
        return moe_mod.init_moe(gen, cfg.d_model, num_experts=m.num_experts,
                                d_ff_expert=m.d_ff_expert, top_k=m.top_k,
                                num_shared=m.num_shared, d_ff_shared=m.d_ff_shared, **kw)
    if cfg.family == "audio":  # GELU MLP
        return GeluMLP(init_dense(gen, cfg.d_model, cfg.d_ff, **kw),
                       init_dense(gen, cfg.d_ff, cfg.d_model, **kw))
    return _swiglu(gen, cfg, kw)


def _init_attn_layer(gen, cfg: ModelConfig, dtype, device) -> Block:
    attn = attn_mod.init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                                   bias=cfg.attn_bias, dtype=dtype, device=device)
    return Block(init_norm(cfg.d_model, device), attn, init_norm(cfg.d_model, device),
                 _init_mlp(gen, cfg, dtype, device))


def _init_layer(gen, cfg: ModelConfig, fam: str, dtype, device) -> nn.Module:
    if fam == "attn":
        return _init_attn_layer(gen, cfg, dtype, device)
    s = cfg.ssm
    if fam == "rwkv":
        mix = rwkv_mod.init_rwkv6(gen, cfg.d_model, head_dim=s.head_dim, d_ff=cfg.d_ff,
                                  dtype=dtype, device=device)
        return RwkvBlock(init_norm(cfg.d_model, device), mix, init_norm(cfg.d_model, device))
    mamba = ssm_mod.init_mamba2(gen, cfg.d_model, d_state=s.d_state, d_conv=s.d_conv,
                                expand=s.expand, head_dim=s.head_dim, dtype=dtype, device=device)
    return MambaBlock(init_norm(cfg.d_model, device), mamba, init_norm(cfg.d_model, device),
                      _swiglu(gen, cfg, dict(dtype=dtype, device=device)))


def init_model(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device: Device = None) -> Transformer:
    """Random parameters with the reference's distributions (normal weights
    over sqrt(d_in), a 0.02 normal embedding, unit norms, zero biases, and
    each mixer's own constants) on ``device`` (the card by default), drawn
    from ``gen`` on that device."""
    device = init_device(gen, device)
    fam = _block_family(cfg)
    if fam == "hybrid" and cfg.num_layers % cfg.ssm.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not divide into groups of "
                         f"{cfg.ssm.attn_every}")
    embed = None
    if not cfg.takes_embeds:
        embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             dtype=torch.float32, device=device) * 0.02).to(dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
    layers = [_init_layer(gen, cfg, fam, dtype, device) for _ in range(cfg.num_layers)]
    shared = _init_attn_layer(gen, cfg, dtype, device) if fam == "hybrid" else None
    return Transformer(layers, init_norm(cfg.d_model, device), embed, lm_head, shared)


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                      device: Device = None) -> Cache:
    """The family's cache: one linear KV cache of ``max_seq`` slots per
    layer (attn); one RWKV state per layer (rwkv); one Mamba2 state per
    layer and one KV cache per group of the shared attention (hybrid).  The
    recurrent states keep the reference's dtypes (float32 state, bfloat16
    shifts and conv); the KV caches take ``dtype``."""
    fam = _block_family(cfg)
    dev = _device(device)
    L = cfg.num_layers
    if fam == "attn":
        return {"layers": [
            attn_mod.init_cache(batch, max_seq, cfg.num_kv_heads, cfg.hd, dtype=dtype, device=dev)
            for _ in range(L)]}
    s = cfg.ssm
    if fam == "rwkv":
        return {"layers": [rwkv_mod.init_rwkv_state(batch, cfg.d_model, head_dim=s.head_dim,
                                                    device=dev) for _ in range(L)]}
    window = HYBRID_ATTN_WINDOW if max_seq > HYBRID_ATTN_WINDOW else 0
    return {
        "layers": [ssm_mod.init_ssm_state(batch, cfg.d_model, d_state=s.d_state,
                                          d_conv=s.d_conv, expand=s.expand,
                                          head_dim=s.head_dim, device=dev) for _ in range(L)],
        "attn": [attn_mod.init_cache(batch, max_seq, cfg.num_kv_heads, cfg.hd, window=window,
                                     dtype=dtype, device=dev) for _ in range(L // s.attn_every)],
    }


def reset_decode_cache(cache: Cache) -> Cache:
    """Zero the recurrent states of a cache in place, so that the next
    prefill starts from a fresh state as on a new cache (a prefill rewrites
    every slot of a KV cache itself)."""
    for group in cache.values():
        for c in group:
            for name, t in c.items():
                if name not in ("k", "v", "pos"):
                    t.zero_()
    return cache


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _attn_block(blk: Block, cfg: ModelConfig, x, positions, cache, window: int = 0):
    h, _ = attn_mod.attention(
        blk.attn, rms_norm(blk.ln1, x, cfg.norm_eps), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, window=window, cache=cache,
    )
    x = x + h
    y = rms_norm(blk.ln2, x, cfg.norm_eps)
    aux = None
    if cfg.family == "moe":
        m = cfg.moe
        y, aux = moe_mod.moe_ffn(blk.mlp, y, num_experts=m.num_experts, top_k=m.top_k,
                                 capacity_factor=m.capacity_factor)
    elif cfg.family == "audio":
        y = gelu_mlp(blk.mlp, y)
    else:
        y = swiglu(blk.mlp, y)
    return x + y, aux


def _rwkv_block(blk: RwkvBlock, cfg: ModelConfig, x, state):
    x = x + rwkv_mod.rwkv6_timemix(blk.mix, rms_norm(blk.ln1, x, cfg.norm_eps),
                                   head_dim=cfg.ssm.head_dim, state=state)
    return x + rwkv_mod.rwkv6_channelmix(blk.mix, rms_norm(blk.ln2, x, cfg.norm_eps),
                                         state=state)


def _mamba_block(blk: MambaBlock, cfg: ModelConfig, x, state):
    s = cfg.ssm
    x = x + ssm_mod.mamba2(blk.mamba, rms_norm(blk.ln1, x, cfg.norm_eps), d_state=s.d_state,
                           expand=s.expand, head_dim=s.head_dim, state=state)
    return x + swiglu(blk.mlp, rms_norm(blk.ln2, x, cfg.norm_eps))


def _sum_aux(total, a):
    if total is None:
        return dict(a)
    return {"lb_loss": total["lb_loss"] + a["lb_loss"],
            "dropped": total["dropped"] + a["dropped"],
            "max_load": torch.maximum(total["max_load"], a["max_load"])}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(
    model: Transformer,
    cfg: ModelConfig,
    inputs: torch.Tensor,       # (B,S) int tokens  or (B,S,D) embeds
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache], Optional[Dict[str, torch.Tensor]]]:
    """Returns (logits (B,S,V), the cache | None, the MoE aux summed over
    layers | None).  A given cache is updated in place (prefill for S > 1,
    decode for S == 1) and returned."""
    if cfg.takes_embeds:
        x = inputs.to(torch.bfloat16)
        b, s = x.shape[:2]
    else:
        b, s = inputs.shape
        x = model.embed[inputs.to(torch.int64)]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    fam = _block_family(cfg)
    caches = cache["layers"] if cache is not None else [None] * len(model.layers)
    aux = None
    if fam == "attn":
        for blk, c in zip(model.layers, caches):
            x, a = _attn_block(blk, cfg, x, positions, c)
            if a is not None:
                aux = _sum_aux(aux, a)
    elif fam == "rwkv":
        for blk, st in zip(model.layers, caches):
            x = _rwkv_block(blk, cfg, x, st)
    else:
        g = cfg.ssm.attn_every
        window = 0
        if cache is not None:
            # a ring iff the cache is shorter than what positions reach
            slots = cache["attn"][0]["k"].shape[1]
            window = HYBRID_ATTN_WINDOW if slots == HYBRID_ATTN_WINDOW else 0
        for grp in range(len(model.layers) // g):
            for i in range(grp * g, (grp + 1) * g):
                x = _mamba_block(model.layers[i], cfg, x, caches[i])
            ac = cache["attn"][grp] if cache is not None else None
            x, _ = _attn_block(model.shared_attn, cfg, x, positions, ac, window=window)
    x = rms_norm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = linear(x, model.embed.T)
    else:
        logits = dense(model.lm_head, x)
    return logits, cache, aux


def train_loss(model: Transformer, cfg: ModelConfig, batch, lb_coef: float = 0.01):
    raise NotImplementedError(
        "training is not ported yet (ROADMAP.md queue 1 item 13)"
    )
