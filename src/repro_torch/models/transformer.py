"""The decoder LM of every family: dense, moe, vlm, audio, ssm (RWKV-6) and
hybrid (zamba2).

Counterpart of ``repro.models.transformer``:

  ``forward(model, cfg, inputs, ...)``          (logits, cache | None, moe aux | None)
  ``init_model(gen, cfg, device=...)``          a ``Transformer`` module
  ``init_decode_cache(cfg, batch, max_seq)``    the family's cache (below)

  ``train_loss(model, cfg, batch, lb_coef)``    (loss, metrics), differentiable
  ``param_leaves(model)``                       the reference's parameter tree

Both builders work on ``device``: the card by default (raising without one), the
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

The layers run as a loop over an ``nn.ModuleList`` where the reference
scans its stacked layers.  Its per-layer remat (``jax.checkpoint`` of the
scan body when ``cfg.remat``) is ``torch.utils.checkpoint`` around each
block while gradients are recorded: each attention or RWKV block, and each
Mamba2 block of the hybrid (its shared attention is not rematerialised, as
in the reference).  A cache is a dict of per-layer caches (``"layers"``,
and ``"attn"`` per group for the hybrid), each updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    DP, Dense, GeluMLP, RMSNorm, SwiGLU, cross_entropy, dense, frozen, gelu_mlp, init_dense,
    init_device, init_norm, linear, model_device, rms_norm, shard_hint, swiglu,
)
from repro_torch.ops.sort import Device

__all__ = ["Block", "RwkvBlock", "MambaBlock", "Transformer", "init_model", "forward",
           "train_loss", "param_leaves", "init_decode_cache", "reset_decode_cache",
           "HYBRID_ATTN_WINDOW"]

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
    dev = model_device(device)
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

def _stream(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout under a mesh: batch over the dp axes,
    whole over ``model`` (the Megatron contract: each block's row-parallel
    partial sums are reduced here, and every model column holds its dp
    shard's tokens).  The identity without a mesh."""
    return shard_hint(x, DP, None, None)


def _attn_block(blk: Block, cfg: ModelConfig, x, positions, cache, window: int = 0):
    h, _ = attn_mod.attention(
        blk.attn, rms_norm(blk.ln1, x, cfg.norm_eps), positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, window=window, cache=cache,
    )
    x = _stream(x + h)
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
    return _stream(x + y), aux


def _rwkv_block(blk: RwkvBlock, cfg: ModelConfig, x, state):
    x = _stream(x + rwkv_mod.rwkv6_timemix(blk.mix, rms_norm(blk.ln1, x, cfg.norm_eps),
                                           head_dim=cfg.ssm.head_dim, state=state))
    return _stream(x + rwkv_mod.rwkv6_channelmix(blk.mix, rms_norm(blk.ln2, x, cfg.norm_eps),
                                                 state=state))


def _mamba_block(blk: MambaBlock, cfg: ModelConfig, x, state):
    s = cfg.ssm
    x = _stream(x + ssm_mod.mamba2(blk.mamba, rms_norm(blk.ln1, x, cfg.norm_eps),
                                   d_state=s.d_state, expand=s.expand, head_dim=s.head_dim,
                                   state=state))
    return _stream(x + swiglu(blk.mlp, rms_norm(blk.ln2, x, cfg.norm_eps)))


def _embedding(inputs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding`` of int ids, on a DTensor table too: its model
    dimension is gathered (the FSDP all-gather over the dp axes), and rows
    sharded over ``model`` are looked up where they lie: each rank takes
    the ids in its vocab range and the sum over the ranks (a partial sum,
    reduced by the caller's ``shard_hint``) holds every row.  Rows "sharded"
    over a mesh dimension of size 1 are whole: the plain lookup."""
    ids = inputs.to(torch.int64)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements) if p == Shard(0) and mesh.size(i) > 1]
    want = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    table = table.redistribute(mesh, want)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim)
    if not rows:
        return F.embedding(ids, table)
    if len(rows) > 1:
        raise NotImplementedError("embedding rows sharded over several mesh axes")
    (vdim,) = rows
    v0 = mesh.get_local_rank(vdim) * -(-table.shape[0] // mesh.size(vdim))
    id_pl = tuple(Replicate() if i == vdim else p for i, p in enumerate(ids.placements))
    ids = ids.redistribute(mesh, id_pl)

    def lookup(tab, idx):
        idx = idx - v0
        hit = (idx >= 0) & (idx < tab.shape[0])
        x = F.embedding(idx.clamp(0, max(tab.shape[0] - 1, 0)), tab)
        return x * hit[..., None].to(x.dtype)

    out_pl = tuple(Partial() if i == vdim else p for i, p in enumerate(id_pl))
    from torch.distributed.tensor.experimental import local_map

    # each rank's table gradient holds its own tokens' rows: a partial sum
    # over the mesh dimensions that shard the tokens
    tab_grad = tuple(Shard(0) if i == vdim else Partial() if p.is_shard() else Replicate()
                     for i, p in enumerate(id_pl))
    return local_map(lookup, out_placements=(out_pl,), in_placements=(tuple(want), id_pl),
                     in_grad_placements=(tab_grad, id_pl),
                     redistribute_inputs=False, device_mesh=mesh)(table, ids)


def _sum_aux(total, a):
    if total is None:
        return dict(a)
    return {"lb_loss": total["lb_loss"] + a["lb_loss"],
            "dropped": total["dropped"] + a["dropped"],
            "max_load": torch.maximum(total["max_load"], a["max_load"])}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _maybe_remat(f, cfg: ModelConfig, cache):
    """``f`` rematerialised for the backward (its activations dropped after
    the forward and recomputed) when the config asks for it and a graph is
    being recorded: the reference's ``jax.checkpoint`` of a layer."""
    if not (cfg.remat and cache is None and torch.is_grad_enabled()):
        return f
    # the forward draws no random numbers: no RNG state to stash
    return lambda *args: checkpoint(f, *args, use_reentrant=False, preserve_rng_state=False)


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
        # F.embedding, not embed[inputs]: the index's backward adds rows by
        # float atomics on a CPU (float32, many threads); the embedding's
        # backward adds them in one order on the CPU and on the card
        x = _embedding(inputs, model.embed)
    x = shard_hint(x, DP, None, None)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    fam = _block_family(cfg)
    caches = cache["layers"] if cache is not None else [None] * len(model.layers)
    aux = None
    if fam == "attn":
        block = _maybe_remat(_attn_block, cfg, cache)
        for blk, c in zip(model.layers, caches):
            x, a = block(blk, cfg, x, positions, c)
            if a is not None:
                aux = _sum_aux(aux, a)
    elif fam == "rwkv":
        block = _maybe_remat(_rwkv_block, cfg, cache)
        for blk, st in zip(model.layers, caches):
            x = block(blk, cfg, x, st)
    else:
        block = _maybe_remat(_mamba_block, cfg, cache)
        g = cfg.ssm.attn_every
        window = 0
        if cache is not None:
            # a ring iff the cache is shorter than what positions reach
            slots = cache["attn"][0]["k"].shape[1]
            window = HYBRID_ATTN_WINDOW if slots == HYBRID_ATTN_WINDOW else 0
        for grp in range(len(model.layers) // g):
            for i in range(grp * g, (grp + 1) * g):
                x = block(model.layers[i], cfg, x, caches[i])
            ac = cache["attn"][grp] if cache is not None else None
            x, _ = _attn_block(model.shared_attn, cfg, x, positions, ac, window=window)
    x = rms_norm(model.final_norm, x, cfg.norm_eps)
    x = shard_hint(x, DP, None, None)
    if cfg.tie_embeddings:
        logits = linear(x, model.embed.T)
    else:
        logits = dense(model.lm_head, x)
    # vocab-sharded logits: the (B, S, V) tensor is never replicated
    logits = shard_hint(logits, DP, None, "model")
    return logits, cache, aux


def train_loss(model: Transformer, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               lb_coef: float = 0.01):
    """batch: {"inputs": (B,S) int | (B,S,D), "labels": (B,S) int}.  Returns
    (loss, metrics): the token cross-entropy ``ce``, plus ``lb_coef`` times
    the MoE's load-balance loss averaged over layers (``lb_loss``, with
    ``dropped`` as float32), and ``loss``."""
    logits, _, aux = forward(model, cfg, batch["inputs"])
    loss = cross_entropy(logits, batch["labels"])
    metrics = {"ce": loss}
    if aux is not None:
        loss = loss + lb_coef * aux["lb_loss"] / cfg.num_layers
        metrics["lb_loss"] = aux["lb_loss"] / cfg.num_layers
        metrics["dropped"] = aux["dropped"].to(torch.float32)
    metrics["loss"] = loss
    return loss, metrics


def param_leaves(model: Transformer) -> Dict[str, Any]:
    """The reference's parameter tree over the port's tensors: a dict from
    the reference's leaf path ("layers/attn/wq/w", "embed", ...) to the
    parameter, in the reference's leaf order (its dict keys sorted at each
    level).  A leaf the reference stacks over layers is the tuple of the
    layers' parameters, so that the optimizer sees the reference's leaves
    (one int8 scale per stacked leaf; decay by the stacked ndim)."""
    leaves: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            leaves.setdefault("/".join(["layers"] + parts[2:]), []).append(p)
        else:
            leaves["/".join(parts)] = p
    return {k: tuple(v) if isinstance(v, list) else v for k, v in sorted(leaves.items())}
