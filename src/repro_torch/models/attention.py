"""Grouped-query attention with KV cache, RoPE, and sliding-window support.

Counterpart of ``repro.models.attention``: ``init_attention`` builds an
``Attention`` module holding wq/wk/wv/wo, ``attention`` applies it, with
every cast of the reference.  Modes:

  * training (``cache=None``): the full (B, S) sequence under the causal
    (and banded, with ``window``) mask;
  * prefill (S > 1 with a cache): the same attention over the prompt, then
    every slot of the cache is written (the prompt's keys and values, zeros
    after them; the last ``slots`` keys rolled into ring order when a
    window's ring is shorter than the prompt);
  * decode (S == 1): one entry written at slot ``min(pos, slots - 1)``, or
    ``pos % slots`` on a windowed ring buffer, then attention over the
    valid slots (``j <= pos``, or by ring age);
  * ``flash_block`` (policy): training and prefill run the KV-chunked
    online softmax ``_sdpa_flash`` (a torch loop over chunks) in place of
    the full-score ``_sdpa``.

The cache is a dict {"k", "v": (B, slots, KVH, hd) tensors, "pos": int}
updated **in place**: the port's form of the reference's donated buffer.
Under ``ComputePolicy.flash_decode`` (and no window) decode runs the K10
kernel over the cache where it lies (``kernels.flash_decode``), with
length = pos + 1 for every row, where the reference copies the cache
group-expanded and transposed for its Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_decode import flash_decode_cache
from repro_torch.models.layers import (
    DP, Dense, dense, init_dense, init_device, model_device, rope, shard_hint, split_heads,
)
from repro_torch.models.policy import current_policy
from repro_torch.ops.sort import Device

__all__ = ["Attention", "init_attention", "attention", "init_cache", "AttnCache"]

AttnCache = Dict[str, Any]


class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attention(
    gen: torch.Generator,
    d_model: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    bias: bool = False,
    dtype=torch.bfloat16,
    device: Device = None,
) -> Attention:
    """wq, wk, wv (with biases when ``bias``) and wo on ``device`` (the card
    by default), drawn from ``gen`` on that device."""
    kw = dict(dtype=dtype, device=init_device(gen, device))
    return Attention(
        init_dense(gen, d_model, num_heads * head_dim, bias=bias, **kw),
        init_dense(gen, d_model, num_kv_heads * head_dim, bias=bias, **kw),
        init_dense(gen, d_model, num_kv_heads * head_dim, bias=bias, **kw),
        init_dense(gen, num_heads * head_dim, d_model, **kw),
    )


def init_cache(
    batch: int,
    seq: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    window: int = 0,
    dtype=torch.bfloat16,
    device: Device = None,
) -> AttnCache:
    """Decode cache on ``device`` (the card by default).  ``seq`` is the
    maximum context; with a window the buffer is a ring of
    ``min(window, seq)`` slots."""
    device = model_device(device)
    slots = min(window, seq) if window else seq
    return {
        "k": torch.zeros((batch, slots, num_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, num_kv_heads, head_dim), dtype=dtype, device=device),
        "pos": 0,
    }


def _sdpa(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KVH, hd)
    v: torch.Tensor,  # (B, T, KVH, hd)
    mask: Optional[torch.Tensor],  # broadcastable to (B, KVH, group, S, T) or None
) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return _sdpa_sharded(q, k, v, mask)
    return _sdpa_local(q, k, v, mask)


def _sdpa_local(q, k, v, mask):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh if kvh else 1
    qg = q.reshape(b, s, kvh, group, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)  # cast before the PV product
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h * hd)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim)


def _sdpa_sharded(q, k, v, mask):
    """``_sdpa`` of DTensors as per-rank code: heads over the mesh
    dimensions that do not shard the batch (KV heads expanded to the query
    heads where their groups would straddle ranks), the plain formula on
    each rank's heads; or, for one query against a cache sharded by slots,
    a flash-decoding combine over the slot shards."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (q if hasattr(q, "device_mesh") else k).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    slots = [i for i, p in enumerate(k.placements) if p.is_shard() and p.dim == 1]
    if slots and s == 1:
        return _sdpa_slot_parallel(q, k, v, mask, slots)
    batch = [i for i, p in enumerate(q.placements) if p == Shard(0)]
    heads = [i for i in range(mesh.ndim) if i not in batch and mesh.size(i) > 1]
    n_head_shards = 1
    for i in heads:
        n_head_shards *= mesh.size(i)
    if kvh % n_head_shards:  # one KV head a query head
        k, v = _expand_kv(k, h // kvh), _expand_kv(v, h // kvh)
    pad = -h % n_head_shards
    if pad:  # heads padded to a multiple of the shards, as GSPMD pads them
        rep = [Replicate() if i in heads else p for i, p in enumerate(q.placements)]
        q, k, v = (F.pad(t.redistribute(mesh, rep), (0, 0, 0, pad)) for t in (q, k, v))
    pl = tuple(Shard(0) if i in batch else Shard(2) if i in heads else Replicate()
               for i in range(mesh.ndim))
    f = local_map(lambda q, k, v: _sdpa_local(q, k, v, mask).reshape(q.shape),
                  out_placements=(pl,), in_placements=(pl, pl, pl),
                  in_grad_placements=(pl, pl, pl), redistribute_inputs=True,
                  device_mesh=mesh)
    out = f(q, k, v)  # (B, S, H + pad, hd), heads sharded
    if pad:
        out = out.redistribute(mesh, tuple(Replicate() if i in heads else p
                                           for i, p in enumerate(pl)))[:, :, :h]
    return out.reshape(b, s, h * hd)


def _sdpa_slot_parallel(q, k, v, mask, slots):
    """One query a row against a cache whose slots are sharded (flash
    decoding): each rank scores its slots, the running max is reduced over
    the slot shards, and the weights' sums and the weighted values are
    summed over them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    kv_pl = tuple(k.placements)
    q_pl = tuple(Replicate() if i in slots else p for i, p in enumerate(kv_pl))
    lo, hi = _slot_range(k)

    def local_scores(q, k):
        sc = torch.einsum("bskgd,btkd->bkgst", q.reshape(q.shape[0], s, kvh, group, hd),
                          k).to(torch.float32) * (1.0 / math.sqrt(hd))
        if mask is not None:
            sc = torch.where(mask[..., lo:hi], sc, -1e30)
        return sc

    m_pl = tuple(Partial("max") if i in slots else p for i, p in enumerate(q_pl))
    m = local_map(lambda q, k: local_scores(q, k).amax(dim=-1, keepdim=True),
                  out_placements=(m_pl,), in_placements=(q_pl, kv_pl),
                  redistribute_inputs=True, device_mesh=mesh)(q, k)
    m = m.redistribute(mesh, q_pl)
    sum_pl = tuple(Partial() if i in slots else p for i, p in enumerate(q_pl))

    def partial_sums(q, k, v, m):
        w = torch.exp(local_scores(q, k) - m)
        o = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v).to(torch.float32)
        return w.sum(dim=-1, keepdim=True), o

    l, o = local_map(partial_sums, out_placements=(sum_pl, sum_pl),
                     in_placements=(q_pl, kv_pl, kv_pl, q_pl),
                     redistribute_inputs=True, device_mesh=mesh)(q, k, v, m)
    l, o = l.redistribute(mesh, q_pl), o.redistribute(mesh, q_pl)
    # l: (B, KVH, G, 1, 1) -> (B, 1, KVH, G, 1) beside o (B, 1, KVH, G, hd)
    out = o / l.permute(0, 3, 1, 2, 4)
    return out.to(v.dtype).reshape(b, s, h * hd)


def _expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B,T,KVH,hd) -> (B,T,KVH*group,hd)."""
    if group == 1:
        return k
    b, t, kvh, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kvh, group, hd).reshape(b, t, kvh * group, hd)


def _sdpa_flash(
    q: torch.Tensor,     # (B, S, H, hd)
    k: torch.Tensor,     # (B, T, KVH, hd)
    v: torch.Tensor,     # (B, T, KVH, hd)
    window: int,
    block: int,
) -> torch.Tensor:
    """KV-chunked online-softmax attention: a torch loop over KV chunks of
    ``block`` keys carries the running (max, denominator, accumulator) in
    f32, so the (S, T) score matrix never exists."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    k = _expand_kv(k, h // kvh)
    v = _expand_kv(v, h // kvh)
    q = shard_hint(q, DP, None, "model", None)
    k = shard_hint(k, DP, None, "model", None)
    v = shard_hint(v, DP, None, "model", None)
    t = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(s, device=dev)[:, None]                 # query pos
    qf = q.to(torch.float32) * scale

    m = torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = shard_hint(torch.zeros((b, h, s, hd), dtype=torch.float32, device=dev),
                     DP, "model", None, None)
    for t0 in range(0, t, block):
        kb = k[:, t0:t0 + block].to(torch.float32)
        vb = v[:, t0:t0 + block].to(torch.float32)
        pad = block - kb.shape[1]                              # kv padding
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        sc = torch.einsum("bshd,bthd->bhst", qf, kb)
        kj = t0 + torch.arange(block, device=dev)[None, :]     # (1, block)
        valid = kj <= qi                                       # causal
        if window:
            valid = valid & (kj > qi - window)
        valid = valid & (kj[0] < t)[None, :]
        sc = torch.where(valid[None, None], sc, float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # fully-masked-so-far rows: keep exp() finite
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(valid[None, None], p, 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.transpose(1, 2).to(q.dtype)                      # (B, S, H, hd)
    return out.reshape(b, s, h * hd)


def _slot_range(t: torch.Tensor) -> Tuple[int, int]:
    """[lo, hi): the cache slots (dimension 1) this rank holds of a DTensor
    (``torch.chunk``'s split, mesh dimension by mesh dimension)."""
    mesh = t.device_mesh
    lo, size = 0, t.shape[1]
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim == 1:
            chunk = -(-size // mesh.size(i))
            start = min(mesh.get_local_rank(i) * chunk, size)
            lo, size = lo + start, min(chunk, size - start)
    return lo, lo + size


def _write_slots(t: torch.Tensor, start: int, val: Optional[torch.Tensor]) -> None:
    """``t[:, start:start + n] = val`` (zeros to the end when ``val`` is
    None) on a cache tensor, in place.  A DTensor cache is written where its
    slots lie: ``val`` is laid out as the cache on every dimension but the
    slots', and each rank writes the slots it holds."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        if val is None:
            t[:, start:] = 0
        else:
            t[:, start:start + val.shape[1]] = val
        return
    local = t.to_local()
    lo, hi = _slot_range(t)
    stop = t.shape[1] if val is None else start + val.shape[1]
    a, b = max(start, lo), min(stop, hi)
    if val is not None:
        mesh = t.device_mesh
        want = [Replicate() if (p.is_shard() and p.dim == 1) else p for p in t.placements]
        if not isinstance(val, DTensor):
            val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim)
        val = val.redistribute(mesh, want).to_local()
    if a >= b:
        return
    if val is None:
        local[:, a - lo:b - lo] = 0
    else:
        local[:, a - lo:b - lo] = val[:, a - start:b - start]


def _causal_mask(s: int, window: int, device=None) -> torch.Tensor:
    """(1, 1, s, s) boolean mask; query i attends key j iff j <= i and
    (no window or j > i - window)."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m[None, None]


def attention(
    p: Attention,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    cache: Optional[AttnCache] = None,
) -> Tuple[torch.Tensor, Optional[AttnCache]]:
    """Apply attention.

    training:       cache=None                 -> (out, None)
    prefill:        cache given, S > 1          (writes every slot; pos = S)
    decode (S==1):  cache given                 (writes at cache['pos'])

    A given cache is updated in place and returned.
    """
    b, s, _ = x.shape
    q = split_heads(dense(p.wq, x), num_heads, head_dim)
    k = split_heads(dense(p.wk, x), num_kv_heads, head_dim)
    v = split_heads(dense(p.wv, x), num_kv_heads, head_dim)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    fb = current_policy().flash_block
    use_flash = fb > 0 and s > 1 and s >= fb

    def full(q, k, v):
        if use_flash:
            return _sdpa_flash(q, k, v, window, fb)
        return _sdpa(q, k, v, _causal_mask(s, window, x.device))

    if cache is None:
        return dense(p.wo, full(q, k, v)), None

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    pos = cache["pos"]
    if s == 1:
        # Decode: write one entry (ring-buffer slot when windowed).
        slot = pos % slots if window else min(pos, slots - 1)
        _write_slots(ck, slot, k)
        _write_slots(cv, slot, v)
        cache["pos"] = pos + 1
        if current_policy().flash_decode and not window:
            length = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
            o = flash_decode_cache(q[:, 0], ck, cv, length)    # (B, H, hd)
            return dense(p.wo, o.reshape(b, 1, num_heads * head_dim)), cache
        # Valid keys: on a ring only "is it within the window" matters, not
        # a slot's absolute position (keys were rotated at write time).
        j = torch.arange(slots, device=x.device)
        if window:
            age = (slot - j) % slots  # 0 = just written
            valid = age <= min(pos, window - 1)
        else:
            valid = j <= pos
        out = _sdpa(q, ck, cv, valid[None, None, None, :])
        return dense(p.wo, out), cache

    # Prefill: write the whole (possibly window-truncated) sequence.
    out = full(q, k, v)
    if window and slots < s:
        # Keep the last ``slots`` keys, aligned so that ring slot
        # (i % slots) holds absolute position i for i in [s-slots, s).
        roll = (-(s - slots)) % slots
        _write_slots(ck, 0, torch.roll(k[:, -slots:], shifts=-roll, dims=1))
        _write_slots(cv, 0, torch.roll(v[:, -slots:], shifts=-roll, dims=1))
    elif s > slots:
        raise ValueError(f"prefill of {s} tokens exceeds the cache's {slots} slots")
    else:
        for c, new in ((ck, k), (cv, v)):
            _write_slots(c, 0, new)
            _write_slots(c, s, None)
    cache["pos"] = s
    return dense(p.wo, out), cache
