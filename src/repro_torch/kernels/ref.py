"""Plain torch oracles for the port's block, classification and attention
kernels.

Counterpart of four of ``repro.kernels.ref``'s oracles:
``classify_histogram_ref`` (``ref.py:21``), ``permute_blocks_ref``
(``ref.py:48``), ``flash_attention_ref`` (``ref.py:106``) and
``flash_decode_ref`` (``ref.py:125``).  The tests hold K7, K9, K11 and K10
to them.  The two attention oracles are also K10's and K11's plain twins,
the wrappers' route on CPU tensors: f32 scores with the scale 1/sqrt(hd)
applied to q, the softmax in f32, the output in q's dtype, and the TPU
kernels' edges where the reference's oracles differ from its kernels:
masked scores are -1e30 with a weight of exactly 0, and the denominator is
``max(l, 1e-30)``, so a query with no valid key gives 0 (the reference's
oracles give NaN there).  KV heads that divide the query heads are read as
groups (query head h reads KV head h // group); the reference's
pre-expanded KVH = H is the case group = 1.  ``flash_decode_split_ref``
states K10's split-and-combine algebra (the tests hold it to the
reference).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.classify import classify
from repro_torch.core.sampling import ordered_view

__all__ = ["classify_histogram_ref", "permute_blocks_ref", "flash_attention_ref",
           "flash_decode_ref", "flash_decode_split_ref"]


def classify_histogram_ref(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                           rows: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: the tree classifier (``classify.classify``) + a per-tile
    bincount over tiles of rows * 128 keys.  Keys of any keyspace dtype:
    uint16, uint32 and uint64 keys and splitters classify as their
    order-preserving signed views (``sampling.ordered_view``)."""
    bucket = classify(ordered_view(keys), ordered_view(splitters), k)
    tile = rows * 128
    tiles = bucket.shape[0] // tile
    slot = (torch.arange(tiles, dtype=torch.int64, device=keys.device).repeat_interleave(tile)
            * (2 * k) + bucket.to(torch.int64))
    hist = torch.bincount(slot, minlength=tiles * 2 * k).reshape(tiles, 2 * k)
    return bucket, hist.to(torch.int32)


def permute_blocks_ref(a: torch.Tensor, block_bucket: torch.Tensor, *, k: int,
                       block_elems: int) -> torch.Tensor:
    """Oracle: the stable block grouping by bucket, a new tensor (the
    canonical member of the not-stable permutation's class: compare
    per-bucket block multisets, not the order)."""
    order = torch.sort(block_bucket, stable=True).indices
    return a.reshape(block_bucket.shape[0], block_elems)[order].reshape(-1)


NEG_INF = -1e30


def _softmax_pv(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """f32 attention of the scaled queries qf (B, KVH, group, S, hd) over
    k, v (B, KVH, T, hd) under ``valid`` (broadcast to (B, KVH, group, S,
    T)), with the TPU kernels' -1e30 mask and max(l, 1e-30) divisor."""
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(torch.float32))
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.where(valid, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    return out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def _scaled_groups(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q (B, H, S, hd) as f32 (B, KVH, H // KVH, S, hd) times 1/sqrt(hd)."""
    b, h, s, hd = q.shape
    return q.to(torch.float32).reshape(b, kvh, h // kvh, s, hd) * (1.0 / math.sqrt(hd))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Oracle and plain twin of K11: q (B, H, S, hd), k and v (B, KVH, S,
    hd) -> (B, H, S, hd) in q's dtype.  Query row i attends key j iff (not
    causal or j <= i) and (no window or j > i - window)."""
    b, h, s, hd = q.shape
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = cols <= rows
    if window:
        valid = valid & (cols > rows - window)
    out = _softmax_pv(_scaled_groups(q, k.shape[1]), k, v, valid)
    return out.reshape(b, h, s, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Oracle and plain twin of K10: q (B, H, 1, hd), cache k and v (B,
    KVH, T, hd) (any strides), length (B,) -> (B, H, 1, hd) in q's dtype;
    request b attends to its keys [0, length[b])."""
    b, h, _, hd = q.shape
    t = k.shape[2]
    valid = torch.arange(t, device=q.device)[None, :] < length.to(q.device)[:, None]
    out = _softmax_pv(_scaled_groups(q, k.shape[1]), k, v, valid[:, None, None, None, :])
    return out.reshape(b, h, 1, hd).to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor, splits: int, unit: int = 16) -> torch.Tensor:
    """K10's algebra, plainly: ``flash_decode_ref`` computed as the kernel's
    cluster computes it.  Request b's valid prefix, ``length[b]`` clamped to
    [0, T], is cut into ``splits`` contiguous shares in units of ``unit``
    rows (share r: units [r * u // splits, (r + 1) * u // splits), u =
    ceil(length / unit)).  Each share keeps its own f32 (m, l, acc): m the
    largest score (-1e30 if the share is empty), l the sum of exp(s - m),
    acc that sum's weights times V.  The shares combine with M = max m_r:
    out = sum acc_r e^(m_r - M) / max(sum l_r e^(m_r - M), 1e-30), so an
    empty share weighs 0 beside any other and length 0 gives 0."""
    b, h, _, hd = q.shape
    t = k.shape[2]
    lens = length.to(q.device, torch.int64).clamp(0, t)
    units = (lens + unit - 1) // unit
    sc = torch.einsum("bkgsd,bktd->bkgst", _scaled_groups(q, k.shape[1]), k.to(torch.float32))
    pos = torch.arange(t, device=q.device)
    parts = []
    for r in range(splits):
        start = torch.minimum(lens, r * units // splits * unit)
        end = torch.minimum(lens, (r + 1) * units // splits * unit)
        share = ((pos >= start[:, None]) & (pos < end[:, None]))[:, None, None, None, :]
        s_r = torch.where(share, sc, NEG_INF)
        m_r = s_r.amax(dim=-1, keepdim=True)
        p_r = torch.where(share, torch.exp(s_r - m_r), 0.0)
        parts.append((m_r, p_r.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgst,bktd->bkgsd", p_r, v.to(torch.float32))))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum = sum(l * torch.exp(m - m_all) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - m_all) for m, _, a in parts)
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.reshape(b, h, 1, hd).to(q.dtype)
