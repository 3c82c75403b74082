"""K1 ``level_fused`` and K2 ``rank_hist``: the fused level pass.

Counterpart of ``repro.kernels.level_fused`` (the Pallas TPU kernels at
``level_fused.py:160`` and ``:311``).  The CUDA kernels are in
``csrc/level_fused.cu``, whose header note gives their bound and design.
Each wrapper launches its kernel on a CUDA tensor and runs its plain torch
twin (``*_plain``, same outputs bit for bit) only on a CPU tensor; there is
no fallback from one to the other.

K1 ``level_fused``: classify each key against the k-1 sorted splitters
(tree mode), route positions >= n_real to the pad bucket 2k, and rank each
key stably within its tile; the epilogue :func:`_close_placement` (plain
torch, as XLA runs it in the reference) turns the per-tile ranks and
histogram into the global destinations and bucket offsets.

K2 ``rank_hist``: the same rank + histogram + epilogue over given ids in
[0, nb).  With ``seg_offsets`` it takes level 2's composite ids
``seg * seg_width + local`` at any nb: work items never straddle a segment,
each item ranks over ``seg_width`` counters, and the epilogue
:func:`_close_segments` offsets each segment by its start.

Both return (dest (n,) int32, offsets (nb+1,) int32), bit-identical to the
stable counting placement of ``core.partition.partition_permutation``:
scattering ``a[i] -> dest[i]`` groups a payload by bucket, stably.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.classify import classify
from repro_torch.core.sampling import sentinel_for
from repro_torch.kernels import _build

__all__ = [
    "level_fused",
    "level_fused_plain",
    "rank_hist",
    "rank_hist_plain",
    "TILE",
    "MAX_TILE",
    "MAX_NB",
]

TILE = 4096  # default keys per CTA (K1) or per work item (K2)
MAX_TILE = 16384  # two staged int arrays of this many keys fit shared memory
MAX_NB = 2048  # counters per CTA: 8 warps x MAX_NB ints of shared memory

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "level_fused_tree": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "level_fused_rank_hist": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
}


def _check_ids(x: torch.Tensor, what: str) -> None:
    if x.dim() != 1 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{what}: n={x.shape[0]} exceeds int32 positions")


def _check_tile(tile: int, nb: int) -> None:
    if not 0 < tile <= MAX_TILE:
        raise ValueError(f"tile={tile} must be in (0, {MAX_TILE}]")
    if nb > MAX_NB:
        raise ValueError(f"{nb} counters per tile exceed MAX_NB={MAX_NB}")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# plain building blocks (shared by the CPU path and the kernels' twins)


def _slot_rank_hist(slot: torch.Tensor, num_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable rank of each element among the earlier elements of its slot,
    and the count per slot: the plain form of the kernels' in-tile pass."""
    n = slot.shape[0]
    s64 = slot.to(torch.int64)
    order = torch.sort(s64, stable=True).indices
    counts = torch.bincount(s64, minlength=num_slots).to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank = torch.empty(n, dtype=torch.int32, device=slot.device)
    pos = torch.arange(n, dtype=torch.int32, device=slot.device)
    rank[order] = pos - starts[s64[order]]
    return rank, counts


def _cumsum_rows(hist: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of a (rows, nb) histogram down its rows.  Taken
    along the inner dim of a transposed copy: PyTorch's int32 scan along the
    outer dim took 1.1 ms at (4096, 257) on the H100 (PERF.md)."""
    return torch.cumsum(hist.t().contiguous(), 1, dtype=torch.int32).t()


def _close_placement(
    bucket: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor, nb: int, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's epilogue: prefix-sum the (tiles, nb) histogram and place every
    element, dest = offsets[b] + tile_off[t, b] + rank."""
    n = bucket.shape[0]
    dev = bucket.device
    offsets = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(hist.sum(0, dtype=torch.int32), 0, dtype=torch.int32)
    tile_off = _cumsum_rows(hist) - hist
    base = (offsets[:-1][None, :] + tile_off).reshape(-1)
    t_idx = torch.arange(n, dtype=torch.int64, device=dev) // tile
    dest = base[t_idx * nb + bucket.to(torch.int64)] + rank
    return dest, offsets


# ---------------------------------------------------------------------------
# K1


def _upper(splitters: torch.Tensor) -> torch.Tensor:
    sent = torch.full((1,), sentinel_for(torch.int32), dtype=torch.int32,
                      device=splitters.device)
    return torch.cat([splitters, sent]).contiguous()


def _level_tiles_plain(keys, splitters, k, n_real, tile):
    """(bucket, in-tile rank, (tiles, nb) histogram): what the K1 kernel
    writes, in plain torch."""
    n = keys.shape[0]
    nb = 2 * k + 1
    bucket = classify(keys, splitters, k)
    bucket[n_real:] = 2 * k
    tiles = -(-n // tile)
    t_idx = torch.arange(n, dtype=torch.int64, device=keys.device) // tile
    rank, counts = _slot_rank_hist(t_idx * nb + bucket, tiles * nb)
    return bucket, rank, counts.reshape(tiles, nb)


def _level_tiles_kernel(keys, splitters, k, n_real, tile):
    n = keys.shape[0]
    nb = 2 * k + 1
    upper = _upper(splitters)
    tiles = -(-n // tile)
    bucket = torch.empty_like(keys)
    rank = torch.empty_like(keys)
    hist = torch.empty((tiles, nb), dtype=torch.int32, device=keys.device)
    lib = _build.library("level_fused", _SIGNATURES)
    err = lib.level_fused_tree(
        keys.data_ptr(), upper.data_ptr(), n, n_real, k, tile,
        bucket.data_ptr(), rank.data_ptr(), hist.data_ptr(),
        _build.stream_handle(keys.device),
    )
    _build.check(lib, "level_fused", err, "level_fused kernel")
    _build.LAUNCHES["level_fused"] += 1
    return bucket, rank, hist


def _level_args(keys, splitters, k, n_real, tile):
    _check_ids(keys, "level_fused keys")
    if k < 2 or k & (k - 1):
        raise ValueError(f"k={k} must be a power of two >= 2")
    _check_tile(tile, 2 * k + 1)
    n = keys.shape[0]
    n_real = n if n_real is None else n_real
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real={n_real} outside [0, {n}]")
    if splitters.shape != (k - 1,) or splitters.dtype != torch.int32:
        raise ValueError(f"splitters: expected ({k - 1},) int32, got "
                         f"{tuple(splitters.shape)} {splitters.dtype}")
    if splitters.device != keys.device:
        raise ValueError("keys and splitters must share a device")
    return n_real


def level_fused(
    keys: torch.Tensor,
    splitters: torch.Tensor,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused level pass over encoded ``keys`` (n,) int32 with sorted
    ``splitters`` (k-1,) int32: the K1 kernel on a CUDA tensor, its plain
    twin on a CPU tensor.  Positions >= ``n_real`` go to the pad bucket 2k.

    Returns (dest (n,) int32, offsets (2k+2,) int32).
    """
    n_real = _level_args(keys, splitters, k, n_real, tile)
    if _device_kind(keys) == "cuda":
        bucket, rank, hist = _level_tiles_kernel(keys, splitters, k, n_real, tile)
    else:
        bucket, rank, hist = _level_tiles_plain(keys, splitters, k, n_real, tile)
    return _close_placement(bucket, rank, hist, 2 * k + 1, tile)


def level_fused_plain(
    keys: torch.Tensor,
    splitters: torch.Tensor,
    *,
    k: int,
    n_real: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain torch twin on any device (the card-side comparison)."""
    n_real = _level_args(keys, splitters, k, n_real, tile)
    bucket, rank, hist = _level_tiles_plain(keys, splitters, k, n_real, tile)
    return _close_placement(bucket, rank, hist, 2 * k + 1, tile)


# ---------------------------------------------------------------------------
# K2


def _items(seg_offsets: torch.Tensor, n: int, tile: int):
    """Work items (start, len, seg) of at most ``tile`` positions that never
    straddle a segment, in position order, padded with empty items (start n)
    to the static bound n // tile + num_seg, so no host read is needed."""
    dev = seg_offsets.device
    lo = seg_offsets[:-1].to(torch.int64)
    hi = seg_offsets[1:].to(torch.int64)
    num_seg = lo.shape[0]
    per_seg = (hi - lo + tile - 1) // tile
    ends = torch.cumsum(per_seg, 0)
    first = ends - per_seg
    num_items = n // tile + num_seg
    i = torch.arange(num_items, dtype=torch.int64, device=dev)
    seg = torch.clamp(torch.searchsorted(ends, i, right=True), max=num_seg - 1)
    start = lo[seg] + (i - first[seg]) * tile
    length = torch.clamp(torch.minimum(hi[seg] - start, torch.full_like(start, tile)), min=0)
    live = i < ends[-1]
    start = torch.where(live, start, n)
    length = torch.where(live, length, 0)
    return (start.to(torch.int32), length.to(torch.int32), seg.to(torch.int32),
            first, per_seg)


def _close_segments(rank, slot, hist, seg_offsets, item_seg, first, per_seg, n):
    """K2's epilogue: per segment, scan the items' histograms to get each
    item's start per local id, offset the segment's local buckets by its
    start, and place every element, dest = base[slot] + rank."""
    dev = hist.device
    num_items, width = hist.shape
    cum = torch.zeros((num_items + 1, width), dtype=torch.int32, device=dev)
    cum[1:] = _cumsum_rows(hist)
    totals = cum[first + per_seg] - cum[first]  # (num_seg, width)
    seg_base = (seg_offsets[:-1, None] + torch.cumsum(totals, 1, dtype=torch.int32)
                - totals)  # (num_seg, width)
    offsets = torch.cat([seg_base.reshape(-1),
                         torch.full((1,), n, dtype=torch.int32, device=dev)])
    seg64 = item_seg.to(torch.int64)
    base = (seg_base[seg64] + cum[:-1] - cum[first[seg64]]).reshape(-1)
    dest = base[slot.to(torch.int64)] + rank
    return dest, offsets


def _rank_hist_args(ids, nb, seg_offsets, seg_width, tile):
    _check_ids(ids, "rank_hist ids")
    n = ids.shape[0]
    if seg_offsets is None:
        seg_offsets = torch.tensor([0, n], dtype=torch.int32, device=ids.device)
        seg_width = nb
    if seg_width is None or nb % seg_width:
        raise ValueError(f"nb={nb} must be num_seg * seg_width (seg_width={seg_width})")
    if seg_offsets.dtype != torch.int32 or seg_offsets.dim() != 1:
        raise ValueError("seg_offsets: expected a 1-D int32 tensor")
    if seg_offsets.device != ids.device:
        raise ValueError("ids and seg_offsets must share a device")
    if seg_offsets.shape[0] - 1 != nb // seg_width:
        raise ValueError(f"{seg_offsets.shape[0] - 1} segments != nb // seg_width")
    _check_tile(tile, seg_width)
    return seg_offsets.contiguous(), seg_width


def _rank_hist_slots_plain(ids, seg_width, item_start, item_seg):
    n = ids.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=ids.device)
    item = torch.searchsorted(item_start, pos, right=True) - 1
    slot = item * seg_width + (ids - item_seg[item] * seg_width)
    rank, counts = _slot_rank_hist(slot, item_start.shape[0] * seg_width)
    return rank, slot, counts.reshape(-1, seg_width)


def _rank_hist_slots_kernel(ids, seg_width, item_start, item_len, item_seg, tile):
    num_items = item_start.shape[0]
    rank = torch.empty_like(ids)
    slot = torch.empty_like(ids)
    hist = torch.empty((num_items, seg_width), dtype=torch.int32, device=ids.device)
    lib = _build.library("level_fused", _SIGNATURES)
    err = lib.level_fused_rank_hist(
        ids.data_ptr(), item_start.data_ptr(), item_len.data_ptr(),
        item_seg.data_ptr(), num_items, seg_width, tile,
        rank.data_ptr(), slot.data_ptr(), hist.data_ptr(),
        _build.stream_handle(ids.device),
    )
    _build.check(lib, "level_fused", err, "rank_hist kernel")
    _build.LAUNCHES["rank_hist"] += 1
    return rank, slot, hist


def _rank_hist(ids, nb, seg_offsets, seg_width, tile, plain):
    seg_offsets, seg_width = _rank_hist_args(ids, nb, seg_offsets, seg_width, tile)
    n = ids.shape[0]
    item_start, item_len, item_seg, first, per_seg = _items(seg_offsets, n, tile)
    if plain:
        rank, slot, hist = _rank_hist_slots_plain(ids, seg_width, item_start, item_seg)
    else:
        rank, slot, hist = _rank_hist_slots_kernel(
            ids, seg_width, item_start, item_len, item_seg, tile)
    return _close_segments(rank, slot, hist, seg_offsets, item_seg, first, per_seg, n)


def rank_hist(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable rank + histogram over ``ids`` (n,) int32 in [0, nb): the K2
    kernel on a CUDA tensor, its plain twin on a CPU tensor.

    With ``seg_offsets`` (num_seg+1,) int32 the ids must be composite,
    ``seg * seg_width + local`` for the segment holding the position, and nb
    = num_seg * seg_width; only ``seg_width`` counters are live per item,
    whatever nb is.  Without it the whole array is one segment of width nb.

    Returns (dest (n,) int32, offsets (nb+1,) int32).
    """
    return _rank_hist(ids, nb, seg_offsets, seg_width, tile,
                      plain=_device_kind(ids) == "cpu")


def rank_hist_plain(
    ids: torch.Tensor,
    *,
    nb: int,
    seg_offsets: Optional[torch.Tensor] = None,
    seg_width: Optional[int] = None,
    tile: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain torch twin on any device (the card-side comparison)."""
    return _rank_hist(ids, nb, seg_offsets, seg_width, tile, plain=True)
