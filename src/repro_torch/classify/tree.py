"""The sampled comparison-tree classifier (paper §3 + equality buckets §4.4).

Counterpart of ``repro.classify.tree``.  Bucket j of k holds the keys in
(s_{j-1}, s_j]; the local id is ``2j + (key == s_j)``, so odd ids are
equality buckets (runs of one key) that deeper levels and the base case
skip.  The reference descends the implicit BFS tree; the port counts the
splitters below each key with ``torch.searchsorted``, which gives the same
j, and needs no tree at all.  This is plain torch on both devices: the
level-1 classification inside kernels K1 and K4 (``kernels.level_fused``)
is held to :func:`classify_batched` (:func:`classify` is its one-row
form), and level 2's :func:`classify_segmented` (XLA in the reference) is
the plain twin of the G3 kernel ``kernels.glue.composite_ids``, which the
sort runs on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import sentinel_for

__all__ = ["classify", "classify_batched", "classify_segmented", "num_local_buckets"]


def num_local_buckets(k: int) -> int:
    """2j + eq with j in [0, k) -> ids in [0, 2k)."""
    return 2 * k


def _upper(splitters: torch.Tensor) -> torch.Tensor:
    """(..., k-1) splitters -> (..., k) bucket uppers, the last the sentinel."""
    sent = torch.full(
        splitters.shape[:-1] + (1,), sentinel_for(splitters.dtype),
        dtype=splitters.dtype, device=splitters.device,
    )
    return torch.cat([splitters, sent], dim=-1)


def classify(keys: torch.Tensor, splitters: torch.Tensor, k: int) -> torch.Tensor:
    """Local bucket ids (n,) int32 in [0, 2k) of ``keys`` against sorted
    ``splitters`` (k-1,)."""
    return classify_batched(keys[None], splitters[None], k)[0]


def classify_batched(keys: torch.Tensor, splitters: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row classification: ``keys`` (B, n) against each row's own
    sorted ``splitters`` (B, k-1).  Returns local ids (B, n) int32."""
    j = torch.searchsorted(splitters, keys, right=False)
    eq = keys == torch.gather(_upper(splitters), 1, j)
    return (2 * j + eq).to(torch.int32)


def classify_segmented(
    keys: torch.Tensor, seg: torch.Tensor, splitters: torch.Tensor, k: int
) -> torch.Tensor:
    """Per-segment classification (recursion level 2, flattened).

    ``seg`` (n,) gives each element's segment and ``splitters``
    (num_seg, k-1) each segment's sorted splitters.  Returns local ids in
    [0, 2k); the caller forms the composite id ``seg * 2k + local``.

    int32 keys: one ``searchsorted`` over (segment, key) pairs packed into
    int64 — segment in the high word, the key offset to unsigned in the low
    word — against the splitters packed the same way, which are globally
    sorted.  It counts every splitter of the earlier segments plus this
    segment's splitters below the key; n-sized temporaries only.  int64
    keys do not fit a word beside their segment: they take
    :func:`_count_below_segmented`, a per-segment binary search.
    """
    num_seg = splitters.shape[0]
    seg64 = seg.to(torch.int64)
    if keys.dtype == torch.int64:
        j = _count_below_segmented(keys, seg64, splitters.reshape(-1), k)
        eq = keys == _upper(splitters).reshape(-1)[seg64 * k + j]
        return (2 * j + eq).to(torch.int32)
    bias = 1 << 31
    packed_keys = (seg64 << 32) + (keys.to(torch.int64) + bias)
    seg_base = torch.arange(num_seg, dtype=torch.int64, device=keys.device) << 32
    packed_spl = (seg_base[:, None] + (splitters.to(torch.int64) + bias)).reshape(-1)
    j = torch.searchsorted(packed_spl, packed_keys, right=False) - seg64 * (k - 1)
    upper = _upper(splitters).reshape(-1)
    eq = keys == upper[seg64 * k + j]
    return (2 * j + eq).to(torch.int32)


def _count_below_segmented(
    keys: torch.Tensor, seg64: torch.Tensor, flat_spl: torch.Tensor, k: int
) -> torch.Tensor:
    """The number of its segment's k-1 sorted splitters below each key (the
    left ``searchsorted``), by a branchless binary search over the flattened
    (num_seg * (k-1),) splitters: log2(k) gathers of n, no packing."""
    base = seg64 * (k - 1)
    j = torch.zeros_like(seg64)
    step = k // 2
    while step:
        j += (flat_spl[base + j + (step - 1)] < keys) * step
        step //= 2
    return j
