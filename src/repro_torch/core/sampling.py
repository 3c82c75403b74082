"""Splitter sampling and the implicit search tree (paper §3, §4).

Counterpart of ``repro.core.sampling``.  The reference draws its sample
positions with ``jax.random``; the port draws them from an explicit
``torch.Generator`` seeded from ``SortConfig.seed``.  The two give other
bits from the same seed, so parity tests feed both sides the same
splitters (or, for ``repro_torch.dist``, the same sample positions); the
sorted output and the stable argsort are unique, so the end-to-end results
agree whatever the sample.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "tree_permutation",
    "build_tree",
    "sentinel_for",
    "ordered_view",
    "from_ordered_view",
    "signed_payload",
    "oversampling_factor",
    "sample_indices",
    "positions_from_uniform",
    "tree_permutation_on",
    "select_splitters",
    "splitters_from_histogram",
]


@functools.lru_cache(maxsize=None)
def tree_permutation(k: int) -> np.ndarray:
    """Static permutation mapping BFS tree slots -> sorted-splitter indices
    (slot 0 unused; the root holds the median splitter)."""
    if k & (k - 1):
        raise ValueError(f"k must be a power of two, got {k}")
    perm = np.zeros(k, np.int64)

    def rec(node: int, lo: int, hi: int) -> None:
        if lo >= hi:
            return
        mid = (lo + hi) // 2
        perm[node] = mid
        rec(2 * node, lo, mid)
        rec(2 * node + 1, mid + 1, hi)

    rec(1, 0, k - 1)
    return perm


def tree_permutation_on(k: int, device) -> torch.Tensor:
    """:func:`tree_permutation` (k,) int64, made on ``device`` with no copy
    from the host.  BFS slot ``2^L + p`` (level L of the d = log2(k) levels)
    holds sorted index ``(2p + 1) 2^(d-1-L) - 1``: for sorted index j, the
    lowest set bit v of j + 1 gives the slot ``(k/2) / v + (j + 1) / (2v)``."""
    if k & (k - 1) or k < 2:
        raise ValueError(f"k must be a power of two >= 2, got {k}")
    j = torch.arange(k - 1, dtype=torch.int64, device=device)
    v = (j + 1) & -(j + 1)
    slot = (k // 2) // v + (j + 1) // (2 * v)
    return torch.zeros(k, dtype=torch.int64, device=device).scatter_(0, slot, j)


def build_tree(splitters: torch.Tensor, k: int) -> torch.Tensor:
    """Lay out sorted splitters (..., k-1) into BFS tree slots (..., k)."""
    return torch.index_select(splitters, -1, tree_permutation_on(k, splitters.device))


def sentinel_for(dtype: torch.dtype) -> int:
    """Largest value of ``dtype``: the pad key and the upper splitter of the
    last bucket.  The port's keys are signed encoded ints, so this is the
    signed max, which is also the code of NaN."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


_FLIPPED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def ordered_view(keys: torch.Tensor) -> torch.Tensor:
    """Raw keys as a tensor torch can compare and search in their order:
    uint16, uint32 and uint64 keys (whose torch dtypes lack ``>`` and
    ``searchsorted``) as their signed view with the sign bit flipped, an
    order-preserving bijection that maps the dtype's max to the signed max
    (so :func:`sentinel_for` of the view is the view of the key's);
    :func:`from_ordered_view` undoes it.  Other keys as they are.

    >>> ordered_view(torch.tensor([0, 65535], dtype=torch.uint16)).tolist()
    [-32768, 32767]
    """
    signed = _FLIPPED.get(keys.dtype)
    if signed is None:
        return keys
    return keys.view(signed) ^ torch.iinfo(signed).min


def signed_payload(values: torch.Tensor) -> torch.Tensor:
    """``values`` viewed as a dtype torch can gather and scatter on every
    device (the bits as they are): torch's unsigned dtypes past 8 bits lack
    ``index_put`` everywhere and gathers on a card, so uint16/32/64 move as
    the signed int of their width; ``values.view(dtype)`` restores them."""
    return values.view(_FLIPPED.get(values.dtype, values.dtype))


def from_ordered_view(view: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The keys of ``dtype`` whose :func:`ordered_view` is ``view``."""
    if dtype not in _FLIPPED:
        return view
    return (view ^ torch.iinfo(view.dtype).min).view(dtype)


def oversampling_factor(n: int) -> int:
    """Paper §4.7: alpha = 0.2 * log2(n), at least 1."""
    return max(1, int(0.2 * math.log2(max(n, 2))))


def sample_indices(
    gen: torch.Generator, num: int, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """Uniform sample positions (..., num) in [lo, hi) for each (lo, hi);
    an empty range clamps to ``lo``, which no element classifies into."""
    u = torch.rand(lo.shape + (num,), generator=gen, device=lo.device)
    return positions_from_uniform(u, lo, hi)


def positions_from_uniform(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The positions (..., num) int64 of :func:`sample_indices` from its
    drawn float32 uniforms ``u`` (..., num): ``lo + floor(u * size)`` in
    float32 (size = max(hi - lo, 1), rounded to float32 as torch's mul
    rounds it), clamped to [lo, max(hi - 1, lo)].  The G6 kernel maps its
    uniforms by the same arithmetic."""
    lo64 = lo.to(torch.int64).unsqueeze(-1)
    hi64 = hi.to(torch.int64).unsqueeze(-1)
    size = torch.clamp(hi64 - lo64, min=1)
    idx = lo64 + torch.floor(u * size).to(torch.int64)
    return torch.minimum(torch.maximum(idx, lo64), torch.maximum(hi64 - 1, lo64))


def select_splitters(sorted_sample: torch.Tensor, k: int) -> torch.Tensor:
    """Pick k-1 equidistant splitters from a sorted sample (..., m): the
    ``clip(j m // k, 0, m-1)``-th values, j = 1..k-1, the index made on the
    sample's device."""
    m = sorted_sample.shape[-1]
    idx = torch.arange(1, k, dtype=torch.int64, device=sorted_sample.device) * m // k
    return torch.index_select(sorted_sample, -1, idx.clamp_(0, m - 1))


def splitters_from_histogram(
    candidates: torch.Tensor, cum_counts: torch.Tensor, k: int, total: torch.Tensor
) -> torch.Tensor:
    """Re-split rule (DESIGN.md §8): k-1 splitters from observed key ranks.

    ``candidates`` is a sorted (m,) set of candidate splitter values and
    ``cum_counts[j]`` the *observed* number of keys strictly below
    ``candidates[j]`` (a global histogram, not a sample estimate).  The
    returned splitters are the candidates whose observed ranks best match
    the equidistant target ranks ``i * total / k``.  ``total`` is a 0-d
    tensor; the target arithmetic never forms ``total * (k-1)``, which
    overflows int32 in the reference, whose arithmetic this keeps.

    >>> c = torch.tensor([10, 20, 30, 40])
    >>> splitters_from_histogram(c, torch.tensor([0, 10, 80, 90]), 4, torch.tensor(100)).tolist()
    [30, 30, 30]
    """
    i = torch.arange(1, k, dtype=torch.int64, device=candidates.device)
    total = total.to(torch.int64)
    target = (total // k) * i + ((total % k) * i) // k
    j = torch.searchsorted(cum_counts.to(torch.int64).contiguous(), target, side="left")
    j = torch.clamp(j, 0, candidates.shape[0] - 1)
    return candidates[j]
