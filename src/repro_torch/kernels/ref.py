"""Plain torch oracles for the port's block and classification kernels.

Counterpart of two of ``repro.kernels.ref``'s oracles:
``classify_histogram_ref`` (``ref.py:21``) and ``permute_blocks_ref``
(``ref.py:48``).  The tests hold K7 and K9 to them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.classify import classify

__all__ = ["classify_histogram_ref", "permute_blocks_ref"]


def classify_histogram_ref(keys: torch.Tensor, splitters: torch.Tensor, *, k: int,
                           rows: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: the tree classifier (``classify.classify``) + a per-tile
    bincount over tiles of rows * 128 keys."""
    bucket = classify(keys, splitters, k)
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
