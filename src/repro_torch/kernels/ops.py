"""Public wrappers around the port's kernels.

Counterpart of ``repro.kernels.ops``; this port has ``base_case_windows``,
the overlapped-window base case on top of K3, for one row or B rows and
over a prefix of each row, ``moe_group_tokens``, the expert-major
grouping of MoE tokens on top of K6, and ``sort_blocks``, the in-place block
grouping on top of K8.  It re-exports ``classify_histogram`` (K7),
``permute_blocks_inplace`` (K9), ``flash_decode`` (K10) and
``flash_attention`` (K11), as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.partition import partition_blocks
from repro_torch.kernels import dispatch_rank
from repro_torch.kernels.bitonic import sort_windows
from repro_torch.kernels.classify import classify_histogram
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.glue import gather_windows
from repro_torch.kernels.permute_inplace import permute_blocks_inplace

__all__ = [
    "classify_histogram",
    "permute_blocks_inplace",
    "flash_attention",
    "flash_decode",
    "sort_blocks",
    "base_case_windows",
    "moe_group_tokens",
]


def sort_blocks(
    a: torch.Tensor, block_bucket: torch.Tensor, *, k: int, block_elems: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group the homogeneous blocks of ``a`` by bucket: the one-tensor form
    of ``core.partition.partition_blocks`` (in place by K8 when ``a`` is a
    whole number of blocks of a multiple of 128 elements).  Returns
    (grouped tensor, (k+1,) int32 block-boundary offsets)."""
    out, d = partition_blocks({"k": a}, block_bucket, k, block_elems)
    return out["k"], d


def _window_runs(fb_w: torch.Tensor) -> torch.Tensor:
    """Each window's (row's) run index: the number of bucket changes since
    the window's first position, (num_w, W) int32 in [0, W)."""
    change = torch.zeros_like(fb_w)
    change[:, 1:] = fb_w[:, 1:] != fb_w[:, :-1]
    return torch.cumsum(change, 1, dtype=torch.int32)


def base_case_windows(
    arrays: Dict[str, torch.Tensor], fb: torch.Tensor, W: int, nb: int,
    limit: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """The two overlapped segmented window-sort passes (DESIGN.md §4.3).

    ``fb`` holds the bucket id in [0, nb) of every position, nondecreasing
    along each row (the partition's output), as (n,) int32 for one row or
    (B, n) for B rows; every tensor of ``arrays`` has the same leading dims,
    and its ``"k"`` entry holds the encoded keys.  n is a multiple of W, so
    windows never straddle rows: pass one sorts the B * (n/W) windows at
    offset 0, pass two those at W/2 over the n - W positions between (per
    row).  ``limit`` (a multiple of W) restricts both passes to the
    positions [0, limit) of each row; the rest is left as it was.  K3 gives
    each window's permutation; every tensor is gathered by it with G4's
    window gather (``kernels.glue.gather_windows``, one launch a pass for
    every tensor; each window staged in shared memory before it is
    written, pass two in place).  Returns new tensors: the inputs are left as they were.

    K3 packs (bucket, key, idx) into 64 bits, so it takes ids below
    2^(32 - log2 W).  Above that (a segmented sort of many segments), it is
    handed each window's run index (:func:`_window_runs`) in place of the
    bucket id: the ids do not decrease, so the two order the window alike,
    and a window of W keys holds at most W runs, which always fits.
    """
    one_row = fb.dim() == 1
    if one_row:
        fb = fb[None]
        arrays = {name: a[None] for name, a in arrays.items()}
    B, n = fb.shape
    m_all = n if limit is None else limit
    fits = nb <= 1 << (32 - (W.bit_length() - 1))  # K3's bucket field

    def one_pass(arrays, lo, hi, out):
        per_row = (hi - lo) // W
        fb_w = fb[:, lo:hi].reshape(B * per_row, W)
        perm, _ = sort_windows(
            fb_w.contiguous() if fits else _window_runs(fb_w),
            arrays["k"][:, lo:hi].reshape(B * per_row, W).contiguous(), nb if fits else W,
        )
        # a first pass over all of [0, n) makes the copies (out None)
        return gather_windows(arrays, perm, lo, out)

    # a window's sort leaves its (nondecreasing) bucket ids where they were
    if m_all == n:
        out = one_pass(arrays, 0, n, None)
    else:
        out = one_pass(arrays, 0, m_all, {name: a.clone() for name, a in arrays.items()})
    if m_all > W:  # offset pass: windows at W/2 (the ends need no second pass)
        out = one_pass(out, W // 2, m_all - W // 2, out)
    return {name: a[0] for name, a in out.items()} if one_row else out


def moe_group_tokens(
    expert_id: torch.Tensor,
    tokens: torch.Tensor,
    num_experts: int,
    *,
    tile: int = dispatch_rank.TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group tokens expert-major with the dispatch-rank kernel K6.

    ``expert_id`` (n,) int32 in [0, num_experts) and ``tokens`` (n, ...) on
    one device.  Returns (grouped tokens, (E+1,) int32 offsets, dest (n,)
    int32): ``grouped[dest[i]] == tokens[i]``, each expert's tokens in their
    input order.
    """
    expert_id = expert_id.to(torch.int32).contiguous()
    hist = torch.bincount(expert_id, minlength=num_experts)
    start = torch.zeros(num_experts + 1, dtype=torch.int32, device=expert_id.device)
    start[1:] = torch.cumsum(hist, 0, dtype=torch.int32)
    dest = dispatch_rank.dispatch_ranks(expert_id, start[:-1], num_experts=num_experts,
                                        tile=tile)
    grouped = torch.zeros_like(tokens)
    grouped[dest.to(torch.int64)] = tokens
    return grouped, start, dest
