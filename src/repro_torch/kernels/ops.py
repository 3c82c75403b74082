"""Public wrappers around the port's kernels.

Counterpart of ``repro.kernels.ops``; this slice ports
``base_case_windows``, the overlapped-window base case on top of K3.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.bitonic import sort_windows

__all__ = ["base_case_windows"]


def base_case_windows(
    arrays: Dict[str, torch.Tensor], fb: torch.Tensor, W: int, nb: int
) -> Dict[str, torch.Tensor]:
    """The two overlapped segmented window-sort passes (DESIGN.md §4.3).

    ``arrays`` maps names to tensors of leading dim n (a multiple of W); its
    ``"k"`` entry holds the encoded keys and ``fb`` (n,) int32 the bucket id
    in [0, nb) of every position.  Pass one sorts the windows at offset 0,
    pass two those at W/2 over the n - W elements between.  K3 gives each
    window's permutation; every tensor is gathered by it in torch.  Returns
    new tensors: the inputs are left as they were.
    """
    n = fb.shape[0]

    def one_pass(arrays, fb, lo, hi, out):
        m = hi - lo
        rows = m // W
        perm, fb_sorted = sort_windows(
            fb[lo:hi].view(rows, W), arrays["k"][lo:hi].view(rows, W), nb
        )
        starts = torch.arange(rows, dtype=torch.int64, device=fb.device) * W + lo
        src = (perm.to(torch.int64) + starts[:, None]).reshape(-1)
        if out is None:  # the first pass covers [0, n) and makes the copies
            return {name: a[src] for name, a in arrays.items()}, fb_sorted.reshape(-1)
        for name, a in arrays.items():
            out[name][lo:hi] = a[src]
        fb[lo:hi] = fb_sorted.reshape(-1)
        return out, fb

    arrays, fb = one_pass(arrays, fb, 0, n, None)
    if n > W:  # offset pass: windows at W/2 (the ends need no second pass)
        arrays, fb = one_pass(arrays, fb, W // 2, n - W // 2, arrays)
    return arrays
