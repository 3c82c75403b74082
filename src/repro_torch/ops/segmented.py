"""Batched independent-segment sort via the segmented level pass.

Counterpart of ``repro.ops.segmented``.  ``segmented_sort`` sorts each
``keys[offsets[i]:offsets[i+1]]`` range on its own: it is recursion level 2
of the full sort (``core.ips4o.segmented_level_pass``) promoted to a public
op — per-segment splitters, the flattened classification, composite bucket
ids ``seg * 2k + local`` (monotone in the segment) placed by kernel K2,
then the shared base case (kernel K3) over all segments' windows.  Pads go
into an extra trailing segment.  The robustness fallback is the port's:
it stably sorts only the buckets above W/2 (the reference sorts everything
by (segment, key)); the result is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.ips4o import (
    SortConfig,
    _pad_to,
    _payload,
    base_case_with_fallback,
    segmented_level_pass,
)
from repro_torch.ops import keyspace
from repro_torch.ops.sort import Device, _device, _keys, padded_codes

__all__ = ["segmented_sort"]


def _pow2_clamp(x: int, lo: int, hi: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return max(lo, min(p, hi))


def segmented_sort(
    keys,
    offsets,
    num_segments: int,
    values: Any = None,
    *,
    k: Optional[int] = None,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
):
    """Sort each segment of ``keys`` (n,) independently, ascending, NaN-safe.

    ``offsets`` (num_segments + 1,) are nondecreasing int segment boundaries
    with offsets[0] == 0 and offsets[-1] == n; ``values`` (a pytree of
    leaves with leading dim n) moves alongside, per segment.  ``k`` is the buckets per
    segment (a power of two; by default sized to the average segment).
    ``classifier`` is accepted for symmetry with ``sort``, but every value
    maps to "tree", as in the reference: user segments are arbitrary key
    ranges, which the radix bits are not monotone within.  Any number of
    segments works whose composite ids fit int32 ((segments + 1) * 2k <
    2^31): past K3's bucket field (2^19 ids at W = 8192) the base case
    hands K3 window-local run indices in place of the composite ids.

    Returns sorted keys, or (keys, values).

    >>> keys = torch.tensor([3.0, 1.0, 2.0, 2.0, 0.0])
    >>> segmented_sort(keys, torch.tensor([0, 3, 5]), 2, device="cpu").tolist()
    [1.0, 2.0, 3.0, 0.0, 2.0]
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    cfg = dataclasses.replace(cfg, classifier="tree")
    n = keys.shape[0]
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int32)
    if offsets.shape != (num_segments + 1,):
        raise ValueError(f"offsets: expected ({num_segments + 1},), got {tuple(offsets.shape)}")
    if n <= 1:
        return keys if values is None else (keys, values)

    W = cfg.base_case
    codes, _, n_pad = padded_codes(keys, cfg)  # G5: encoded and padded in one launch
    arrays = {"k": codes}
    del codes  # the level pass frees the codes once it has moved them
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(_pad_to(payload, n_pad, 0))
    # pads form one extra trailing segment; their sentinel keys make its
    # buckets equality buckets, which the base case leaves alone
    off_ext = torch.cat([offsets, torch.full((1,), n_pad, dtype=torch.int32, device=dev)])
    if k is None:
        avg = max(1, n // max(num_segments, 1))
        k = _pow2_clamp(-(-cfg.slack * avg // W), 2, cfg.kmax)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    arrays, boffs, nb = segmented_level_pass(arrays, off_ext, num_segments + 1, n_pad, k, cfg,
                                             gen)
    arrays = base_case_with_fallback(arrays, boffs, nb, None, cfg)
    out = keyspace.decode(arrays["k"][:n], keys.dtype)
    return out if values is None else (out, rebuild(arrays, n))
