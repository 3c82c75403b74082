"""Splitter-based partial sort: top-k and bottom-k cheaper than a full sort.

Counterpart of ``repro.ops.topk``.  After the level passes the buckets are
contiguous and in key order, so the k smallest keys lie in the prefix that
ends with the bucket of rank k-1.  The base case (and the robustness
fallback) run only over the static, W-aligned prefix

    P = ceil((k + W) / W) * W        (W = cfg.base_case),

which covers that bucket whenever every non-trivial bucket holds at most
W/2 keys; the fallback, restricted to the buckets that start below P,
guards that.  The entry points encode, complement and pad the keys and
write the index payload in one G5 launch (``ops.sort.padded_codes``).
``topk`` is the bottom-k of the complemented codes: ``~``
reverses the signed order of the port's codes just as it reverses
the reference's unsigned order.  Ties keep their input order, so both
agree with the reference bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.classify import resolve_classifier
from repro_torch.core.ips4o import (
    SortConfig,
    base_case_with_fallback,
    partition_passes,
    plan_levels,
    stable_full_sort,
)
from repro_torch.kernels import codec
from repro_torch.ops import keyspace
from repro_torch.ops.sort import Device, _device, _keys, padded_codes, with_engine

__all__ = ["topk", "bottomk", "smallest_encoded"]


def _prefix_limit(k: int, W: int, n_pad: int) -> int:
    """Static W-aligned prefix length covering the bucket of rank k-1."""
    return min(n_pad, -(-(k + W) // W) * W)


def smallest_encoded(
    enc: torch.Tensor, kk: int, cfg: SortConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the kk smallest encoded int32/int64 keys ascending, their int32 indices)
    of ``enc`` (n,), with 0 < kk <= n; ties keep their input order."""
    resolve_classifier(cfg.classifier)
    codes, idx, _ = padded_codes(enc, cfg, index=True)  # G5: the pad and the index
    return _smallest_padded({"k": codes, "v": idx}, enc.shape[0], kk, cfg)


def _smallest_padded(arrays, n: int, kk: int, cfg: SortConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`smallest_encoded` from padded codes "k" and index "v" (n_pad,)
    of n real positions."""
    n_pad = arrays["k"].shape[0]
    levels = plan_levels(n_pad, cfg)
    if not levels:
        arrays = stable_full_sort(arrays)
    else:
        arrays, offsets, nb, pad_bucket = partition_passes(arrays, n, cfg, levels)
        P = _prefix_limit(kk, cfg.base_case, n_pad)
        arrays = base_case_with_fallback(arrays, offsets, nb, pad_bucket, cfg, limit=P)
    return arrays["k"][:kk], arrays["v"][:kk]


def _partial(keys, k, cfg, classifier, device, largest: bool):
    dev = _device(device)
    keys = _keys(keys, dev)
    n = keys.shape[0]
    kk = max(0, min(int(k), n))
    if kk == 0:
        return keys[:0], torch.zeros(0, dtype=torch.int32, device=dev)
    cfg = with_engine(cfg, None, keys, classifier)
    resolve_classifier(cfg.classifier)
    # G5: the (complemented) codes and the index, padded, in one launch
    codes, idx, _ = padded_codes(keys, cfg, index=True, complement=largest)
    with obs.trace("ops.topk" if largest else "ops.bottomk", n=n, k=kk):
        out, idx = _smallest_padded({"k": codes, "v": idx}, n, kk, cfg)
    if largest:
        return codec.decode(out, keys.dtype, complement=True), idx
    return keyspace.decode(out, keys.dtype), idx


def bottomk(
    keys,
    k: int,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest keys ascending, with their int32 indices; each of
    length min(k, n).  NaN is the largest key, so it comes last.

    >>> v, i = bottomk(torch.tensor([4.0, 1.0, 3.0]), 2, device="cpu")
    >>> v.tolist(), i.tolist()
    ([1.0, 3.0], [1, 2])
    """
    return _partial(keys, k, cfg, classifier, device, largest=False)


def topk(
    keys,
    k: int,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest keys descending, with their int32 indices (the
    ``jax.lax.top_k`` contract, NaNs first; equal keys in input order).

    >>> v, i = topk(torch.tensor([1.0, 9.0, 3.0, 7.0]), 2, device="cpu")
    >>> v.tolist(), i.tolist()
    ([9.0, 7.0], [1, 3])
    """
    return _partial(keys, k, cfg, classifier, device, largest=True)
