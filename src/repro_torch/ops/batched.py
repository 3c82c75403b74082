"""Batch-axis sort ops: (B, n) rows sorted in one pipeline (DESIGN.md §6).

Counterpart of ``repro.ops.batched``.  Its callers carry a batch dimension
(per-layer MoE routing ids, the serve scheduler's admission queues,
per-shard length argsorts), and these entry points run the whole pipeline
over all B rows at once: per-row samples, kernel K4 ``level_fused_batched``
at level 1, K4 ``rank_hist_batched`` at level 2 and the base-case windows
of every row in one K3 launch per pass.  Per row each result is
bit-identical to the 1-D op on that row, and to the reference's.

Keys are bijected through ``ops.keyspace`` first, so NaN and -0.0 are
handled as by ``ops.sort``.  Every stage is stable, so ``batched_argsort``
is the stable per-row argsort (the reference's pipeline is stable too,
although its docstring promises less) and the top/bottom-k keep equal
keys in input order.  ``classifier="learned"`` runs K4
``rank_hist_batched`` at level 1 over the model's ids; "auto" resolves
against the caller's (B, n, dtype) (``with_engine_batched``).
The keys are encoded and padded, with the index payload, by one G5 launch
(``ops.sort.sorted_codes``).
``device=None`` means ``"cuda"`` and raises without a card;
``device="cpu"`` runs the kernels' plain twins.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.ips4o import (
    SortConfig,
    base_case_with_fallback,
    batched_partition_passes,
    batched_stable_full_sort,
    plan_levels,
)
from repro_torch.kernels import codec
from repro_torch.ops import keyspace
from repro_torch.ops.sort import Device, _device, _keys, _override, padded_codes, sorted_codes
from repro_torch.ops.topk import _prefix_limit

__all__ = [
    "batched_sort",
    "batched_argsort",
    "batched_topk",
    "batched_bottomk",
    "with_engine_batched",
]


def with_engine_batched(
    cfg: SortConfig,
    engine: Optional[str] = None,
    keys: Optional[torch.Tensor] = None,
    classifier: Optional[str] = None,
) -> SortConfig:
    """The batched ``ops.sort.with_engine``: ``classifier`` in place of
    ``cfg.classifier`` (None keeps it), and "auto" resolved against the
    caller's (B, n, dtype) when ``keys`` is given, the shape the plan cache
    keys batched races under.  ``engine`` must be None: the port has no
    engine switch.

    >>> with_engine_batched(SortConfig(), classifier="radix").classifier
    'radix'
    """
    if keys is None:
        return _override(cfg, engine, classifier)
    B, n = keys.shape
    return _override(cfg, engine, classifier, n, keys.dtype, B)


def batched_sort(
    keys,
    values: Any = None,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
):
    """Sort each row of ``keys`` (B, n) ascending, NaN-safe, optionally
    moving a ``values`` pytree (leaves with leading dims (B, n)) alongside,
    row by row.

    >>> batched_sort(torch.tensor([[3.0, 1.0, 2.0], [0.0, 5.0, -1.0]]), device="cpu").tolist()
    [[1.0, 2.0, 3.0], [-1.0, 0.0, 5.0]]
    """
    dev = _device(device)
    keys = _keys(keys, dev, dim=2)
    cfg = with_engine_batched(cfg, None, keys, classifier)
    codes, _, vs = sorted_codes(keys, cfg, values)
    out = keyspace.decode(codes[:, :keys.shape[1]], keys.dtype)
    return out if values is None else (out, vs)


def batched_argsort(
    keys,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> torch.Tensor:
    """Per-row int32 indices that sort ``keys`` (B, n) ascending, stably.

    >>> batched_argsort(torch.tensor([[30, 10, 20]], dtype=torch.int32), device="cpu").tolist()
    [[1, 2, 0]]
    """
    dev = _device(device)
    keys = _keys(keys, dev, dim=2)
    B, n = keys.shape
    if n <= 1:
        return torch.arange(n, dtype=torch.int32, device=dev).expand(B, n).contiguous()
    cfg = with_engine_batched(cfg, None, keys, classifier)
    _, order, _ = sorted_codes(keys, cfg, index=True)
    return order[:, :n]


def _batched_smallest_padded(arrays, n: int, kk: int, cfg: SortConfig):
    """Per row, (the kk smallest codes ascending, their indices) from padded
    (B, n_pad) codes "k" and index "v" of n real positions a row: the
    batched ``ops.topk._smallest_padded``.  One prefix P covers the
    rank-(kk-1) bucket of every row, so the base case runs over [0, P) of
    each row only."""
    n_pad = arrays["k"].shape[1]
    levels = plan_levels(n_pad, cfg)
    if not levels:
        arrays = batched_stable_full_sort(arrays)
    else:
        arrays, offsets, nb, pad_bucket = batched_partition_passes(arrays, n, cfg, levels)
        P = _prefix_limit(kk, cfg.base_case, n_pad)
        arrays = base_case_with_fallback(arrays, offsets, nb, pad_bucket, cfg, limit=P)
    return arrays["k"][:, :kk], arrays["v"][:, :kk]


def _batched_partial(keys, k, cfg, classifier, device, largest: bool):
    dev = _device(device)
    keys = _keys(keys, dev, dim=2)
    B, n = keys.shape
    kk = max(0, min(int(k), n))
    cfg = with_engine_batched(cfg, None, keys, classifier)
    if kk == 0 or B == 0:
        return keys[:, :kk], torch.zeros((B, kk), dtype=torch.int32, device=dev)
    # G5: the (complemented) codes and the index, padded, in one launch
    codes, idx, _ = padded_codes(keys, cfg, index=True, complement=largest)
    out, idx = _batched_smallest_padded({"k": codes, "v": idx}, n, kk, cfg)
    if largest:
        return codec.decode(out, keys.dtype, complement=True), idx
    return keyspace.decode(out, keys.dtype), idx


def batched_bottomk(
    keys,
    k: int,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: the ``k`` smallest keys ascending, with their int32 indices,
    each (B, min(k, n)).

    >>> v, i = batched_bottomk(torch.tensor([[4.0, 1.0, 3.0], [9.0, 8.0, 7.0]]), 2,
    ...                        device="cpu")
    >>> v.tolist(), i.tolist()
    ([[1.0, 3.0], [7.0, 8.0]], [[1, 2], [2, 1]])
    """
    return _batched_partial(keys, k, cfg, classifier, device, largest=False)


def batched_topk(
    keys,
    k: int,
    *,
    cfg: SortConfig = SortConfig(),
    classifier: Optional[str] = None,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: the ``k`` largest keys descending, with their int32 indices
    (the bottom-k of the complemented codes).

    >>> v, i = batched_topk(torch.tensor([[1.0, 9.0, 3.0], [7.0, 2.0, 5.0]]), 2,
    ...                     device="cpu")
    >>> v.tolist(), i.tolist()
    ([[9.0, 3.0], [7.0, 5.0]], [[1, 2], [0, 2]])
    """
    return _batched_partial(keys, k, cfg, classifier, device, largest=True)
