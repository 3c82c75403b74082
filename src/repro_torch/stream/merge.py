"""Stable k-way merge of sorted runs (DESIGN.md §7.2).

Counterpart of ``repro.stream.merge``.  Keys of every keyspace dtype biject
through ``ops.keyspace`` first, so the merge is NaN-safe (NaNs last, -0.0
before +0.0) with the total order of ``ops.sort``: runs of keys of 32 bits
or fewer merge as left-aligned int32 codes, as the sort does, and 64-bit
runs as int64 codes through K5's 64-bit form.  k runs reduce through a
tournament of pairwise merges, each the K5 merge-path permutation
(``kernels.merge_path.merge_path_perm``) with the payload tensors gathered
through it.  Adjacent pairs merge each round, so ties keep (run, position)
order end to end.  The port has no engine switch: on a CUDA tensor every
pairwise merge launches K5, on a CPU tensor its plain twin runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.sampling import signed_payload
from repro_torch.kernels.merge_path import TILE, merge_path_perm
from repro_torch.ops import keyspace
from repro_torch.stream.runs import key_dtype

__all__ = ["merge", "merge_perm", "merge_runs_encoded"]

Item = Dict[str, torch.Tensor]


def merge_perm(a: torch.Tensor, b: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """Stable-merge permutation (int32) of two sorted runs of encoded int32
    or int64 keys: ``cat(a, b)[perm]`` is the stable merge, ties to ``a``."""
    return merge_path_perm(a, b, tile=tile)


def _merge2(x: Item, y: Item, tile: int) -> Item:
    """One tournament step: merge two items whose "k" tensors are encoded
    sorted runs; every other tensor rides the permutation."""
    if x["k"].shape[0] == 0:
        return y
    if y["k"].shape[0] == 0:
        return x
    perm = merge_perm(x["k"], y["k"], tile=tile).to(torch.int64)
    return {name: torch.cat([x[name], y[name]])[perm] for name in x}


def merge_runs_encoded(items: List[Item], *, tile: int = TILE) -> Item:
    """Tournament-reduce k items (encoded sorted "k" + payload tensors) to
    one; empty runs are absorbed free of charge."""
    if not items:
        raise ValueError("merge of zero runs")
    while len(items) > 1:
        nxt = [_merge2(items[i], items[i + 1], tile) for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def merge(
    runs: Sequence[torch.Tensor],
    values: Optional[Sequence[torch.Tensor]] = None,
    *,
    tile: int = TILE,
):
    """Stable k-way merge of sorted 1-D runs of one keyspace dtype, sorted
    in the keyspace order as ``ops.sort`` leaves them (NaNs last,
    -0.0 before +0.0); ragged lengths, empty runs and k = 1 are fine.
    ``values`` gives one payload tensor per run (leading dim = the run's
    length), merged alongside.  ``tile`` is K5's outputs per CTA (a power of
    two); it never changes the result.

    Returns the merged keys, or ``(keys, values)``: equal to the stable sort
    of the concatenation, ties in (run, position) order.

    >>> merge([torch.tensor([1.0, 3.0]), torch.tensor([2.0, 4.0])]).tolist()
    [1.0, 2.0, 3.0, 4.0]
    >>> k, v = merge([torch.tensor([1, 5], dtype=torch.int32),
    ...               torch.tensor([1, 9], dtype=torch.int32)],
    ...              values=[torch.tensor([10, 11]), torch.tensor([12, 13])])
    >>> (k.tolist(), v.tolist())  # tie on 1: run 0's payload first
    ([1, 1, 5, 9], [10, 12, 11, 13])
    """
    runs = list(runs)
    if not runs:
        raise ValueError("merge of zero runs")
    if values is not None and len(values) != len(runs):
        raise ValueError(f"{len(runs)} runs but {len(values)} payload tensors")
    dtype, dev = runs[0].dtype, runs[0].device
    key_dtype(dtype)  # raises for dtypes with no order (the reference's too)
    for r in runs:
        if r.dim() != 1:
            raise ValueError("runs must be 1-D")
        if r.dtype != dtype:
            raise ValueError(f"mixed run dtypes {dtype} vs {r.dtype}")
        if r.device != dev:
            raise ValueError(f"mixed run devices {dev} vs {r.device}")
    items = []
    for i, r in enumerate(runs):
        item = {"k": keyspace.encode(r).contiguous()}
        if values is not None:
            if values[i].shape[:1] != r.shape:
                raise ValueError(f"payload {i} has leading dim {values[i].shape[:1]}, "
                                 f"run {i} has {r.shape[0]} keys")
            item["v"] = signed_payload(values[i]).to(dev)  # gathered on a card too
        items.append(item)
    out = merge_runs_encoded(items, tile=tile)
    keys = keyspace.decode(out["k"], dtype)
    return keys if values is None else (keys, out["v"].view(values[0].dtype))
