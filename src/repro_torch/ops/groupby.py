"""Sort-derived grouping ops: unique / run_length / group_by.

Counterpart of ``repro.ops.groupby``: "sort plus boundary extraction"
(DESIGN.md §5.3).  The per-group outputs (``unique`` values and counts,
run lengths) come back padded to n with a count of the valid prefix, as in
the reference; the padding holds what the reference's holds (the zero code
and zero counts), so the whole outputs agree.

``group_by`` keeps the reference's ``method`` values:
  * ``"partition"`` and ``"pallas"`` — keys are ints in [0, num_groups):
    the stable counting placement, kernel K6, behind
    ``core.partition.partition_ranks_kernel`` (``"partition"``, the MoE
    dispatch path) or ``kernels.dispatch_rank.dispatch_ranks``
    (``"pallas"``).  The port has one engine, so both launch the same K6
    kernel on a card and its plain twin on the CPU; they differ only in
    the launch counter.  Above K6's 4096 counters (``MAX_NB``) both take
    ``partition_ranks_kernel``'s two K6 passes, up to 2^24 groups;
  * ``"sort"`` — arbitrary keys: ``ips4o_sort`` of the encoded keys with
    their positions, then a boundary scan;
  * ``"auto"`` — ``"partition"`` with ``num_groups``, else ``"sort"``.

Every function takes ``device=None`` (the card) like ``ops.sort``;
``device="cpu"`` runs the plain twins, and with no card they raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.ips4o import SortConfig, ips4o_sort
from repro_torch.core.partition import partition_ranks_kernel
from repro_torch.kernels.dispatch_rank import MAX_NB, TILE, dispatch_ranks
from repro_torch.ops import keyspace
from repro_torch.ops.sort import Device, _device, _keys

__all__ = ["Groups", "group_by", "unique", "run_length"]

METHODS = ("auto", "partition", "pallas", "sort")


class Groups(NamedTuple):
    """Result of :func:`group_by`; positions are grouped key-ascending."""

    keys: torch.Tensor                # (n,) grouped keys
    values: Any                       # grouped payload pytree (None if not given)
    group_ids: torch.Tensor           # (n,) int32 group index of each grouped position
    counts: torch.Tensor              # (num_groups,) exact, or (n,) padded for "sort"
    num_groups: Union[int, torch.Tensor]  # int, or a 0-d int32 tensor for "sort"
    perm: torch.Tensor                # (n,) int32 source index of each grouped position


def _boundaries(enc_sorted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group id per position (n,) int32, number of groups (0-d int32)) of
    non-empty sorted (or run-structured) encoded keys."""
    head = torch.ones_like(enc_sorted, dtype=torch.bool)
    head[1:] = enc_sorted[1:] != enc_sorted[:-1]
    gid = torch.cumsum(head, 0, dtype=torch.int32) - 1
    return gid, gid[-1] + 1


def _compact(enc: torch.Tensor, gid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first code of each group, group sizes), both padded to n; the
    padding is the reference's unsigned zero code, which is the code
    dtype's min for every key dtype (narrow codes are left-aligned)."""
    n = enc.shape[0]
    g64 = gid.to(torch.int64)
    vals = torch.full((n,), torch.iinfo(enc.dtype).min, dtype=enc.dtype, device=enc.device)
    vals[g64] = enc  # every position of a group holds the same code
    counts = torch.zeros(n, dtype=torch.int32, device=enc.device)
    counts.index_add_(0, g64, torch.ones_like(gid))
    return vals, counts


def _int_group_perm(
    keys: torch.Tensor, num_groups: int, method: str, tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, offsets (num_groups+1,)) grouping int keys in [0, num_groups),
    stably, by the counting placement K6 (two passes above ``MAX_NB``)."""
    n = keys.shape[0]
    b = keys.to(torch.int32).contiguous()
    counts = torch.bincount(b, minlength=num_groups).to(torch.int32)
    offsets = torch.zeros(num_groups + 1, dtype=torch.int32, device=b.device)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    if method == "pallas" and num_groups <= MAX_NB:
        dest = dispatch_ranks(b, offsets[:-1], num_experts=num_groups, tile=tile)
    else:
        dest = partition_ranks_kernel(b, offsets, num_groups, tile=tile)
    perm = torch.empty(n, dtype=torch.int32, device=b.device)
    perm[dest.to(torch.int64)] = torch.arange(n, dtype=torch.int32, device=b.device)
    return perm, offsets


def _gather_values(values: Any, perm: torch.Tensor, n: int, dev: torch.device) -> Any:
    """Every leaf of a ``values`` pytree (leading dim n) gathered by
    ``perm``; ``None`` leaves stay ``None`` (an empty subtree, as in
    ``jax.tree``)."""
    p64 = perm.to(torch.int64)

    def take(leaf):
        if leaf is None:
            return None
        t = torch.as_tensor(leaf, device=dev)
        if t.shape[:1] != (n,):
            raise ValueError(f"payload leaf of shape {tuple(t.shape)}: its leading dim "
                             f"must be {n}")
        return t[p64]

    return pytree.tree_map(take, values, is_leaf=lambda x: x is None)


def group_by(
    keys,
    values: Any = None,
    *,
    num_groups: Optional[int] = None,
    method: str = "auto",
    tile: int = TILE,
    cfg: SortConfig = SortConfig(),
    device: Device = None,
) -> Groups:
    """Group elements by key, key-ascending, stably within a group.

    With ``num_groups`` (keys are ints in [0, num_groups)) the grouping is
    the stable counting placement, K6 (``tile`` ids per ticket; by default
    K6's own, where the reference's 2048 is a TPU tile; it never changes the
    result), and ``counts``/``num_groups`` are exact.  Without it, keys are
    of any ``ops.keyspace`` dtype (``method="sort"``): a NaN-safe sort groups equal keys,
    ``counts`` comes back (n,)-padded and ``num_groups`` is a 0-d tensor.
    ``values`` (a pytree of leaves with leading dim n) is grouped alongside.

    >>> g = group_by(torch.tensor([2, 0, 2, 1]), num_groups=3, device="cpu")
    >>> g.keys.tolist(), g.counts.tolist(), g.perm.tolist()
    ([0, 1, 2, 2], [1, 1, 2], [1, 3, 0, 2])
    """
    dev = _device(device)
    if method not in METHODS:
        raise ValueError(f"unknown group_by method {method!r}; expected one of {METHODS}")
    if method == "auto":
        method = "partition" if num_groups is not None else "sort"
    if method in ("partition", "pallas"):
        if num_groups is None:
            raise ValueError(f"method={method!r} requires num_groups")
        keys = torch.as_tensor(keys, device=dev)
        if keys.dim() != 1 or keys.dtype.is_floating_point or keys.dtype == torch.bool:
            raise ValueError(f"method {method!r} takes 1-D integer keys in [0, num_groups)")
    else:
        keys = _keys(keys, dev)
    n = keys.shape[0]
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    if method != "sort":
        if n == 0:
            return Groups(keys, values, empty,
                          torch.zeros(num_groups, dtype=torch.int32, device=dev), num_groups,
                          empty)
        perm, offsets = _int_group_perm(keys, num_groups, method, tile)
        p64 = perm.to(torch.int64)
        gk = keys[p64]
        return Groups(keys=gk, values=None if values is None else
                      _gather_values(values, perm, n, dev),
                      group_ids=gk.to(torch.int32), counts=torch.diff(offsets),
                      num_groups=num_groups, perm=perm)
    if n == 0:
        return Groups(keys, values, empty, empty, torch.zeros((), dtype=torch.int32, device=dev),
                      empty)
    enc = keyspace.encode(keys)
    enc_sorted, perm = ips4o_sort(enc, torch.arange(n, dtype=torch.int32, device=dev), cfg=cfg)
    gid, num = _boundaries(enc_sorted)
    _, counts = _compact(enc_sorted, gid)
    return Groups(keys=keyspace.decode(enc_sorted, keys.dtype),
                  values=None if values is None else _gather_values(values, perm, n, dev),
                  group_ids=gid, counts=counts, num_groups=num, perm=perm)


def unique(
    keys, *, cfg: SortConfig = SortConfig(), device: Device = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distinct keys, ascending.  Returns (values, counts, num_unique):
    ``values``/``counts`` are (n,)-padded, valid for the first
    ``num_unique`` entries.  NaN is one class; -0.0 and +0.0 are two.

    >>> vals, counts, num = unique(torch.tensor([3, 1, 3, 1, 1], dtype=torch.int32),
    ...                            device="cpu")
    >>> int(num), vals[:2].tolist(), counts[:2].tolist()
    (2, [1, 3], [3, 2])
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    if keys.shape[0] == 0:
        return (keys, torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    enc_sorted = ips4o_sort(keyspace.encode(keys), cfg=cfg)
    gid, num = _boundaries(enc_sorted)
    vals, counts = _compact(enc_sorted, gid)
    return keyspace.decode(vals, keys.dtype), counts, num


def run_length(
    keys, *, cfg: SortConfig = SortConfig(), device: Device = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encoding of *consecutive* equal keys (no sorting).
    Returns (values, lengths, num_runs), (n,)-padded like :func:`unique`;
    equality is keyspace equality (NaN == NaN, -0.0 != +0.0).  ``cfg`` is
    accepted for symmetry with :func:`unique` and ignored, as in the
    reference: nothing is sorted.

    >>> vals, lens, num = run_length(torch.tensor([5, 5, 2, 2, 2, 5], dtype=torch.int32),
    ...                              device="cpu")
    >>> int(num), vals[:3].tolist(), lens[:3].tolist()
    (3, [5, 2, 5], [2, 3, 1])
    """
    dev = _device(device)
    keys = _keys(keys, dev)
    if keys.shape[0] == 0:
        return (keys, torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    enc = keyspace.encode(keys)
    rid, num = _boundaries(enc)  # runs are the "groups" of the unsorted stream
    vals, lengths = _compact(enc, rid)
    return keyspace.decode(vals, keys.dtype), lengths, num
