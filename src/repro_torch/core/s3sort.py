"""s3-sort: the out-of-place Super Scalar Samplesort baseline [Sanders &
Winkel 2004].

Counterpart of ``repro.core.s3sort``: the paper's closest non-in-place
competitor, with the same tree classifier but the out-of-place distribution
the paper criticizes (§4.5, Appendix B):

  * an explicit **oracle array** of bucket ids is materialized;
  * the elements are scattered into **freshly allocated** tensors
    (``core.ref.ref_partition``), so ~2n stays live on the device: the
    yardstick for the in-place block move (``core.partition.partition_blocks``);
  * each bucket is then finished by a stable (bucket, key) sort, two stable
    ``torch.sort`` calls, as the reference uses XLA's sort there.

It runs no kernel of its own, and takes keys of every dtype of the
keyspace (8/16/32/64-bit ints and uints, float16, bfloat16, float32,
float64); uint16, uint32 and uint64 keys, whose torch dtypes lack ``>``
and ``searchsorted``, run as their order-preserving signed views
(``sampling.ordered_view``).  The output is the stable sort of the raw
keys (``torch.sort(stable=True)``): NaN last, -0.0 and +0.0 tied in input
order.  The reference's classification sends NaN to bucket 0 and +inf
below a key equal to ``finfo.max``, so with NaN or infinite keys its output
is not sorted and depends on its sample (ROADMAP.md, queue 3); here NaN
goes to the top equality bucket and the last upper of float keys is +inf,
which keeps the buckets in ``torch.sort``'s order.  Without NaN and inf the
two agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sampling
from repro_torch.core.ips4o import SortConfig, plan_levels
from repro_torch.core.ref import ref_partition

__all__ = ["s3_sort"]

def _oracle(keys: torch.Tensor, splitters: torch.Tensor, k: int) -> torch.Tensor:
    """Tree ids 2j + eq of raw keys against sorted splitters (NaN last),
    monotone in ``torch.sort``'s order: NaN keys take the top id 2k-1."""
    j = torch.searchsorted(splitters, keys)  # splitters below the key
    floating = keys.dtype.is_floating_point
    top = float("inf") if floating else sampling.sentinel_for(keys.dtype)
    upper = torch.cat([splitters, torch.full((1,), top, dtype=keys.dtype,
                                             device=keys.device)])
    ids = 2 * j + (keys == upper[j])
    if floating:
        ids = torch.where(torch.isnan(keys), 2 * k - 1, ids)
    return ids.to(torch.int32)


def s3_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
            cfg: SortConfig = SortConfig()):
    """Out-of-place samplesort baseline of ``keys`` (n,) of any keyspace
    dtype: one distribution level, then a stable (bucket, key) sort.
    ``values`` (n, ...) moves with the keys.  Returns the sorted keys, or
    (keys, values).
    """
    from repro_torch.ops import keyspace  # lazy: ops layers on core

    keyspace.key_bits(keys.dtype)  # raises for dtypes with no order (the reference's too)
    n = keys.shape[0]
    if n <= 1:
        return keys if values is None else (keys, values)
    dtype = keys.dtype
    keys = sampling.ordered_view(keys)
    arrays = {"k": keys}
    if values is not None:  # moved as the signed int of its width
        arrays["v"] = sampling.signed_payload(values)
    levels = plan_levels(n, cfg)
    if not levels:
        order = torch.sort(keys, stable=True).indices
        return _result({name: a[order] for name, a in arrays.items()}, dtype, values)

    k = levels[0]
    m = min(max(sampling.oversampling_factor(n) * k, k), cfg.max_sample, n)
    gen = torch.Generator(device=keys.device).manual_seed(cfg.seed)
    pos = torch.randint(0, n, (m,), generator=gen, device=keys.device)
    splitters = sampling.select_splitters(torch.sort(keys[pos]).values, k)
    oracle = _oracle(keys, splitters, k)  # the materialized oracle array
    out, offsets = ref_partition(oracle, arrays, 2 * k)  # out of place
    seg = torch.searchsorted(offsets, torch.arange(n, dtype=torch.int32, device=keys.device),
                             right=True) - 1
    o1 = torch.sort(out["k"], stable=True).indices
    o2 = torch.sort(seg[o1], stable=True).indices
    order = o1[o2]
    return _result({name: a[order] for name, a in out.items()}, dtype, values)


def _result(out, dtype, values):
    keys = sampling.from_ordered_view(out["k"], dtype)
    return keys if values is None else (keys, out["v"].view(values.dtype))
