"""The learned-CDF classifier (arXiv 2208.06902, *Towards Parallel Learned
Sorting*), fitted per level pass on the same sample the tree engine uses.

Counterpart of ``repro.classify.learned``.  The whole sorted sample becomes
a monotone piecewise-linear CDF with ``P`` equal-probability segments whose
knots are the sample quantiles

    knots[i] = sample[round(i * (m-1) / P)],   CDF(knots[i]) = i / P,

and a key's bucket is the model's value:

    seg  = |{interior knots <= key}|
    frac = clip((key - knots[seg]) / (knots[seg+1] - knots[seg]), 0, 1)
    j    = clip(floor((seg + frac) / P * k), 0, k-1)

``j`` is monotone in the key, so the stable partition and the base case
hold as for sampled splitters.  Equality buckets follow the radix rule
(odd iff the key is the sentinel).  When the fit's largest predicted bucket
load on its own sample, ``max_j |{model(sample) = j}| * k / m``, exceeds
``IMBALANCE_THRESHOLD``, the tree classifies instead, with splitters from
the same sample.

**The float map.**  The model is evaluated in float32 on the reference's
*unsigned* code of each key, cast once (``_to_float``).  The port's codes
are signed (the reference's code XOR the sign bit, ``ops.keyspace``), so
they are mapped back before the cast: int32 codes as ``code + 2^31`` in
int64, int64 codes as ``code ^ min`` viewed uint64, each rounding the
reference's integer once.  An 8- or 16-bit key's code is left-aligned in
int32 with zero low bits, except the all-ones code, which is the int32
max; ``bits`` (the key's width) recovers the reference's own value,
``(code + 2^31) >> (32 - bits)``, so that code lands on the reference's
float too.  Without ``bits`` the sort's level pass, which sees int32 codes
only, evaluates narrow codes at their 32-bit scale: the buckets then equal
the reference's except about the all-ones code, and the sort's result
never depends on them.

**The fallback.**  The reference picks its branch on the device with
``lax.cond``; here one host read of the sample's imbalance (a scalar of
the small sample, or of every row's sample, batch-wide) picks it.  The
level passes count each pick in ``ROUTES``.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.classify.tree import classify, classify_batched
from repro_torch.core.sampling import sentinel_for

__all__ = [
    "NUM_KNOTS",
    "IMBALANCE_THRESHOLD",
    "ROUTES",
    "fit_cdf_knots",
    "eval_cdf_buckets",
    "sample_imbalance",
    "learned_fit",
    "learned_model_ids",
    "learned_bucket_ids",
    "learned_bucket_ids_batched",
]

NUM_KNOTS = 64  # P, as in the reference
IMBALANCE_THRESHOLD = 3.0  # the sample-measured load factor that reroutes to the tree

# the level passes' picks: "model" (the CDF classified) and "fallback" (the
# tree did); read by chip_smoke.py, reset by the caller
ROUTES: collections.Counter = collections.Counter()


def _to_float(codes: torch.Tensor, bits: Optional[int] = None) -> torch.Tensor:
    """The reference's unsigned code of each signed port code, as float32,
    rounded once (module docstring)."""
    if codes.dtype == torch.int64:
        return (codes ^ torch.iinfo(torch.int64).min).view(torch.uint64).to(torch.float32)
    if codes.dtype != torch.int32:
        raise ValueError(f"the learned classifier takes int32 or int64 codes, got {codes.dtype}")
    wide = codes.to(torch.int64) + (1 << 31)
    if bits is not None and bits < 32:
        wide = wide >> (32 - bits)
    return wide.to(torch.float32)


def fit_cdf_knots(sorted_sample: torch.Tensor, num_knots: int = NUM_KNOTS,
                  bits: Optional[int] = None) -> torch.Tensor:
    """(..., m) sorted sample -> (..., P+1) float32 knots at sample quantiles."""
    m = sorted_sample.shape[-1]
    idx = np.clip(np.round(np.arange(num_knots + 1) * (m - 1) / max(num_knots, 1)),
                  0, m - 1).astype(np.int64)
    picked = torch.index_select(sorted_sample, -1,
                                torch.as_tensor(idx, device=sorted_sample.device))
    return _to_float(picked, bits)


def eval_cdf_buckets(keys: torch.Tensor, knots: torch.Tensor, k: int,
                     bits: Optional[int] = None) -> torch.Tensor:
    """Bucket index j in [0, k) per key, int32: ``keys`` (n,) with knots
    (P+1,), or (B, n) with per-row knots (B, P+1)."""
    P = knots.shape[-1] - 1
    kf = _to_float(keys, bits)
    inner = knots[..., 1:-1].contiguous()
    seg = torch.searchsorted(inner, kf.contiguous(), right=True)
    lo = torch.gather(knots, -1, seg)
    hi = torch.gather(knots, -1, seg + 1)
    # duplicate knots give hi == lo: the segment carries no mass, frac is 0
    span = hi - lo
    pos = span > 0
    frac = torch.clamp(torch.where(pos, (kf - lo) / torch.where(pos, span, 1.0), 0.0), 0.0, 1.0)
    cdf = (seg.to(torch.float32) + frac) / max(P, 1)
    return torch.clamp((cdf * k).to(torch.int32), 0, k - 1)


def sample_imbalance(sorted_sample: torch.Tensor, knots: torch.Tensor, k: int,
                     bits: Optional[int] = None) -> torch.Tensor:
    """Largest predicted bucket load on the training sample, normalised so a
    perfect fit scores 1.0: a float32 scalar for (m,), (B,) for (B, m).
    The sample is sorted and the model monotone, so the ids are sorted and
    each bucket's count is a difference of ranks."""
    m = sorted_sample.shape[-1]
    jb = eval_cdf_buckets(sorted_sample, knots, k, bits)
    edges = torch.arange(k + 1, dtype=torch.int32, device=jb.device)
    if jb.dim() == 2:
        edges = edges.expand(jb.shape[0], k + 1).contiguous()
    pos = torch.searchsorted(jb.contiguous(), edges, right=False)
    counts = torch.diff(pos, dim=-1)
    return torch.amax(counts, dim=-1).to(torch.float32) * k / m


def learned_fit(sorted_sample: torch.Tensor, k: int,
                threshold: float = IMBALANCE_THRESHOLD,
                bits: Optional[int] = None) -> Tuple[torch.Tensor, bool]:
    """(knots, fell_back) for a sorted (m,) sample, or per-row (B, m)
    samples with one batch-wide verdict: the host read that stands for the
    reference's ``lax.cond``."""
    knots = fit_cdf_knots(sorted_sample, bits=bits)
    fell_back = bool(torch.any(sample_imbalance(sorted_sample, knots, k, bits) > threshold))
    return knots, fell_back


def _with_eq(keys: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return 2 * j + (keys == sentinel_for(keys.dtype)).to(torch.int32)


def learned_model_ids(keys: torch.Tensor, sorted_sample: torch.Tensor, k: int,
                      threshold: float = IMBALANCE_THRESHOLD,
                      bits: Optional[int] = None) -> Optional[torch.Tensor]:
    """The model's local ids in [0, 2k), int32, of ``keys`` (n,) or (B, n),
    or None when the fit trips the threshold; counts the pick in
    ``ROUTES``."""
    knots, fell_back = learned_fit(sorted_sample, k, threshold, bits)
    ROUTES["fallback" if fell_back else "model"] += 1
    if fell_back:
        return None
    return _with_eq(keys, eval_cdf_buckets(keys, knots, k, bits))


def learned_bucket_ids(
    keys: torch.Tensor,
    sorted_sample: torch.Tensor,
    splitters: torch.Tensor,
    k: int,
    threshold: float = IMBALANCE_THRESHOLD,
    bits: Optional[int] = None,
) -> Tuple[torch.Tensor, bool]:
    """Local bucket ids in [0, 2k) for ``keys`` (n,), with the tree fallback.
    ``sorted_sample`` (m,) trains the CDF; ``splitters`` (k-1,) are the
    tree's order statistics of the same sample.  Returns (ids, fell_back)."""
    knots, fell_back = learned_fit(sorted_sample, k, threshold, bits)
    if fell_back:
        return classify(keys, splitters, k), True
    return _with_eq(keys, eval_cdf_buckets(keys, knots, k, bits)), False


def learned_bucket_ids_batched(
    keys: torch.Tensor,
    sorted_sample: torch.Tensor,
    splitters: torch.Tensor,
    k: int,
    threshold: float = IMBALANCE_THRESHOLD,
    bits: Optional[int] = None,
) -> Tuple[torch.Tensor, bool]:
    """Per-row ids for ``keys`` (B, n) with per-row samples (B, m) and
    splitters (B, k-1).  The fallback is batch-wide, as in the reference: a
    single badly fit row reroutes every row through the tree."""
    knots, fell_back = learned_fit(sorted_sample, k, threshold, bits)
    if fell_back:
        return classify_batched(keys, splitters, k), True
    return _with_eq(keys, eval_cdf_buckets(keys, knots, k, bits)), False
