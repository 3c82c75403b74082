"""IPS4o: In-place Parallel Super Scalar Samplesort, PyTorch/CUDA form.

Counterpart of ``repro.core.ips4o`` for 1-D keys (DESIGN.md §4):

  * the recursion is flattened into at most two *level passes*;
  * level 1 (:func:`level_pass`) samples k-1 splitters and runs kernel K1
    (``kernels.level_fused.level_fused``: tree classify, pad routing,
    stable in-tile rank and histogram) and a scatter by its destinations;
  * level 2 (:func:`segmented_level_pass`) samples splitters per level-1
    segment, classifies in plain torch (XLA in the reference) and runs
    kernel K2 (``kernels.level_fused.rank_hist``) over the composite ids at
    any number of buckets;
  * the base case (:func:`base_case`) is two overlapped passes of kernel K3
    (``kernels.bitonic.sort_windows``), the stable (bucket, key) window
    sort, at window offsets 0 and W/2;
  * the robustness fallback, when a non-trivial bucket exceeds W/2,
    stably sorts those buckets with ``torch.sort`` before the window passes
    (the reference sorts everything there; the result is the same).

The port has no engine switch: on a CUDA tensor these passes launch the
kernels, and only those; on a CPU tensor the kernels' plain twins run.
Keys are the keyspace-encoded int32 of ``ops.keyspace`` (signed ``<`` is
the key order, the sentinel is the int32 max).  Every stage is stable, so
the sorted keys and the argsort equal the reference's bit for bit whatever
splitters the sample gives.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.classify import CLASSIFIERS, classify_segmented
from repro_torch.core import sampling
from repro_torch.kernels.bitonic import window_perm_plain
from repro_torch.kernels.level_fused import level_fused, rank_hist
from repro_torch.kernels.ops import base_case_windows

__all__ = [
    "SortConfig",
    "config_from_reference",
    "ips4o_sort",
    "is4o_sort",
    "plan_levels",
    "pad_with_sentinel",
    "level_pass",
    "segmented_level_pass",
    "composite_ids",
    "partition_passes",
    "base_case",
    "bucket_violations",
    "segment_ids",
    "stable_full_sort",
]

Arrays = Dict[str, torch.Tensor]
_ROADMAP = "see ROADMAP.md, queue 1"


@dataclass(frozen=True)
class SortConfig:
    """Tuning parameters (paper §4.7 defaults), as in ``repro``."""

    base_case: int = 8192          # W: base-case window
    kmax: int = 128                # max buckets per level
    tile: int = 4096               # distribution tile (K1 tile, K2 work item)
    slack: int = 8                 # target expected bucket size = W / slack
    max_sample: int = 8192         # cap on the level-1 sample size
    seed: int = 0xC0FFEE           # seeds the torch.Generator of the samples
    fallback: bool = True          # robustness fallback (a host read here)
    classifier: str = "tree"       # only "tree" is ported


# reference fields with no meaning in the port: it has no engine switch (its
# kernels always run on the card) and its tiles are not TPU (rows, 128) blocks
_REFERENCE_ONLY = ("engine", "classify_rows")


def config_from_reference(d: dict) -> SortConfig:
    """The port's config for ``dataclasses.asdict`` of a ``repro``
    ``SortConfig``; takes a dict so the port never imports ``repro``.

    >>> config_from_reference({"base_case": 1024, "engine": "xla"}).base_case
    1024
    """
    names = {f.name for f in dataclasses.fields(SortConfig)}
    unknown = set(d) - names - set(_REFERENCE_ONLY)
    if unknown:
        raise ValueError(f"unknown SortConfig fields {sorted(unknown)}")
    cfg = SortConfig(**{key: v for key, v in d.items() if key in names})
    _check_config(cfg)
    return cfg


def _check_config(cfg: SortConfig) -> None:
    if cfg.classifier not in CLASSIFIERS:
        raise NotImplementedError(
            f"classifier {cfg.classifier!r} is not ported yet; only "
            f"{CLASSIFIERS} ({_ROADMAP} item 5)"
        )


def plan_levels(n: int, cfg: SortConfig) -> List[int]:
    """Choose the k for each of (at most two) level passes."""
    if n <= cfg.base_case:
        return []
    target = -(-cfg.slack * n // cfg.base_case)  # ceil
    k1 = max(2, 1 << math.ceil(math.log2(target)))
    if k1 <= cfg.kmax:
        return [k1]
    k1 = cfg.kmax
    k2 = max(2, 1 << math.ceil(math.log2(-(-target // k1))))
    if k2 > cfg.kmax:
        raise ValueError(
            f"n={n} too large for 2 levels with kmax={cfg.kmax}, "
            f"base_case={cfg.base_case}"
        )
    return [k1, k2]


def _auto_tile(n: int, nb: int, cfg: SortConfig) -> int:
    """Grow the tile so the (T, nb) histogram stays bounded (<= 2^26 ints)."""
    tile = cfg.tile
    while (n // tile) * nb > (1 << 26) and tile < cfg.base_case:
        tile *= 2
    return tile


def segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Per-position bucket/segment id (n,) int32 from (nb+1,) offsets."""
    pos = torch.arange(n, dtype=torch.int32, device=offsets.device)
    return (torch.searchsorted(offsets, pos, right=True) - 1).to(torch.int32)


def _scatter(arrays: Arrays, dest: torch.Tensor) -> Arrays:
    """Move every tensor by the destinations: out[dest[i]] = a[i]."""
    d = dest.to(torch.int64)
    out = {}
    for name, a in arrays.items():
        o = torch.empty_like(a)
        o[d] = a
        out[name] = o
    return out


def _window_perm(keys_w: torch.Tensor, fb_w: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic (bucket, key) sort permutation per window: the
    reference's XLA base case (same argument order), K3's plain twin."""
    return window_perm_plain(fb_w, keys_w)


def base_case(arrays: Arrays, fb: torch.Tensor, W: int, nb: int) -> Arrays:
    """Two overlapped segmented window-sort passes (DESIGN.md §4.3), through
    K3 (``kernels.ops.base_case_windows``); ``nb`` bounds the bucket ids."""
    return base_case_windows(arrays, fb, W, nb)


def stable_full_sort(arrays: Arrays) -> Arrays:
    """Plain stable sort of the arrays by key: the robustness fallback."""
    order = torch.sort(arrays["k"], stable=True).indices
    return {name: a[order] for name, a in arrays.items()}


def pad_with_sentinel(arrays: Arrays, unit: int) -> Arrays:
    """Pad every tensor to a multiple of ``unit``; pad keys get the
    sentinel so they sort to the tail, other tensors get zeros."""
    n = arrays["k"].shape[0]
    n_pad = -(-n // unit) * unit
    if n_pad == n:
        return arrays
    out = {}
    for name, a in arrays.items():
        o = torch.zeros((n_pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        o[:n] = a
        out[name] = o
    out["k"][n:] = sampling.sentinel_for(out["k"].dtype)
    return out


def level_pass(
    arrays: Arrays,
    n_real: int,
    k: int,
    cfg: SortConfig,
    gen: torch.Generator,
    splitters: Optional[torch.Tensor] = None,
) -> Tuple[Arrays, torch.Tensor, int, int]:
    """One *global* level pass: sample -> K1 (classify + rank + histogram)
    -> scatter.  Pads (positions >= n_real) go to the dedicated bucket 2k.
    ``splitters`` (k-1,) replaces the sample when given.  Returns
    (arrays, offsets, nb, pad_bucket) with nb = 2k + 1."""
    keys = arrays["k"]
    n = keys.shape[0]
    if splitters is None:
        with obs.trace("sample", k=k, n=n_real):
            m1 = min(
                max(sampling.oversampling_factor(n_real) * k, k), cfg.max_sample, n_real
            )
            pos = torch.randint(0, n_real, (m1,), generator=gen, device=keys.device)
            sample = torch.sort(keys[pos]).values
            splitters = sampling.select_splitters(sample, k)
    nb = 2 * k + 1  # +1: dedicated pad bucket (the overflow-block analogue)
    with obs.trace("classify", fused=True, k=k):
        dest, off = level_fused(
            keys, splitters, k=k, n_real=n_real, tile=_auto_tile(n, nb, cfg)
        )
    with obs.trace("partition", fused=True, nb=nb):
        arrays = _scatter(arrays, dest)
    return arrays, off, nb, 2 * k


def segmented_level_pass(
    arrays: Arrays,
    seg_offsets: torch.Tensor,
    num_seg: int,
    n_real: int,
    k: int,
    cfg: SortConfig,
    gen: torch.Generator,
    sample_cap: int = 2048,
    splitters: Optional[torch.Tensor] = None,
) -> Tuple[Arrays, torch.Tensor, int]:
    """One *segmented* level pass (recursion level 2): per-segment
    splitters, plain flattened classification, then K2 over the composite
    ids ``seg * 2k + local`` with the segments' offsets, and a scatter.
    ``splitters`` (num_seg, k-1) replaces the sample when given.  Returns
    (arrays, offsets, nb) with nb = num_seg * 2k."""
    keys = arrays["k"]
    n = keys.shape[0]
    comp = composite_ids(keys, seg_offsets, num_seg, n_real, k, gen, sample_cap, splitters)
    nb = num_seg * 2 * k
    with obs.trace("partition", segmented=True, nb=nb):
        dest, offsets = rank_hist(
            comp, nb=nb, seg_offsets=seg_offsets, seg_width=2 * k,
            tile=_auto_tile(n, 2 * k, cfg),
        )
        arrays = _scatter(arrays, dest)
    return arrays, offsets, nb


def composite_ids(
    keys: torch.Tensor,
    seg_offsets: torch.Tensor,
    num_seg: int,
    n_real: int,
    k: int,
    gen: torch.Generator,
    sample_cap: int = 2048,
    splitters: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Level 2's composite bucket ids ``seg * 2k + local`` (n,) int32: the
    ids K2 ranks.  Samples each segment's splitters unless given."""
    n = keys.shape[0]
    seg = segment_ids(seg_offsets, n)
    if splitters is None:
        with obs.trace("sample", segmented=True, k=k, segments=num_seg):
            m = min(max(sampling.oversampling_factor(n_real) * k, k), sample_cap)
            pos = sampling.sample_indices(gen, m, seg_offsets[:-1], seg_offsets[1:])
            # an empty last segment samples position n: clamp it (jnp.take
            # clamps in the reference), no element classifies into it anyway
            pos = pos.reshape(-1).clamp_(max=n - 1)
            svals = torch.sort(keys[pos].reshape(num_seg, m), dim=-1).values
            splitters = sampling.select_splitters(svals, k)
    with obs.trace("classify", segmented=True, k=k):
        local = classify_segmented(keys, seg, splitters, k)
    return seg * (2 * k) + local


def partition_passes(
    arrays: Arrays,
    n_real: int,
    cfg: SortConfig,
    levels: Sequence[int],
    splitters: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Arrays, torch.Tensor, int, Optional[int]]:
    """Run the (at most two) level passes of the flattened recursion.

    Returns (arrays, offsets, nb, pad_bucket): every bucket is contiguous,
    buckets are in key order, odd ids are equality buckets, and the pads
    sit at the tail (in ``pad_bucket`` after one level, in an odd
    sentinel-equality bucket after two).  ``splitters`` gives each level's
    splitters in place of the samples (the parity tests feed the
    reference's); the samples come from a ``torch.Generator`` seeded with
    ``cfg.seed`` on the keys' device.
    """
    keys = arrays["k"]
    gen = torch.Generator(device=keys.device).manual_seed(cfg.seed)
    spl = list(splitters) if splitters is not None else [None] * len(levels)
    with obs.trace("level_pass", level=1, k=levels[0]):
        arrays, off1, nb1, pad_bucket = level_pass(
            arrays, n_real, levels[0], cfg, gen, spl[0]
        )
    if len(levels) == 1:
        return arrays, off1, nb1, pad_bucket
    with obs.trace("level_pass", level=2, k=levels[1], segmented=True):
        arrays, offsets, nb = segmented_level_pass(
            arrays, off1, nb1, n_real, levels[1], cfg, gen, splitters=spl[1]
        )
    return arrays, offsets, nb, None  # pads now sit in an odd equality bucket


def _oversized(
    offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int]
) -> torch.Tensor:
    """(nb,) mask of the non-trivial buckets larger than W/2; odd ids are
    equality buckets (and the pad bucket holds sentinels), which never need
    sorting."""
    sizes = offsets[1:] - offsets[:-1]
    ids = torch.arange(nb, device=offsets.device)
    nontrivial = (ids % 2) == 0
    if pad_bucket is not None:
        nontrivial &= ids != pad_bucket
    return nontrivial & (sizes > W // 2)


def bucket_violations(
    offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int] = None
) -> torch.Tensor:
    """True iff some non-trivial bucket exceeds W/2 (base-case
    precondition)."""
    return torch.any(_oversized(offsets, nb, W, pad_bucket))


def _sort_oversized(
    arrays: Arrays, fb: torch.Tensor, offsets: torch.Tensor, nb: int, W: int,
    pad_bucket: Optional[int],
) -> Arrays:
    """Stably sort, in place, the keys of every bucket larger than W/2.

    The robustness fallback.  The reference sorts the whole array instead
    (``lax.cond`` into ``stable_full_sort``).  Sorting only the oversized
    buckets gives the same result: a window pass re-sorts a piece of a
    sorted bucket into itself, so the two window passes that follow still
    finish every other bucket, stably.  At the default config and
    n = 2^24 some buckets exceeded W/2 in every run measured (PERF.md), so
    this is on the main path there.
    """
    big = _oversized(offsets, nb, W, pad_bucket)[fb.to(torch.int64)]
    pos = torch.nonzero(big).squeeze(1)
    packed = (fb[pos].to(torch.int64) << 32) + (arrays["k"][pos].to(torch.int64) + (1 << 31))
    src = pos[torch.sort(packed, stable=True).indices]
    for a in arrays.values():
        a[pos] = a[src]
    return arrays


def _sort_padded(
    arrays: Arrays,
    n_real: int,
    cfg: SortConfig,
    levels: Sequence[int],
) -> Arrays:
    """Sort padded arrays (pads = sentinel keys at the tail)."""
    n = arrays["k"].shape[0]
    W = cfg.base_case
    if not levels:
        return stable_full_sort(arrays)  # one window: the paper's smallSort

    arrays, offsets, nb, pad_bucket = partition_passes(arrays, n_real, cfg, levels)
    fb = segment_ids(offsets, n)
    with obs.trace("base_case", W=W, fallback=cfg.fallback):
        # the reference picks its fallback branch on the device with
        # lax.cond; here one host read of the verdict picks it
        if cfg.fallback and bool(bucket_violations(offsets, nb, W, pad_bucket)):
            arrays = _sort_oversized(arrays, fb, offsets, nb, W, pad_bucket)
        return base_case(arrays, fb, W, nb)


def ips4o_sort(
    keys: torch.Tensor,
    values: Optional[torch.Tensor] = None,
    cfg: SortConfig = SortConfig(),
):
    """Sort encoded int32 ``keys`` (n,) ascending, stably; optionally move a
    ``values`` tensor (leading dim n) alongside.  Returns keys or (keys,
    values) on the keys' device.

    The ``repro_torch.ops`` entry points encode float32/int32 keys first.
    """
    _check_config(cfg)
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    if keys.dtype != torch.int32:
        raise NotImplementedError(
            f"ips4o_sort takes keyspace-encoded int32 keys, got {keys.dtype} "
            f"({_ROADMAP} item 1)"
        )
    if values is not None and (
        not isinstance(values, torch.Tensor) or values.dim() < 1
        or values.shape[0] != keys.shape[0]
    ):
        raise NotImplementedError(
            "values must be one tensor with leading dim n; payload pytrees are "
            f"not ported yet ({_ROADMAP} item 7)"
        )
    n = keys.shape[0]
    if n <= 1:
        return keys if values is None else (keys, values)

    arrays = {"k": keys}
    if values is not None:
        arrays["v"] = values.to(keys.device)
    with obs.trace("ips4o_sort", n=n, classifier=cfg.classifier):
        arrays = pad_with_sentinel(arrays, max(cfg.base_case, cfg.tile))
        levels = plan_levels(arrays["k"].shape[0], cfg)
        arrays = _sort_padded(arrays, n, cfg, levels)
    out_k = arrays["k"][:n]
    return out_k if values is None else (out_k, arrays["v"][:n])


def is4o_sort(keys: torch.Tensor, values=None, cfg: SortConfig = SortConfig()):
    """IS4o, the sequential instantiation: the same pass pipeline."""
    return ips4o_sort(keys, values, cfg)
