"""IPS4o: In-place Parallel Super Scalar Samplesort, PyTorch/CUDA form.

Counterpart of ``repro.core.ips4o`` for 1-D keys and for (B, n) rows
(DESIGN.md §4, §6):

  * the recursion is flattened into at most two *level passes*;
  * level 1 (:func:`level_pass`) samples k-1 splitters and runs kernel K1
    (``kernels.level_fused.level_fused``: tree classify, pad routing,
    stable in-tile rank and histogram) and a scatter by its destinations;
    with ``classifier="radix"`` it samples nothing and runs K1's radix
    mode K1r, which buckets on the top log2(k) key bits; with
    ``classifier="learned"`` it fits the CDF model of ``classify.learned``
    on the sample, classifies by the model in plain torch (XLA in the
    reference) and places the ids with kernel K2 ``rank_hist``; a fit whose
    sample-measured imbalance trips the threshold runs the tree (K1)
    instead, one host read deciding;
  * level 2 (:func:`segmented_level_pass`) samples splitters per level-1
    segment (or, after a radix level 1, takes the next log2(k2) bits),
    classifies by the G3 kernel (XLA in the reference) and runs kernel K2
    (``kernels.level_fused.rank_hist``) over the composite ids at any
    number of buckets;
  * the batched pipeline (:func:`ips4o_sort_batched`) runs the same passes
    over B rows at once: kernel K4 ``level_fused_batched`` at level 1 (each
    row with its own splitters, or the shared radix shift) and K4
    ``rank_hist_batched`` at level 2; rows never exchange elements;
  * the base case (:func:`base_case`) is two overlapped passes of kernel K3
    (``kernels.bitonic.sort_windows``), the stable (bucket, key) window
    sort, at window offsets 0 and W/2;
  * the robustness fallback, when a non-trivial bucket exceeds W/2,
    stably sorts those buckets (of every row) before the window passes
    (the reference sorts everything there, batch-wide; the result is the
    same): on the card the G7 kernels list them and sort them with no
    host read, as the reference's ``lax.cond`` decides on the device;
  * ``limit`` restricts the base case and the fallback to a prefix of each
    row, for the partial sorts of ``ops.topk`` and ``ops.batched``;
  * ``values`` is any pytree of tensors (``torch.utils._pytree``: dicts,
    lists, tuples, NamedTuples) whose leaves have the keys' leading dims;
    every leaf rides every pass as one more tensor of the arrays, and a
    ``None`` leaf is an empty subtree, as in ``jax.tree``;
  * :func:`tiebreak_passes` sorts multi-word keys word by word, re-sorting
    only the runs that still tie (DESIGN.md §11).

The port has no engine switch: on a CUDA tensor these passes launch the
kernels, and only those; on a CPU tensor the kernels' plain twins run.
What the reference leaves to XLA between its kernels runs on the card as
the glue kernels: K1's placement close (G1), the segment ids (G2), level
2's composite ids (G3), the level scatters and the base case's window
gathers (G4), the levels' samples (G6, ``kernels.glue``), the keyspace
codec with the pad (G5, ``kernels.codec``, at the ``ops`` entry points,
which hand :func:`sort_padded` arrays already padded) and the robustness
fallback (G7, ``kernels.fallback``).  From the entry point to its return
the host reads nothing from the card (obs disabled).
Keys are the keyspace-encoded int32 or int64 codes of ``ops.keyspace``
(signed ``<`` is the key order, the sentinel is the code dtype's max); K1,
K4 ``level_fused_batched`` and K3 have a 32-bit and a 64-bit form each, K2
sees ids only.  Every stage is stable, so the sorted keys and the argsort
equal the reference's bit for bit whatever splitters the sample gives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.classify import learned_model_ids, resolve_classifier
from repro_torch.core import sampling
from repro_torch.core.sampling import signed_payload
from repro_torch.kernels import fallback, glue
from repro_torch.kernels.bitonic import window_perm_plain
from repro_torch.kernels.level_fused import (
    MAX_TILE64,
    level_fused,
    level_fused_batched,
    rank_hist,
    rank_hist_batched,
)
from repro_torch.kernels.ops import base_case_windows

__all__ = [
    "SortConfig",
    "config_from_reference",
    "ips4o_sort",
    "sort_padded",
    "is4o_sort",
    "plan_levels",
    "pad_with_sentinel",
    "level_pass",
    "segmented_level_pass",
    "composite_ids",
    "partition_passes",
    "base_case",
    "base_case_with_fallback",
    "bucket_violations",
    "segment_ids",
    "stable_full_sort",
    "signed_payload",
    "tiebreak_passes",
    "make_sorter",
    # the batch-axis pipeline, consumed by ``repro_torch.ops.batched``
    "ips4o_sort_batched",
    "sort_padded_batched",
    "batched_pad_with_sentinel",
    "batched_level_pass",
    "batched_segmented_level_pass",
    "batched_composite_ids",
    "batched_partition_passes",
    "batched_base_case",
    "batched_bucket_violations",
    "batched_segment_ids",
    "batched_stable_full_sort",
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
    fallback: bool = True          # robustness fallback (on the card: no host read)
    classifier: str = "tree"       # "tree" | "radix" | "learned" | "auto"


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
    resolve_classifier(cfg.classifier)  # raises for an unknown classifier


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


def _level_tile(keys: torch.Tensor, nb: int, cfg: SortConfig) -> int:
    """Level 1's tile: :func:`_auto_tile`, at most ``MAX_TILE64`` for int64
    codes (K1's 64-bit form holds half the chunks a warp).  The tile never
    changes the stable placement."""
    tile = _auto_tile(keys.shape[-1], nb, cfg)
    return min(tile, MAX_TILE64) if keys.dtype == torch.int64 else tile


def _obs_level_stats(offsets: torch.Tensor, nb: int, pad_bucket: Optional[int],
                     level: str) -> None:
    """Bucket-balance stats of one completed level pass, from its offsets
    ((nb+1,) or (B, nb+1)): ``sort.bucket_imbalance`` (largest / mean
    non-trivial bucket) and ``sort.largest_bucket``, over the even buckets
    other than the pad bucket (odd ids are equality buckets, sized by the
    data).  Nothing is computed or read unless obs is enabled."""
    if not obs.enabled():
        return
    sizes = offsets[..., 1:] - offsets[..., :-1]
    ids = torch.arange(nb)  # the mask is static: made on the host
    mask = ids % 2 == 0
    if pad_bucket is not None:
        mask &= ids != pad_bucket
    k_eff = int(mask.sum())
    if k_eff == 0:
        return
    rows = math.prod(sizes.shape[:-1]) if sizes.dim() > 1 else 1
    szs = torch.where(mask.to(offsets.device), sizes, 0)
    largest = szs.max()
    mean = torch.clamp(szs.sum().to(torch.float32) / (k_eff * max(rows, 1)), min=1.0)
    obs.jit_observe("sort.bucket_imbalance", largest.to(torch.float32) / mean, level=level)
    obs.jit_observe("sort.largest_bucket", largest, level=level)


def _obs_base_stats(violated: Optional[bool]) -> None:
    """Base case against robustness fallback: ``sort.fallback_engaged`` and
    ``sort.base_case``, from the fallback's own verdict (read to the host
    only when obs is enabled); None when obs is disabled and nothing was
    read."""
    if violated is None or not obs.enabled():
        return
    obs.count("sort.fallback_engaged", int(violated))
    obs.count("sort.base_case", 1 - int(violated))


def segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Per-position bucket/segment id (n,) int32 from (nb+1,) offsets; for
    (B, nb+1) offsets, (B, n) ids per row.  The G2 kernel
    (``kernels.glue.segment_ids``) on a CUDA tensor."""
    return glue.segment_ids(offsets, n)


def _scatter(arrays: Arrays, dest: torch.Tensor,
             offsets: Optional[torch.Tensor] = None) -> Arrays:
    """Move every tensor by the destinations: out[dest[i]] = a[i].  With
    (B, n) row-local ``dest`` each row moves within itself.  G4's scatter
    (``kernels.glue.scatter_rows``, one launch for every tensor) on a CUDA
    tensor; a level pass hands it its placement's ``offsets``, with which
    the kernel writes runs of consecutive destinations."""
    return glue.scatter_rows(arrays, dest, offsets)


def _window_perm(keys_w: torch.Tensor, fb_w: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic (bucket, key) sort permutation per window: the
    reference's XLA base case (same argument order), K3's plain twin."""
    return window_perm_plain(fb_w, keys_w)


def base_case(
    arrays: Arrays, fb: torch.Tensor, W: int, nb: int, limit: Optional[int] = None
) -> Arrays:
    """Two overlapped segmented window-sort passes (DESIGN.md §4.3), through
    K3 (``kernels.ops.base_case_windows``); ``nb`` bounds the bucket ids
    (any nb: above K3's bucket field it sees window-local run indices).
    ``limit`` (a multiple of W) restricts both passes to [0, limit), for
    the partial sorts of ``ops.topk``."""
    return base_case_windows(arrays, fb, W, nb, limit)


def stable_full_sort(arrays: Arrays) -> Arrays:
    """Plain stable sort of the arrays by key: the robustness fallback."""
    order = torch.sort(arrays["k"], stable=True).indices
    return {name: a[order] for name, a in arrays.items()}


def pad_with_sentinel(arrays: Arrays, unit: int) -> Arrays:
    """Pad every tensor to a multiple of ``unit``; pad keys get the
    sentinel so they sort to the tail, other tensors get zeros."""
    return _pad(arrays, unit, dim=0)


def _pad(arrays: Arrays, unit: int, dim: int) -> Arrays:
    n = arrays["k"].shape[dim]
    return _pad_to(arrays, padded_length(n, unit), dim)


def padded_length(n: int, unit: int) -> int:
    """n rounded up to a multiple of ``unit``: the pipeline's padded length."""
    return -(-n // unit) * unit


def _pad_to(arrays: Arrays, n_pad: int, dim: int) -> Arrays:
    """Every tensor shorter than ``n_pad`` along ``dim`` padded to it, with
    zeros, and the keys ("k") with the sentinel; the others as they are."""
    out = {}
    for name, a in arrays.items():
        n = a.shape[dim]
        if n == n_pad:
            out[name] = a
            continue
        shape = list(a.shape)
        shape[dim] = n_pad
        o = torch.zeros(shape, dtype=a.dtype, device=a.device)
        o.narrow(dim, 0, n).copy_(a)
        if name == "k":
            o.narrow(dim, n, n_pad - n).fill_(sampling.sentinel_for(a.dtype))
        out[name] = o
    return out


def _level1_sample_size(n_real: int, k: int, cfg: SortConfig) -> int:
    return min(max(sampling.oversampling_factor(n_real) * k, k), cfg.max_sample, n_real)


def _learned_ids(keys, sample, k, n_real) -> Optional[torch.Tensor]:
    """Level 1's ids (n,) or (B, n) by the learned CDF model fitted on
    ``sample``, pads (positions >= n_real) in bucket 2k; None when the fit
    (of any row) trips the imbalance threshold and the tree must classify.
    One host read of the sample's imbalance stands for the reference's
    ``lax.cond``."""
    ids = learned_model_ids(keys, sample, k)
    if ids is not None:
        ids[..., n_real:] = 2 * k
    return ids


def level_pass(
    arrays: Arrays,
    n_real: int,
    k: int,
    cfg: SortConfig,
    gen: torch.Generator,
    splitters: Optional[torch.Tensor] = None,
    consumed_bits: int = 0,
) -> Tuple[Arrays, torch.Tensor, int, int]:
    """One *global* level pass: sample -> K1 (classify + rank + histogram)
    -> scatter.  Pads (positions >= n_real) go to the dedicated bucket 2k.
    ``splitters`` (k-1,) replaces the sample when given.  With
    ``cfg.classifier == "radix"`` nothing is sampled and K1r buckets on
    the log2(k) key bits past ``consumed_bits``.  With "learned" the CDF
    model fitted on the sample classifies in plain torch and K2
    ``rank_hist`` places the ids; a fit that trips the imbalance threshold
    runs the tree through K1, as the reference's ``lax.cond`` does.  Returns (arrays, offsets, nb,
    pad_bucket) with nb = 2k + 1."""
    keys = arrays["k"]
    clf = resolve_classifier(cfg.classifier)
    upper = None  # the splitters' upper form, when G6 wrote it beside them
    if clf == "radix":
        splitters = None
    elif splitters is None:
        with obs.trace("sample", k=k, n=n_real):
            m1 = _level1_sample_size(n_real, k, cfg)
            pos = torch.randint(0, n_real, (m1,), generator=gen, device=keys.device)
            if clf == "learned":  # the model is fitted on the sorted sample itself
                sample = torch.sort(keys[pos]).values
                splitters = sampling.select_splitters(sample, k)
            else:  # G6: the gather, the sort and the pick in one launch
                splitters, upper = glue.sample_splitters(keys[None], pos[None], k, upper=True)
                splitters = splitters[0]
    elif clf == "learned":
        raise ValueError("the learned classifier fits its model on the drawn sample: "
                         "pass no splitters")
    nb = 2 * k + 1  # +1: dedicated pad bucket (the overflow-block analogue)
    ids = None
    if clf == "learned":
        with obs.trace("classify", classifier="learned", k=k):
            ids = _learned_ids(keys, sample, k, n_real)
    if ids is not None:
        with obs.trace("partition", nb=nb):
            dest, off = rank_hist(ids, nb=nb, tile=_auto_tile(keys.shape[0], nb, cfg))
            return _scatter(arrays, dest, off), off, nb, 2 * k
    clf = "tree" if clf == "learned" else clf
    with obs.trace("classify", fused=True, classifier=clf, k=k):
        dest, off = level_fused(
            keys, splitters, k=k, n_real=n_real, tile=_level_tile(keys, nb, cfg),
            classifier=clf, consumed_bits=consumed_bits, upper=upper,
        )
    with obs.trace("partition", fused=True, nb=nb):
        arrays = _scatter(arrays, dest, off)
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
    classifier: str = "tree",
    consumed_bits: int = 0,
) -> Tuple[Arrays, torch.Tensor, int]:
    """One *segmented* level pass (recursion level 2): per-segment
    splitters (or the radix bits past ``consumed_bits``, valid only after a
    radix level 1), the composite ids ``seg * 2k + local`` (the G3 kernel),
    then K2 over them with the segments' offsets, and a scatter.  ``splitters`` (num_seg, k-1) replaces the sample when given.
    Returns (arrays, offsets, nb) with nb = num_seg * 2k."""
    keys = arrays["k"]
    n = keys.shape[0]
    comp = composite_ids(keys, seg_offsets, num_seg, n_real, k, gen, sample_cap,
                         splitters, classifier, consumed_bits)
    nb = num_seg * 2 * k
    with obs.trace("partition", segmented=True, nb=nb):
        dest, offsets = rank_hist(
            comp, nb=nb, seg_offsets=seg_offsets, seg_width=2 * k,
            tile=_auto_tile(n, 2 * k, cfg),
        )
        arrays = _scatter(arrays, dest, offsets)
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
    classifier: str = "tree",
    consumed_bits: int = 0,
) -> torch.Tensor:
    """Level 2's composite bucket ids ``seg * 2k + local`` (n,) int32: the
    ids K2 ranks.  Samples each segment's splitters unless given or
    ``classifier`` is "radix"."""
    return batched_composite_ids(
        keys[None], seg_offsets[None], num_seg, n_real, k, gen, sample_cap,
        None if splitters is None else splitters[None], classifier, consumed_bits, spans=True,
    )[0]


_NO_SPAN = contextlib.nullcontext()


def _no_span(name: str, **attrs) -> contextlib.nullcontext:
    return _NO_SPAN


def batched_composite_ids(
    keys: torch.Tensor,
    seg_offsets: torch.Tensor,
    num_seg: int,
    n_real: int,
    k: int,
    gen: torch.Generator,
    sample_cap: int = 2048,
    splitters: Optional[torch.Tensor] = None,
    classifier: str = "tree",
    consumed_bits: int = 0,
    *,
    spans: bool = False,
) -> torch.Tensor:
    """Row-local composite ids (B, n) int32 of (B, n) ``keys`` with
    (B, num_seg+1) ``seg_offsets``; ``splitters`` is (B, num_seg, k-1).
    The sample's draw stays in torch, its splitters come from the G6 kernel
    (``kernels.glue.sample_splitters``); the ids come from the G3 kernel
    (``kernels.glue.composite_ids``: the segments, the classification and
    ``seg * 2k + local`` in one pass) on a CUDA tensor, from its plain twin
    (``segment_ids``, then ``classify_segmented`` flattened over the (row,
    segment) pairs, or the radix bits) on a CPU tensor.
    ``spans`` records the sample and classify spans of the 1-D level 2
    (the reference's batched level 2 records none)."""
    B, n = keys.shape
    trace = obs.trace if spans else _no_span
    if classifier == "radix":
        # no sample: within a radix-aligned segment the next bits are monotone
        with trace("classify", segmented=True, classifier="radix", k=k):
            return glue.composite_ids(keys, seg_offsets, num_seg, k, None, consumed_bits)
    if splitters is None:
        with trace("sample", segmented=True, k=k, segments=num_seg):
            m = min(max(sampling.oversampling_factor(n_real) * k, k), sample_cap)
            # sampling.sample_indices' draw; G6 maps it into each segment (an
            # empty last segment samples position n, clamped as jnp.take
            # clamps in the reference: no element classifies into it anyway),
            # gathers, sorts and picks each segment's splitters in one launch
            u = torch.rand((B, num_seg, m), generator=gen, device=keys.device)
            splitters = glue.sample_splitters(keys, u, k, seg_offsets=seg_offsets)
    with trace("classify", segmented=True, classifier="tree", k=k):
        return glue.composite_ids(keys, seg_offsets, num_seg, k, splitters)


def _level2_classifier(clf: str) -> str:
    """Level 2's classifier: radix stays radix (its segments are bit-aligned
    key ranges); "learned" maps to "tree", as in the reference (the CDF
    model is global, and per-segment refits would cost more than the
    per-segment tree they would replace)."""
    return "radix" if clf == "radix" else "tree"


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
    ``cfg.seed`` on the keys' device.  Level 2 stays radix only when level 1
    was radix, shifted past the ``log2(k1)`` bits level 1 fixed, and runs
    the tree after a learned level 1.
    """
    clf = resolve_classifier(cfg.classifier)
    keys = arrays["k"]
    gen = torch.Generator(device=keys.device).manual_seed(cfg.seed)
    spl = list(splitters) if splitters is not None else [None] * len(levels)
    with obs.trace("level_pass", level=1, k=levels[0]):
        arrays, off1, nb1, pad_bucket = level_pass(
            arrays, n_real, levels[0], cfg, gen, spl[0]
        )
    _obs_level_stats(off1, nb1, pad_bucket, level="1")
    if len(levels) == 1:
        return arrays, off1, nb1, pad_bucket
    with obs.trace("level_pass", level=2, k=levels[1], segmented=True):
        arrays, offsets, nb = segmented_level_pass(
            arrays, off1, nb1, n_real, levels[1], cfg, gen, splitters=spl[1],
            classifier=_level2_classifier(clf), consumed_bits=levels[0].bit_length() - 1,
        )
    _obs_level_stats(offsets, nb, None, level="2")
    return arrays, offsets, nb, None  # pads now sit in an odd equality bucket


def bucket_violations(
    offsets: torch.Tensor, nb: int, W: int, pad_bucket: Optional[int] = None,
    limit: Optional[int] = None,
) -> torch.Tensor:
    """True iff some non-trivial bucket (of any row) exceeds W/2 (the
    base-case precondition); ``limit`` restricts the check to the buckets
    that start below it.  A 0-d bool tensor on the offsets' device: on a
    CUDA tensor the G7 list kernel's verdict, read by nobody here."""
    if offsets.device.type == "cuda":
        return fallback.verdict(fallback.oversized_list(offsets, nb, W, pad_bucket, limit, None))
    return torch.any(fallback.oversized_mask(offsets, nb, W, pad_bucket, limit))


def base_case_with_fallback(
    arrays: Arrays, offsets: torch.Tensor, nb: int, pad_bucket: Optional[int],
    cfg: SortConfig, limit: Optional[int] = None,
) -> Arrays:
    """After the level passes: the fallback where it is needed, then the
    base case, over one row or B rows, on [0, limit) of each row.

    The fallback stably sorts, in place, the keys of every bucket larger
    than W/2 (that starts below ``limit``): ``kernels.fallback``.  The
    reference sorts the whole array (every row, batch-wide) instead
    (``lax.cond`` into ``stable_full_sort``).  Sorting only the oversized
    buckets gives the same result: a window pass re-sorts a piece of a
    sorted bucket into itself, so the two window passes that follow still
    finish every other bucket, stably.  At the default config and n = 2^24
    some buckets exceeded W/2 in every run measured (PERF.md), so this is
    on the main path there."""
    n = arrays["k"].shape[-1]
    W = cfg.base_case
    fb = segment_ids(offsets, n)
    # the reference picks its fallback branch on the device with lax.cond;
    # on the card the G7 kernels list the oversized buckets and sort them
    # with no host read (an empty list sorts nothing); obs, when enabled,
    # reads the list's verdict once.  On the CPU the plain twin reads it.
    meta = None
    if offsets.device.type == "cuda" and (cfg.fallback or obs.enabled()):
        meta = fallback.oversized_list(offsets, nb, W, pad_bucket, limit, n)
    violated = None
    if obs.enabled():
        verdict = fallback.verdict(meta) if meta is not None else \
            bucket_violations(offsets, nb, W, pad_bucket, limit)
        violated = bool(verdict)
    _obs_base_stats(violated)
    attrs = {"batched": True} if offsets.dim() == 2 else {}
    with obs.trace("base_case", W=W, fallback=cfg.fallback, **attrs):
        if cfg.fallback:
            arrays = fallback.sort_oversized(arrays, fb, offsets, nb, W, pad_bucket, limit,
                                             meta=meta)
        del meta  # held through the window passes, the list would raise their peak
        return base_case(arrays, fb, W, nb, limit)


def _sort_padded(
    arrays: Arrays,
    n_real: int,
    cfg: SortConfig,
    levels: Sequence[int],
) -> Arrays:
    """Sort padded arrays (pads = sentinel keys at the tail)."""
    if not levels:
        return stable_full_sort(arrays)  # one window: the paper's smallSort
    arrays, offsets, nb, pad_bucket = partition_passes(arrays, n_real, cfg, levels)
    return base_case_with_fallback(arrays, offsets, nb, pad_bucket, cfg)


# --------------------------------------------------------------------------
# The batch-axis pipeline (DESIGN.md §6): every stage over (B, n) rows at
# once.  Rows never exchange elements; each row gets its own splitters, its
# own bucket offsets and its own stable partition.  segment_ids, base_case
# and bucket_violations take (B, n) rows as they are; the reference's
# batched names stay as aliases.

batched_segment_ids = segment_ids
batched_base_case = base_case
batched_bucket_violations = bucket_violations


def batched_stable_full_sort(arrays: Arrays) -> Arrays:
    """Per-row stable sort by key: the smallSort of rows within one window."""
    order = torch.sort(arrays["k"], dim=1, stable=True).indices
    row = torch.arange(order.shape[0], device=order.device)[:, None]
    return {name: a[row, order] for name, a in arrays.items()}


def batched_pad_with_sentinel(arrays: Arrays, unit: int) -> Arrays:
    """Pad axis 1 of every (B, n, ...) tensor to a multiple of ``unit``; pad
    keys get the sentinel (each row's overflow-block analogue)."""
    return _pad(arrays, unit, dim=1)


def batched_level_pass(
    arrays: Arrays,
    n_real: int,
    k: int,
    cfg: SortConfig,
    gen: torch.Generator,
    splitters: Optional[torch.Tensor] = None,
) -> Tuple[Arrays, torch.Tensor, int, int]:
    """One global level pass per row: per-row sample -> K4
    ``level_fused_batched`` (classify + rank + histogram of all rows in one
    launch) -> per-row scatter.  "radix" samples nothing: the shift is
    shared by the rows.  "learned" fits one CDF model per row and places
    its ids with K4 ``rank_hist_batched``; when any row's fit trips the
    imbalance threshold every row runs its tree through K4
    ``level_fused_batched`` (batch-wide, as in the reference).
    ``splitters`` (B, k-1) replaces the samples when given.  Returns (arrays, offsets (B, nb+1), nb, pad_bucket), nb = 2k+1.
    """
    keys = arrays["k"]
    B = keys.shape[0]
    clf = resolve_classifier(cfg.classifier)
    upper = None  # the splitters' upper form, when G6 wrote it beside them
    if clf == "radix":
        splitters = None
    elif splitters is None:
        with obs.trace("sample", batched=True, k=k, n=n_real):
            m1 = _level1_sample_size(n_real, k, cfg)
            pos = torch.randint(0, n_real, (B, m1), generator=gen, device=keys.device)
            if clf == "learned":  # the model is fitted on the sorted samples themselves
                sample = torch.sort(torch.gather(keys, 1, pos), dim=1).values
                splitters = sampling.select_splitters(sample, k)
            else:  # G6: the gathers, the sorts and the picks in one launch
                splitters, upper = glue.sample_splitters(keys, pos, k, upper=True)
    elif clf == "learned":
        raise ValueError("the learned classifier fits its model on the drawn sample: "
                         "pass no splitters")
    nb = 2 * k + 1
    ids = None
    if clf == "learned":
        with obs.trace("classify", batched=True, classifier="learned", k=k):
            ids = _learned_ids(keys, sample, k, n_real)
    if ids is not None:
        with obs.trace("partition", batched=True, nb=nb):
            dest, off = rank_hist_batched(ids, nb=nb, tile=_auto_tile(keys.shape[1], nb, cfg))
            return _scatter(arrays, dest, off), off, nb, 2 * k
    clf = "tree" if clf == "learned" else clf
    with obs.trace("classify", batched=True, fused=True, k=k):
        dest, off = level_fused_batched(
            keys, splitters, k=k, n_real=n_real, tile=_level_tile(keys, nb, cfg),
            classifier=clf, upper=upper,
        )
    with obs.trace("partition", batched=True, fused=True, nb=nb):
        arrays = _scatter(arrays, dest, off)
    return arrays, off, nb, 2 * k


def batched_segmented_level_pass(
    arrays: Arrays,
    seg_offsets: torch.Tensor,
    num_seg: int,
    n_real: int,
    k: int,
    cfg: SortConfig,
    gen: torch.Generator,
    sample_cap: int = 2048,
    splitters: Optional[torch.Tensor] = None,
    classifier: str = "tree",
    consumed_bits: int = 0,
) -> Tuple[Arrays, torch.Tensor, int]:
    """Recursion level 2 per row: per-(row, segment) splitters (or the radix
    bits), flattened classification, then K4 ``rank_hist_batched`` over the
    row-local composite ids at any nb, and a per-row scatter.
    ``seg_offsets`` is (B, num_seg+1).  Returns (arrays, offsets (B, nb+1),
    nb) with nb = num_seg * 2k."""
    keys = arrays["k"]
    n = keys.shape[1]
    comp = batched_composite_ids(keys, seg_offsets, num_seg, n_real, k, gen, sample_cap,
                                 splitters, classifier, consumed_bits)
    nb = num_seg * 2 * k
    dest, offsets = rank_hist_batched(
        comp, nb=nb, seg_offsets=seg_offsets, seg_width=2 * k,
        tile=_auto_tile(n, 2 * k, cfg),
    )
    return _scatter(arrays, dest, offsets), offsets, nb


def batched_partition_passes(
    arrays: Arrays,
    n_real: int,
    cfg: SortConfig,
    levels: Sequence[int],
    splitters: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Arrays, torch.Tensor, int, Optional[int]]:
    """The (at most two) batched level passes, as :func:`partition_passes`
    per row.  Returns (arrays, offsets (B, nb+1), nb, pad_bucket).
    ``splitters`` gives (B, k1-1) and (B, num_seg, k2-1) splitters in place
    of the samples, which come from one ``torch.Generator`` seeded with
    ``cfg.seed`` (each row draws its own block of it)."""
    clf = resolve_classifier(cfg.classifier)
    gen = torch.Generator(device=arrays["k"].device).manual_seed(cfg.seed)
    spl = list(splitters) if splitters is not None else [None] * len(levels)
    with obs.trace("level_pass", level=1, k=levels[0], batched=True):
        arrays, off1, nb1, pad_bucket = batched_level_pass(
            arrays, n_real, levels[0], cfg, gen, spl[0]
        )
    _obs_level_stats(off1, nb1, pad_bucket, level="1")
    if len(levels) == 1:
        return arrays, off1, nb1, pad_bucket
    with obs.trace("level_pass", level=2, k=levels[1], batched=True, segmented=True):
        arrays, offsets, nb = batched_segmented_level_pass(
            arrays, off1, nb1, n_real, levels[1], cfg, gen, splitters=spl[1],
            classifier=_level2_classifier(clf), consumed_bits=levels[0].bit_length() - 1,
        )
    _obs_level_stats(offsets, nb, None, level="2")
    return arrays, offsets, nb, None  # pads now sit in odd equality buckets


def _sort_padded_batched(
    arrays: Arrays, n_real: int, cfg: SortConfig, levels: Sequence[int]
) -> Arrays:
    """Sort padded (B, n_pad, ...) arrays, all rows at once."""
    if not levels:
        return batched_stable_full_sort(arrays)
    arrays, offsets, nb, pad_bucket = batched_partition_passes(arrays, n_real, cfg, levels)
    return base_case_with_fallback(arrays, offsets, nb, pad_bucket, cfg)


def _check_keys(keys: torch.Tensor, dim: int) -> None:
    if keys.dim() != dim:
        raise ValueError(f"keys must be {'1-D' if dim == 1 else '2-D (B, n)'}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise NotImplementedError(
            f"the sort takes keyspace-encoded int32 or int64 keys, got {keys.dtype} "
            f"({_ROADMAP} item 1)"
        )


def _payload(values: Any, keys: torch.Tensor) -> Tuple[Arrays, Callable[[Arrays, int], Any]]:
    """Flatten a ``values`` pytree into the arrays' payload entries, one per
    leaf ("v0", "v1", ...), each on the keys' device and viewed by
    :func:`signed_payload`; returns them and the function that rebuilds the
    pytree from the sorted arrays, cut to the first n positions of each row.

    A ``None`` leaf is an empty subtree, as in ``jax.tree`` (torch's pytree
    would take it for a leaf): it never reaches the passes and comes back
    as ``None``."""
    leaves, spec = pytree.tree_flatten(values)
    lead = tuple(keys.shape)
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(leaves):
        if leaf is None:
            continue
        t = torch.as_tensor(leaf, device=keys.device)
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"payload leaf {i} has shape {tuple(t.shape)}; its leading "
                             f"dims must be the keys' {lead}")
        arrays[f"v{i}"], dtypes[i] = signed_payload(t), t.dtype

    def rebuild(sorted_arrays: Arrays, n: int) -> Any:
        out = [None] * len(leaves)
        for i in dtypes:
            a = sorted_arrays[f"v{i}"]
            out[i] = a.narrow(len(lead) - 1, 0, n).view(dtypes[i])
        return pytree.tree_unflatten(out, spec)

    return arrays, rebuild


def ips4o_sort_batched(
    keys: torch.Tensor,
    values: Any = None,
    cfg: SortConfig = SortConfig(),
):
    """Sort every row of encoded int32/int64 ``keys`` (B, n) ascending, stably
    and independently, in one pipeline; optionally move a ``values`` pytree
    (leaves with leading dims (B, n), any dtype) alongside, row by row.
    Returns keys or (keys, values) on the keys' device."""
    _check_config(cfg)
    _check_keys(keys, 2)
    B, n = keys.shape
    if n <= 1 or B == 0:
        return keys if values is None else (keys, values)
    arrays = {"k": keys}
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(payload)
    with obs.trace("ips4o_sort_batched", B=B, n=n):
        arrays = batched_pad_with_sentinel(arrays, max(cfg.base_case, cfg.tile))
        arrays = _sort_levels_batched(arrays, n, cfg)
    out_k = arrays["k"][:, :n]
    return out_k if values is None else (out_k, rebuild(arrays, n))


def _sort_levels_batched(arrays: Arrays, n_real: int, cfg: SortConfig) -> Arrays:
    return _sort_padded_batched(arrays, n_real, cfg, plan_levels(arrays["k"].shape[1], cfg))


def _check_padded(arrays: Arrays, n_real: int, cfg: SortConfig, dim: int) -> None:
    _check_config(cfg)
    keys = arrays["k"]
    _check_keys(keys, dim)
    n_pad = keys.shape[-1]
    if n_pad != padded_length(n_real, max(cfg.base_case, cfg.tile)) or n_real < 2:
        raise ValueError(f"sort_padded: {n_pad} positions are not {n_real} > 1 real ones padded "
                         f"to a multiple of max(base_case, tile)")


def sort_padded_batched(arrays: Arrays, n_real: int, cfg: SortConfig = SortConfig()) -> Arrays:
    """:func:`sort_padded` over (B, n_pad, ...) rows: the pipeline of
    :func:`ips4o_sort_batched` after its pad, each row on its own."""
    _check_padded(arrays, n_real, cfg, 2)
    B = arrays["k"].shape[0]
    if B == 0:
        return arrays
    with obs.trace("ips4o_sort_batched", B=B, n=n_real):
        return _sort_levels_batched(arrays, n_real, cfg)


def ips4o_sort(
    keys: torch.Tensor,
    values: Any = None,
    cfg: SortConfig = SortConfig(),
):
    """Sort encoded int32 or int64 ``keys`` (n,) ascending, stably;
    optionally move a ``values`` pytree (leaves with leading dim n, any
    dtype) alongside.  Returns keys or (keys, values) on the keys' device.

    The ``repro_torch.ops`` entry points encode keys of every dtype of
    ``ops.keyspace`` first.
    """
    _check_config(cfg)
    _check_keys(keys, 1)
    n = keys.shape[0]
    if n <= 1:
        return keys if values is None else (keys, values)

    arrays = {"k": keys}
    if values is not None:
        payload, rebuild = _payload(values, keys)
        arrays.update(payload)
    with obs.trace("ips4o_sort", n=n, classifier=cfg.classifier):
        arrays = pad_with_sentinel(arrays, max(cfg.base_case, cfg.tile))
        arrays = _sort_levels(arrays, n, cfg)
    out_k = arrays["k"][:n]
    return out_k if values is None else (out_k, rebuild(arrays, n))


def _sort_levels(arrays: Arrays, n_real: int, cfg: SortConfig) -> Arrays:
    return _sort_padded(arrays, n_real, cfg, plan_levels(arrays["k"].shape[0], cfg))


def sort_padded(arrays: Arrays, n_real: int, cfg: SortConfig = SortConfig()) -> Arrays:
    """The pipeline of :func:`ips4o_sort` after its pad, for arrays that
    come padded: ``arrays["k"]`` (n_pad,) encoded int32/int64 keys whose
    first ``n_real`` > 1 are real and the rest the sentinel, n_pad the
    multiple of max(base_case, tile) that :func:`pad_with_sentinel` gives,
    every other tensor (n_pad, ...).  Returns the padded arrays, sorted.
    The ``ops`` entry points hand it the codes and index that the G5 kernel
    wrote padded (``kernels.codec.encode_padded``)."""
    _check_padded(arrays, n_real, cfg, 1)
    with obs.trace("ips4o_sort", n=n_real, classifier=cfg.classifier):
        return _sort_levels(arrays, n_real, cfg)


def tiebreak_passes(
    cols: Sequence[torch.Tensor],
    values: Any = None,
    cfg: SortConfig = SortConfig(),
) -> Tuple[List[torch.Tensor], Any]:
    """MSD tie-break schedule over multi-word keys (DESIGN.md §11).

    ``cols`` is each row's key as words, most significant first: W encoded
    int32 or int64 tensors of shape (n,) (the ``ops`` callers encode every
    word column).  The rows end up in stable lexicographic order, the
    permutation of ``np.lexsort`` over the columns, by the stability of
    :func:`ips4o_sort`.

    Level 0 sorts word 0.  Level l re-sorts the runs that still tie on
    words 0..l-1 by two stable passes carrying a pytree payload: by word l,
    then by run id, which restores each run's index range with word l
    ordered inside it.  Run ids are nonnegative int32 (uint32 in the
    reference; the order is the same).  Where the reference skips a level
    with no ties by ``lax.cond``, one host read per word decides here.

    Returns ``(sorted cols, values)``; ``values`` (a pytree of leaves with
    leading dim n) is moved through every pass.
    """
    cols = list(cols)
    if not cols:
        raise ValueError("tiebreak_passes: need at least one word column")
    n = cols[0].shape[0]
    if any(tuple(c.shape) != (n,) for c in cols):
        raise ValueError("tiebreak_passes: word columns must share shape (n,)")
    if n <= 1:
        return cols, values

    key, state = ips4o_sort(cols[0], {"rest": cols[1:], "v": values}, cfg=cfg)
    out: List[torch.Tensor] = [key]
    boundary = _run_heads(key)
    for _ in range(1, len(cols)):
        col, rest, v = state["rest"][0], state["rest"][1:], state["v"]
        if not bool(torch.all(boundary)):  # the host read: some run still ties
            # tie-run ids of the sorted prefix: nondecreasing, one per run
            seg = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
            col_a, st_a = ips4o_sort(col, {"seg": seg, "rest": rest, "v": v}, cfg=cfg)
            _, st_b = ips4o_sort(st_a["seg"], {"col": col_a, "rest": st_a["rest"],
                                               "v": st_a["v"]}, cfg=cfg)
            col, rest, v = st_b["col"], st_b["rest"], st_b["v"]
        state = {"rest": rest, "v": v}
        out.append(col)
        boundary |= _run_heads(col)
    return out, state["v"]


def _run_heads(col: torch.Tensor) -> torch.Tensor:
    """True where a run of equal keys starts in a sorted column."""
    head = torch.ones(col.shape, dtype=torch.bool, device=col.device)
    head[1:] = col[1:] != col[:-1]
    return head


def is4o_sort(keys: torch.Tensor, values=None, cfg: SortConfig = SortConfig()):
    """IS4o, the sequential instantiation: the same pass pipeline."""
    return ips4o_sort(keys, values, cfg)


def make_sorter(n: int, dtype: torch.dtype, cfg: SortConfig = SortConfig(),
                donate: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """A sorter for keys of shape (n,) and ``dtype`` (any ``ops.keyspace``
    dtype: the keys are encoded, sorted and decoded, NaNs last).  With
    ``donate=True`` the sorted keys are written back into the caller's
    tensor and it is returned: the in-place property the reference gets
    from buffer donation, here a copy back (ROADMAP.md, queue 3)."""
    from repro_torch.ops import keyspace  # lazy: ops layers on core

    keyspace.encoded_dtype(dtype)  # raises for dtypes with no order-preserving code

    def sorter(keys: torch.Tensor) -> torch.Tensor:
        if tuple(keys.shape) != (n,) or keys.dtype != dtype:
            raise ValueError(f"this sorter takes ({n},) {dtype} keys, got "
                             f"{tuple(keys.shape)} {keys.dtype}")
        out = keyspace.decode(ips4o_sort(keyspace.encode(keys), cfg=cfg), dtype)
        return keys.copy_(out) if donate else out

    return sorter
