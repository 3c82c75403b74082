"""The racing router: which classifier should "auto" run?

Counterpart of ``repro.classify.router``.  The radix extractor wins on
uniform keyspaces, the tree under heavy duplication, the learned CDF on
smoothly skewed inputs, so the router measures instead of guessing:

  * ``distribution_moments`` reduces a key array to a coarse label
    ("uniform" | "dup" | "sorted" | "skew") from three sample moments, on
    the host (a numpy copy of the reference's);
  * the plan cache races tree, radix and learned on the card and persists
    the winner under a ``clf:`` key (``ops.plan.PlanCache.classifier_plan``);
  * ``resolve_classifier`` maps "auto" to a persisted winner for this
    (n, dtype[, batch]), or to "tree" when nothing was raced, without
    looking at the data; ``classifier_for(x)`` is the data-aware path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs

__all__ = [
    "CLASSIFIERS",
    "resolve_classifier",
    "distribution_moments",
    "classifier_for",
]

CLASSIFIERS = ("tree", "radix", "learned")

# the moments' thresholds for the coarse label, as in the reference
_DUP_FRACTION = 0.5
_SORTEDNESS = 0.95
_TOPBITS_IMBALANCE = 4.0


def resolve_classifier(
    classifier: str,
    n: Optional[int] = None,
    dtype=None,
    batch: Optional[int] = None,
) -> str:
    """The engine for ``SortConfig.classifier``: a named engine passes
    through; "auto" takes the plan cache's raced winner for this shape
    (``PlanCache.classifier_hint``) and "tree" when nothing was raced.

    >>> resolve_classifier("radix")
    'radix'
    >>> resolve_classifier("auto")  # nothing raced: the safe default
    'tree'
    """
    if classifier in CLASSIFIERS:
        return classifier
    if classifier != "auto":
        raise ValueError(
            f"unknown classifier {classifier!r}; expected one of {CLASSIFIERS + ('auto',)}"
        )
    if dtype is not None and n is not None:
        from repro_torch.ops.plan import default_cache  # lazy: ops layers on classify

        hint = default_cache.classifier_hint(n, dtype, batch=batch)
        if hint is not None:
            obs.count("classifier.route", source="hint", winner=hint)
            return hint
    obs.count("classifier.route", source="default", winner="tree")
    return "tree"


def _host(x) -> np.ndarray:
    """A numpy copy of ``x`` (a tensor on any device, or array-like);
    bfloat16, which numpy lacks, as float32 (exact, order kept)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def distribution_moments(x, sample: int = 4096, seed: int = 0) -> str:
    """Coarse distribution label of a key array, on the host: "dup" when
    over half of a bounded sample repeats, "sorted" when 95% of a prefix's
    adjacent pairs do not descend, "skew" when the heaviest of 16
    equal-width value bins holds over 4x its share, else "uniform"."""
    flat = _host(x).reshape(-1)
    if flat.size == 0:
        return "uniform"
    # sortedness wants *adjacent* pairs: a contiguous prefix keeps them
    prefix = flat[:sample]
    xs = (np.random.default_rng(seed).choice(flat, size=sample, replace=False)
          if flat.size > sample else flat)
    dup = 1.0 - np.unique(xs).size / xs.size
    if dup > _DUP_FRACTION:
        return "dup"
    sortedness = float(np.mean(prefix[1:] >= prefix[:-1])) if prefix.size > 1 else 1.0
    if sortedness >= _SORTEDNESS:
        return "sorted"
    lo, hi = np.min(xs), np.max(xs)
    if hi > lo:
        bins = np.clip(((xs.astype(np.float64) - np.float64(lo))
                        / (np.float64(hi) - np.float64(lo)) * 16).astype(np.int64), 0, 15)
        counts = np.bincount(bins, minlength=16)
        if counts.max() * 16 / xs.size > _TOPBITS_IMBALANCE:
            return "skew"
    return "uniform"


def classifier_for(x: torch.Tensor, *, batch: Optional[int] = None, tune: bool = True,
                   cache=None) -> str:
    """Label ``x``'s distribution, then race (or look up) the engines for
    (n, dtype, label) on ``x`` itself, on its device; returns the winner
    ("tree" when nothing was raced).  The race is persisted, so later
    ``classifier="auto"`` calls of that shape resolve through it."""
    if cache is None:
        from repro_torch.ops.plan import default_cache as cache  # lazy
    n = x.shape[-1]
    b = x.shape[0] if x.dim() == 2 else batch
    with obs.trace("classifier.route_for", n=n, batch=b):
        label = distribution_moments(x)
        winner = cache.classifier_plan(n, x.dtype, dist=label, batch=b, tune=tune, x=x)
    winner = winner or "tree"
    obs.count("classifier.route", source="race", winner=winner, dist=label)
    return winner
