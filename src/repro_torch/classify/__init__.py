"""repro_torch.classify — the bucket-id contract of ``repro.classify``.

Every classifier maps keys to local bucket ids in [0, 2k), monotone in the
key order, with odd ids reserved for equality buckets (runs of identical
keys, skipped by deeper levels and by the base case).  Three engines, as
in the reference: "tree" (sampled splitters, ``classify/tree.py``),
"radix" (the next log2(k) key bits, ``classify/radix.py``) and "learned"
(a piecewise-linear CDF fitted on the sample with a measured-imbalance
fallback to the tree, ``classify/learned.py``); "auto" is the racing
router of ``classify/router.py`` and the plan cache.
"""
from repro_torch.classify.learned import (
    IMBALANCE_THRESHOLD,
    NUM_KNOTS,
    eval_cdf_buckets,
    fit_cdf_knots,
    learned_bucket_ids,
    learned_bucket_ids_batched,
    learned_fit,
    learned_model_ids,
    sample_imbalance,
)
from repro_torch.classify.radix import radix_bucket_ids, radix_shift
from repro_torch.classify.router import (
    CLASSIFIERS,
    classifier_for,
    distribution_moments,
    resolve_classifier,
)
from repro_torch.classify.tree import (
    classify,
    classify_batched,
    classify_segmented,
    num_local_buckets,
)

__all__ = [
    "CLASSIFIERS",
    # tree
    "classify",
    "classify_batched",
    "classify_segmented",
    "num_local_buckets",
    # radix
    "radix_bucket_ids",
    "radix_shift",
    # learned
    "NUM_KNOTS",
    "IMBALANCE_THRESHOLD",
    "fit_cdf_knots",
    "eval_cdf_buckets",
    "sample_imbalance",
    "learned_fit",
    "learned_model_ids",
    "learned_bucket_ids",
    "learned_bucket_ids_batched",
    # router
    "resolve_classifier",
    "distribution_moments",
    "classifier_for",
]
