"""repro_torch.classify — the bucket-id contract of ``repro.classify``.

Every classifier maps keys to local bucket ids in [0, 2k), monotone in the
key order, with odd ids reserved for equality buckets (runs of identical
keys, skipped by deeper levels and by the base case).  Two engines are
ported: "tree" (sampled splitters, ``classify/tree.py``) and "radix" (the
next log2(k) key bits, ``classify/radix.py``).  "learned" and the "auto"
router are still to be ported (ROADMAP.md, queue 1 item 5).
"""
from repro_torch.classify.radix import radix_bucket_ids, radix_shift
from repro_torch.classify.tree import (
    classify,
    classify_batched,
    classify_segmented,
    num_local_buckets,
)

__all__ = [
    "CLASSIFIERS",
    "resolve_classifier",
    "classify",
    "classify_batched",
    "classify_segmented",
    "num_local_buckets",
    "radix_bucket_ids",
    "radix_shift",
]

CLASSIFIERS = ("tree", "radix")
_NOT_PORTED = ("learned", "auto")


def resolve_classifier(classifier: str) -> str:
    """The engine for ``SortConfig.classifier``: a ported engine passes
    through; "learned" and "auto" raise ``NotImplementedError``.

    >>> resolve_classifier("radix")
    'radix'
    """
    if classifier in CLASSIFIERS:
        return classifier
    if classifier in _NOT_PORTED:
        raise NotImplementedError(
            f"classifier {classifier!r} is not ported yet; only {CLASSIFIERS} "
            "(see ROADMAP.md, queue 1 item 5)"
        )
    raise ValueError(
        f"unknown classifier {classifier!r}; expected one of "
        f"{CLASSIFIERS + _NOT_PORTED}"
    )
