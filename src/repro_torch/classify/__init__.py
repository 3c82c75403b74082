"""repro_torch.classify — the bucket-id contract of ``repro.classify``.

Every classifier maps keys to local bucket ids in [0, 2k), monotone in the
key order, with odd ids reserved for equality buckets (runs of identical
keys, skipped by deeper levels and by the base case).  This slice ports
the "tree" engine only; "radix", "learned" and "auto" are still to be
ported (ROADMAP.md, queue 1 item 5).
"""
from repro_torch.classify.tree import classify, classify_segmented, num_local_buckets

__all__ = ["CLASSIFIERS", "classify", "classify_segmented", "num_local_buckets"]

CLASSIFIERS = ("tree",)
