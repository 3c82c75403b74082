"""repro_torch.ops — the sort operations of ``repro.ops`` ported so far:
NaN-safe ``sort``, ``argsort``, ``topk`` and ``bottomk`` (keys of every
dtype of ``keyspace``: 8- to 64-bit ints, uints and floats), their
batched (B, n) forms, ``segmented_sort``, the grouping ops ``unique``,
``run_length`` and ``group_by``, and the ``keyspace`` bijection."""
from repro_torch.ops import keyspace
from repro_torch.ops.batched import (
    batched_argsort,
    batched_bottomk,
    batched_sort,
    batched_topk,
    with_engine_batched,
)
from repro_torch.ops.groupby import Groups, group_by, run_length, unique
from repro_torch.ops.segmented import segmented_sort
from repro_torch.ops.sort import argsort, sort
from repro_torch.ops.topk import bottomk, topk

__all__ = [
    "keyspace",
    "sort",
    "argsort",
    "topk",
    "bottomk",
    "batched_sort",
    "batched_argsort",
    "batched_topk",
    "batched_bottomk",
    "with_engine_batched",
    "segmented_sort",
    "unique",
    "run_length",
    "group_by",
    "Groups",
]
