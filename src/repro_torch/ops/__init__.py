"""repro_torch.ops — the sort operations of ``repro.ops``: NaN-safe
``sort``, ``argsort``, ``topk`` and ``bottomk`` (keys of every dtype of
``keyspace``: 8- to 64-bit ints, uints and floats), the multi-word
``sort_records`` / ``argsort_records``, their batched (B, n) forms,
``segmented_sort``, the grouping ops ``unique``, ``run_length`` and
``group_by``, the ``keyspace`` bijection and word codec, and the plan cache
``PlanCache`` / ``get_sorter``."""
from repro_torch.core.ips4o import SortConfig
from repro_torch.ops import keyspace
from repro_torch.ops.batched import (
    batched_argsort,
    batched_bottomk,
    batched_sort,
    batched_topk,
    with_engine_batched,
)
from repro_torch.ops.groupby import Groups, group_by, run_length, unique
from repro_torch.ops.plan import PlanCache, default_cache, get_sorter
from repro_torch.ops.segmented import segmented_sort
from repro_torch.ops.sort import argsort, argsort_records, sort, sort_records, with_engine
from repro_torch.ops.topk import bottomk, topk

__all__ = [
    "SortConfig",
    "keyspace",
    "sort",
    "argsort",
    "sort_records",
    "argsort_records",
    "with_engine",
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
    "PlanCache",
    "default_cache",
    "get_sorter",
]
