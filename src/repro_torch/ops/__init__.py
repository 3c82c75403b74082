"""repro_torch.ops — the sort operations of ``repro.ops`` ported so far:
NaN-safe ``sort``, ``argsort``, ``topk`` and ``bottomk`` (float32 and int32
keys), their batched (B, n) forms, and the ``keyspace`` bijection."""
from repro_torch.ops import keyspace
from repro_torch.ops.batched import (
    batched_argsort,
    batched_bottomk,
    batched_sort,
    batched_topk,
    with_engine_batched,
)
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
]
