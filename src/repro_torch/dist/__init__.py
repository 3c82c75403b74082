"""repro_torch.dist: the multi-level distributed sort on torch.distributed
(DESIGN.md §8), the counterpart of ``repro.dist``.

The paper's conclusion positions IPS4o as "the data distribution and local
sorting" engine of distributed-memory sorting (AMS-sort); this package is
that instantiation on a ``DeviceMesh``, one exchange level per mesh axis,
written as per-rank code (every rank calls with its own shard):

  levels.py    the explicit level schedule and capacities (a copy of the
               reference's pure-Python module)
  exchange.py  per-level sample -> classify -> stable partition (kernel K2
               on the card) -> all_to_all_single, with the observed-
               histogram re-split rounds and the overlapped exchange
  api.py       sort / argsort / topk / bottomk / group_by behind the
               keyspace encoding of ``repro_torch.ops``
  elastic.py   the same sort as a checkpointed level-boundary state
               machine, restorable after a lost rank (DESIGN.md §13)

Every exchange also takes ``overlap=True`` (half-shard staggering of the
collectives against partition work) and ``order="auto"`` (topology-aware
level ordering).  One H100 reaches world size 1 with NCCL; several ranks
on one card run with ``gloo``.
"""
from repro_torch.dist.api import argsort, bottomk, group_by, sort, topk
from repro_torch.dist.elastic import sort_elastic
from repro_torch.dist.levels import (
    Level,
    axis_bandwidths,
    order_axes,
    plan_schedule,
    schedule_cost,
)

__all__ = [
    "sort", "argsort", "topk", "bottomk", "group_by", "sort_elastic",
    "Level", "plan_schedule", "order_axes", "schedule_cost",
    "axis_bandwidths",
]
