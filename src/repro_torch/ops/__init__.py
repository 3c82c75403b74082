"""repro_torch.ops — the sort operations of ``repro.ops`` ported so far:
NaN-safe ``sort`` and ``argsort`` (float32 and int32 keys) and the
``keyspace`` bijection."""
from repro_torch.ops import keyspace
from repro_torch.ops.sort import argsort, sort

__all__ = ["keyspace", "sort", "argsort"]
