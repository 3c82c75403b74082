"""repro_torch.stream — out-of-core streaming sort (DESIGN.md §7).

Counterpart of ``repro.stream``: IPS4o as the run-forming engine over
device-sized chunks plus a stable k-way merge.  Three layers:

  runs.py   chunk a host-resident (or generator-fed) keyset and sort each
            chunk with ``ops.sort``/``argsort``, copying chunk i+1 from
            pinned memory on a side stream under the sort of chunk i;
  merge.py  stable k-way merge of sorted runs: a tournament of pairwise
            merges, each the K5 merge-path permutation;
  api.py    the entry points ``external_sort``, ``external_argsort``,
            ``streaming_topk`` and ``streaming_group_by``, whose device
            footprint is bounded by the chunk or pair being processed.

Its callers in the port: ``data.pipeline.pack_by_length(chunk_size=)``
(``external_argsort``) and ``serve.scheduler``'s merged backlog view
(``merge``).
"""
from repro_torch.stream.api import (
    external_argsort,
    external_sort,
    streaming_group_by,
    streaming_topk,
)
from repro_torch.stream.merge import merge, merge_perm
from repro_torch.stream.runs import form_argsort_runs, form_runs, iter_chunks

__all__ = [
    "external_sort",
    "external_argsort",
    "merge",
    "merge_perm",
    "streaming_topk",
    "streaming_group_by",
    "form_runs",
    "form_argsort_runs",
    "iter_chunks",
]
