"""repro_torch — the PyTorch/CUDA port of ``repro`` (IPS4o) for one NVIDIA H100.

It mirrors ``repro``'s layout and names, imports ``torch`` and numpy and
never ``jax`` or ``repro``, and runs its hand-written CUDA kernels
(``repro_torch.kernels``) on the card.  Ported, with the tree and radix
classifiers, for keys of every dtype of ``ops.keyspace`` (8- to 64-bit
ints, uints and floats): the 1-D and batched (B, n) sorts
(``ops.sort``/``argsort``/``topk``/``bottomk``, ``ops.batched_*``),
``ops.segmented_sort``, the grouping ops (``ops.unique``, ``run_length``,
``group_by``), the out-of-core stream (``stream.external_sort``,
``external_argsort``, ``streaming_topk``, ``streaming_group_by``,
``merge``; 64-bit keys merge through K5's int64 form), the in-place block
moves (``core.partition.partition_blocks``, ``kernels.ops.sort_blocks``,
``kernels.ops.permute_blocks_inplace``), the classify + histogram entry
points (``kernels.classify``, raw keys of every dtype, int32 or int64
radix codes) and the out-of-place baseline ``core.s3sort.s3_sort``.
Beside them: the
observability layer ``obs`` (spans with CUDA-event device times, metrics,
exporters; off unless ``REPRO_OBS=1`` or ``obs.enabled(True)``), the
multi-level distributed sort ``dist`` over ``torch.distributed`` (per-rank
``sort``/``argsort``/``topk``/``bottomk``/``group_by`` on a
``DeviceMesh``, and the restorable ``sort_elastic``) and its sharded
``checkpoint.CheckpointManager``, LM serving and training, and the
launch and cost tooling.  ROADMAP.md lists what is still open.
"""
