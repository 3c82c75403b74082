"""repro_torch.kernels — the port's hand-written CUDA kernels for Hopper.

| kernel | wrapper | source | replaces |
| --- | --- | --- | --- |
| K1 | ``level_fused.level_fused`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:160`` |
| K1r | ``level_fused.level_fused(classifier="radix")`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:160`` |
| K2 | ``level_fused.rank_hist`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:311`` |
| K3 | ``bitonic.sort_windows`` | ``csrc/bitonic.cu`` | ``repro/kernels/bitonic.py:72`` |
| K4 | ``level_fused.level_fused_batched`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:240`` |
| K4 | ``level_fused.rank_hist_batched`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:364`` |
| K5 | ``merge_path.merge_path_perm`` | ``csrc/merge_path.cu`` | ``repro/kernels/merge_path.py:157`` |
| K6 | ``dispatch_rank.dispatch_ranks`` | ``csrc/dispatch_rank.cu`` | ``repro/kernels/dispatch_rank.py:87`` |
| K6 | ``dispatch_rank.partition_ranks`` | ``csrc/dispatch_rank.cu`` | ``repro/kernels/dispatch_rank.py:154`` |
| K6 | ``dispatch_rank.partition_ranks_batched`` | ``csrc/dispatch_rank.cu`` | ``repro/kernels/dispatch_rank.py:224`` |
| K7 | ``classify.classify_histogram`` | ``csrc/classify.cu`` | ``repro/kernels/classify.py:100`` |
| K7 | ``classify.classify_histogram_batched`` | ``csrc/classify.cu`` | ``repro/kernels/classify.py:153`` |
| K7 | ``classify.radix_histogram`` (and ``radix_histogram_batched``) | ``csrc/classify.cu`` | ``repro/kernels/classify.py:222`` |
| K8 | ``block_permute.permute_blocks_by_dest`` | ``csrc/block_permute.cu`` | ``repro/kernels/block_permute.py:145`` |
| K9 | ``permute_inplace.permute_blocks_inplace`` | ``csrc/permute_inplace.cu`` | ``repro/kernels/permute_inplace.py:148`` |
| K10 | ``flash_decode.flash_decode`` (and ``flash_decode_cache``) | ``csrc/flash_decode.cu`` | ``repro/kernels/flash_decode.py:70`` |
| K11 | ``flash_attention.flash_attention`` (bf16: TMA + ``wgmma``; f32: FMA) | ``csrc/flash_attention.cu`` | ``repro/kernels/flash_attention.py:102`` |
| G1 | ``glue.close_placement`` (K1/K1r/K4's placement close) | ``csrc/glue.cu`` | no kernel: XLA's ``_close_placement``, ``repro/kernels/level_fused.py:136`` |
| G2 | ``glue.segment_ids`` | ``csrc/glue.cu`` | no kernel: XLA's ``segment_ids``, ``repro/core/ips4o.py:229`` |
| G3 | ``glue.composite_ids`` (level 2's ids, tree or radix; int32 and int64 keys) | ``csrc/glue.cu`` | no kernel: XLA's ``classify_segmented``, ``repro/classify/tree.py:83`` |
| G4 | ``glue.scatter_rows`` and ``glue.gather_windows`` (each one launch for every tensor) | ``csrc/glue.cu`` | no kernel: XLA's ``.at[dest].set`` and ``_apply_window_perm``, ``repro/core/ips4o.py:376``, ``:246`` |
| G5 | ``codec.encode_padded`` and ``codec.decode`` (``ops.keyspace`` on the card) | ``csrc/codec.cu`` | no kernel: XLA's ``encode``/``decode``, ``repro/ops/keyspace.py:94``, ``:118``, and the pad, ``repro/core/ips4o.py:289`` |
| G6 | ``glue.sample_splitters`` (both levels' samples to splitters) | ``csrc/glue.cu`` | no kernel: XLA's samples, ``repro/core/ips4o.py:356``, ``:442``, ``repro/core/sampling.py:76``, ``:88`` |
| G7 | ``fallback.oversized_list`` and ``fallback.sort_listed`` (the robustness fallback) | ``csrc/fallback.cu`` | no kernel: XLA's ``bucket_violations`` and ``lax.cond`` sort, ``repro/core/ips4o.py:499``, ``:540`` |

K1, K1r, K4 ``level_fused_batched`` and K3 take int32 or int64 codes: each
has a 64-bit form for the 64-bit key dtypes, launched by the same wrapper
and counted under its name with ``64`` appended.
K1, K1r, K4 ``level_fused_batched``, K2's rank above W2 = 32 and K6 rank
a tile the same way (peer masks by atomicOr, 16-bit per-warp counters,
ranks in registers, a scan over the warps).  K2 and K4 ``rank_hist_batched``
close their placement on the card in four launches (items, count,
per-segment scan, rank); K6 closes it in one, carrying the earlier tiles'
counts by decoupled look-back.
K8 and K9 move blocks in the caller's tensor and return it.  K10 reads the
decode cache in place, through strides.  G1-G4 are the sort's glue, which
the reference leaves to XLA between its kernels: K1's placement close, the
segment ids, level 2's composite ids, and one move kernel for the level
scatters (staged by bucket when the placement's offsets are given) and the
base case's window gathers (in place for pass two); G3's int64 form counts
under ``composite_ids64``.  G5-G7 finish the one-device sort's glue: the
keyspace codec with the pad (``codec_encode``, ``codec_decode``), the level
passes' samples (``sample_splitters``) and the robustness fallback with no
host read (``fallback_list``, ``fallback_sort``: a cooperative launch).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain torch twin only on a CPU tensor.  The kernels are built with ``nvcc``
on first use (``_build``); importing this package builds nothing.
"""
from typing import Dict

from repro_torch.kernels._build import LAUNCHES, build_all

__all__ = ["launch_counts", "reset_launch_counts", "build_all"]


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
