#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails.  Phases 2-4 run first
for the sort kernels and paths, then, after their tensors are freed, again
for the attention kernels and the serve path, and last (3 and 4) for the
observability layer and the distributed sort:

1. set-up: print the card's name and power limit, build every kernel from
   ``src/repro_torch/csrc`` with ``nvcc`` (into ``build/``);
2. each kernel against its plain torch twin on the card.  The sort kernels
   bit for bit (``torch.equal``; tolerance 0, the outputs are integers):
   K1 at n = 2^24, k = 128 with pads on Uniform and TwoDup, K2 on the
   composite ids of a real level 1 at n = 2^24 (nb = 65,792) and on small
   nb, K3 on 2048 windows of W = 8192 with heavy duplicates (and on 65,536
   windows of 256 and 1024 of 16384), K1r (radix
   mode) at n = 2^24 with pads, K4 ``level_fused_batched`` at (64, 2^18) in
   both modes with pads, K4 ``rank_hist_batched`` on the composite ids
   of a real batched level 1 at (64, 2^18), K5 ``merge_path_perm`` at
   2^24 + 2^24 duplicate-heavy keys and at ragged sizes, and K6 as
   ``dispatch_ranks`` on the MoE routing of 2^21 tokens x top-6 over 64
   experts (uniform and skewed), ``partition_ranks`` at n = 2^24, nb = 257
   (non-prefix starts, trash ids) and ``partition_ranks_batched`` at
   (64, 2^18), nb = 257, K7 ``classify_histogram`` on raw float32 (NaN,
   +-0.0, +-inf, finfo.max sprinkled in), int32 TwoDup and bfloat16 keys at
   n = 2^24, k = 128, and on skewed float32 keys (all equal, all on one
   splitter, 70% NaN, sorted, Zipf), ``classify_histogram_batched`` at
   (64, 2^18) with per-row splitters and ``radix_histogram`` (and its
   batched form) at k = 256, K8 ``permute_blocks_by_dest`` on 2^28 + 1000 int32 keys (262,144
   blocks of 1024 and a partial tail; block buckets uniform over 256 and
   half in one bucket, and one cycle through every block; and 65,536 blocks
   of 4096, 16 KB each, taken by a CTA team) and K9
   ``permute_blocks_inplace`` at the same N and in five cases that stress
   its claiming at N = 4096, five runs each (k = 1, every block already in
   its range, empty buckets, all blocks but one in one bucket, uniform).
   The 64-bit forms (the int64 codes of the 64-bit key dtypes): K1 at n =
   2^24, k = 128 with pads on float64 Uniform (a third negated, NaN, +-0.0
   and +-inf sprinkled in) and int64 TwoDup, K1r on int64 and uint64 over
   the whole range (level 1 and a level-2 shift), K4 ``level_fused_batched``
   at (64, 2^18) in both modes, K3 on 2048 windows of 8192, 65,536 of 256
   and 1024 of 16384, heavy duplicates at the int64 extremes, and at every
   W from 2 to 16384 on 2049 windows (a partial last CTA), descending
   windows among them.
   The glue kernels (``csrc/glue.cu``, no TPU kernel's counterpart: the
   XLA the reference runs between its kernels) bit for bit: G1
   ``close_placement`` on K1's tile histograms at 2^24 with pads, on K4's
   (64, 2^18) rows and with all keys in one bucket; G2 ``segment_ids`` on
   level 1's offsets (nb 257), level 2's (nb 65,792), 64 rows and one
   bucket; G3 ``composite_ids`` on the 1-D and batched level 2, int64 codes
   (``composite_ids64``), radix mode and 4097 segments; G4 ``scatter_rows``
   of payload rows of 1, 2, 4, 8, 12 and 16 bytes, all six tensors in one
   launch, by the level-1 and level-2 placements (planned by bucket), by a
   permutation (row by row) and on (64, 2^18) rows, and ``gather_windows``
   of the same rows in one launch, into new tensors and in place, and on
   the 64 rows with a limit (pass one into copies, pass two in place); in
   phase 3 ``ops.sort`` and ``ops.argsort`` of 2^24 float32 make one G4
   launch a level and a pass, and phase 4 times G4 at every span and stage
   count the wrappers can take (``launch scatter_rows``/``gather_windows``
   lines: registers, shared memory, CTAs an SM);
   G5 ``codec_encode``/``codec_decode`` on the twelve key dtypes (NaN,
   -NaN, +-0.0, +-inf, a subnormal) at 2^20 + 3 keys and (64, 2^14) rows,
   padded with and without the index and the complement, and on the main
   path's 2^24 float32; G6 ``sample_splitters`` at level 1 ((1, 2^24), m =
   512, k = 128 with the upper form; (64, 2^18); int64 codes at m = 8192)
   and level 2 (the real level-1 offsets; crafted ones with empty segments,
   an empty last one, a uniform just below 1); G7 ``fallback_list`` and
   ``fallback_sort`` (two launches a call) on the main path's real buckets
   (1-D with and without ``limit``, batched, double) and on crafted offsets
   (a bucket holding the whole row of 2^24, buckets of W/2+1, C-1, C, C+1 and
   3C+5 keys, rows of other counts with equal keys, ``limit``, an empty
   list), int32 and int64 codes, with an index and payload rows of 1-16 B.
   K9 is not stable, so each of its outputs is held to its plain twin (the
   replay of the reference's moves) by intact blocks and, per bucket, the
   blocks sorted by their tag; the twin is held to ``permute_blocks_ref``
   the same way.  K8 and K9 must be in place: the same ``data_ptr`` and a
   peak-memory rise of at most a quarter of the data.
   The attention kernels within |got - want| <= atol + rtol * |want| (2e-5
   + 2e-5 in float32, 4e-3 + 2^-8 in bfloat16; their ``max_abs_err`` in the
   kernels line is a float), and each limit shown to flag a fault, the
   twin's output with one tile of 64 keys dropped: K10 ``flash_decode`` at
   yi-9b's decode shape (B = 8, H = 32, KVH = 4, hd = 128, T = 4096)
   reading the strided (B, T, KVH, hd) cache with ragged lengths {1, 1, 17,
   1024, 1025, 2048, 4095, 4096}, in both dtypes, and once on the
   pre-expanded (B, H, T, hd) copy; K11 ``flash_attention`` at (1, 32,
   4096, 128) causal, causal with window 1024, and non-causal at S = 2048,
   in both dtypes (bfloat16 is the ``wgmma`` kernel, row
   ``flash_attention``; float32 the 3xTF32 ``wgmma`` kernel, row
   ``flash_attention_f32``);
3. the paths, each driven with the launch counts set to 0 just before it
   and read just after, every kernel of the path required to be > 0
   (the two-level sorts' glue kernels G1-G7 among them):
   the 1-D tree sort (``ops.sort``/``argsort`` at n = 2^24 and 2^17), the
   1-D radix sort (n = 2^24 int32 full range and float32 Uniform), the
   batched tree sort (bulk (64, 2^18) float32 with ``batched_sort``,
   ``batched_argsort``, ``batched_topk`` and ``batched_bottomk`` at k = 64,
   and the scheduler's (256, 512) int32 rows at W = 256), the batched
   radix sort ((64, 2^18) int32 full range), the out-of-core stream
   (``stream.external_sort``/``external_argsort`` of 2^28 float32 keys in
   16 chunks of 2^24, 4 tournament rounds with host spills), the streaming
   top/bottom-k (k = 1024) over the same stream, ``streaming_group_by`` of
   2^26 int32 RootDup keys in chunks of 2^22, the grouping ops
   (``group_by`` "pallas" and "partition" on the MoE routing,
   ``moe_group_tokens``, ``partition_ranks_kernel`` over per-layer routing
   rows), ``segmented_sort`` (4096 ragged segments over 2^24 keys), the
   block path (``partition_blocks`` of 2^28 int32 keys and an int32 payload
   in place by K8, and ``sort_blocks``), ``s3_sort`` (the out-of-place
   baseline, 2^24 float32 with a payload) and the K7 and K9 entry points;
   the seven calls ``ops.sort``, ``argsort``, ``topk`` (k = 1024),
   ``batched_sort`` (64, 2^18), double, radix and ``segmented_sort`` at 2^24
   under ``torch.cuda.set_sync_debug_mode("error")`` with obs off (a
   synchronizing call fails the run);
   every key dtype: ``ops.sort`` and ``argsort`` on the paper's element
   types at 2^24 (double, Pair, Quartet, 100Bytes: float64 or uint64 keys
   with 0, 1, 3 or 12 uint64 payload words), double once at 2^27 (kmax =
   256, slack 4), int64 TwoDup by argsort, uint64 and float64 over the
   whole range by radix, ``topk``/``bottomk`` of float64 at k = 1024,
   ``batched_sort``/``batched_argsort`` of (64, 2^18) float64,
   ``segmented_sort`` of int64 (4096 ragged segments over 2^24),
   ``group_by``/``unique`` of 2^24 int64 RootDup, ``TPU_BIG_PAYLOAD`` on
   2^23 doubles, and ``ops.sort`` of 2^24 keys of each of int8, uint8,
   int16, uint16, float16, bfloat16 and uint32 with both classifiers; the
   64-bit paths must launch the 64-bit forms.  Payload pytrees: ``ops.sort``
   of 2^24 float32 and ``batched_sort`` of (64, 2^18) with a payload of an
   int64, an (n, 4) float32, a bfloat16 and a None leaf, and ``group_by``
   (by sort and by partition, K6) with it, each leaf held to the gather by
   the stable argsort.  Records: ``argsort_records`` and ``sort_records``
   (with a payload) of SkySurvey and TenantTuples at 2^24 records (3 words)
   and UrlPaths and RnaSequences at 2^20 clipped to 8 bytes, by the tree,
   radix and auto classifiers, against an LSD cascade of
   ``torch.sort(stable=True)`` over the encoded words (itself held to
   ``oracle_argsort`` at 2^20), with the tie-break passes taken.  The
   learned classifier: ``ops.sort``/``argsort`` at 2^24 float32 on Uniform
   (the model kept, K2 at level 1, no K1) and Zipf (the fallback taken,
   K1), and ``batched_sort``/``batched_argsort`` of (64, 2^18) (K4
   ``rank_hist_batched`` at level 1), the level-1 picks and the K1/K2
   kernels a call by the profiler's names.  The plan cache, at a temporary
   path: ``classifier_for`` racing at 2^22, tuned ``sort`` and ``topk``
   sorters at 2^22, and ``external_sort`` of 2^26 float32 in chunks of
   2^22 with ``tune=True``; its winners printed, the JSON reloaded to the
   same plans, the outputs against ``torch.sort``/``np.sort``.
   Every result is held to ``torch.sort(stable=True)`` of the port's
   encoded keys on the card (per row or per segment; of the raw keys for
   ``s3_sort``), the top/bottom-k to the sorted prefix, the group-by to
   ``torch.unique``, the block moves to the gather by the stable block
   order; then the peak device memory per key of ``partition_blocks``,
   ``s3_sort`` and ``ops.sort``.  Then the key dtypes that the stream,
   K7, ``s3_sort`` and the block path take since K5's int64 form and K7's
   key kinds (``dtype_phases``): K5 on int64 codes (2^24 + 2^24
   duplicate-heavy, LLONG_MAX tails, ragged sizes) and K7 on raw float64,
   int64, uint64, uint32, float16, uint16, int16, int8 and uint8 keys at
   2^24, k = 128, batched on (64, 2^18) float64 and in radix mode on int64
   codes, each bit for bit its plain twin and driven once per key kind;
   ``external_sort``/``external_argsort`` of 2^27 float64 in chunks of
   2^23, ``streaming_topk`` both ways of 2^28 bfloat16 keys from a CPU
   tensor in chunks of 2^24, ``streaming_group_by`` of 2^26 RootDup uint16,
   ``s3_sort`` of 2^24 float64 with an int64 payload and ``sort_blocks`` of
   2^27 int64 keys in place by K8 (~30 s).  After the serve path (below), last of
   all, the observability layer and the distributed sort: ``path obs`` (obs enabled, ``ops.sort`` of 2^24
   float32 Uniform: the span tree ``ops.sort > ips4o_sort > level_pass(1) >
   sample/classify/partition``, ``level_pass(2)``, ``base_case``, each span
   with a ``device_ms`` no smaller than its children's sum, +1 us;
   ``sort.bucket_imbalance`` and ``sort.largest_bucket`` equal to plain
   torch's from the call's own offsets; ``sort.fallback_engaged`` equal to
   the fallback's verdict; the JSONL and Chrome-trace exports parsed; the
   span names in a torch.profiler trace; and, obs disabled, the call's
   launch calls, device kernels and synchronizing calls, counted by the
   profiler and ``torch.cuda.set_sync_debug_mode``, equal to those with the
   hooks replaced by no-ops), ``path dist`` at world size 1 on NCCL
   (``dist.sort``, ``argsort``, ``topk``/``bottomk`` at k = 1024 and
   ``group_by`` of 2^24 float32 Uniform and int32 TwoDup, equal to ``ops.*``
   and ``torch.sort(stable=True)``; one H100 takes NCCL at world size 1
   only) and, in four ``gloo`` processes on the one card (spawned after the
   kernels are built, a ``file://`` rendezvous), on the meshes (4,) and
   (2, 2) with 2^22 keys a rank: Uniform, TwoDup and Zipf keys, a payload
   pytree, the radix classifier on full-range int32 keys, overlap against
   sync, ``order="auto"`` and a slack of 0.05 (the same flags and
   truncation twice), each rank's valid range held to its slice of
   ``torch.sort(stable=True)`` of the whole input, rank 0's profile
   showing K1, K2 and K3, and the scheduler's ``next_batch(mesh=)`` on a
   queue of 65,536 (three admissions equal to the oracle on every rank)
   and ``pack_by_length(mesh=)`` of 8192 documents (its length order
   sorts them, its rows equal the single-device pack's); ``path
   elastic``: ``sort_elastic`` at world size
   1 (NCCL) and on the four ranks, killed after level 1 and restored in a
   fresh process group, equal to the uninterrupted sort and to
   ``dist.sort``.  Last, with the card's memory emptied:
   K11's entry point on layer 0's q, k, v of the served prompts (the
   prefill shape, 8 x 1024 tokens, through strides, in bfloat16 and in
   float32) against its twin, and
   the serve path: yi-9b at full width and depth (48 layers, bf16, random
   weights from a seeded CUDA generator), ``Engine`` with
   ``ServeConfig(max_seq=4096, batch_size=8)``, 8 prompts of 1024 tokens,
   32 new tokens, greedy, under ``compute_policy(flash_decode=True)``; K10
   must launch once per layer per decode step; two ``generate`` calls must
   give equal tokens; teacher forced over the generated sequence, the K10
   decode logits against the eager decode on the same cache and prefill +
   decode against the full forward, each within 5% of the largest logit;
   the greedy tokens of the K10 and eager paths compared as a measure.
   Then the scheduler and the data pipeline (``scheduler_phases``):
   ``Scheduler.next_batch`` on a queue of 65,536 requests (remaining in
   [1, 4096], batch 256, three admissions), ``admit_many`` over 64 queues
   of 4096 (below W: one stable torch sort a row, no port kernel, as the
   reference plans it) and of 16,384 (K4), ``attach_backlog`` of 16,384
   requests and ``next_batch`` on the merged view (K5), each held to the
   host oracle ``np.lexsort((arrival, remaining))``, backlog first on
   ties; the length argsort of ``pack_by_length`` at 2^22 documents
   against ``torch.sort(stable=True)`` and whole packs of 8192 documents
   (1-D and ``chunk_size=2048``) against the CPU's.  Then the other served
   families at full width (``family_phases``): K10 at deepseek-moe-16b's
   (group 1, hd 128: the tensor-core kernel) and zamba2-2.7b's (group 1,
   hd 80: the FMA kernel) decode shapes against its twin, the limit shown
   to flag a dropped tile; deepseek-moe-16b (28 layers, 64 experts top-6,
   2 shared), rwkv6-1.6b (24 layers) and zamba2-2.7b (54 Mamba2 layers,
   shared attention every 6), bf16, random weights, each serving 8
   requests admitted by ``next_batch`` from a queue of 65,536 (held to
   the oracle), 1024 prompt tokens, 32 new, greedy, ``flash_decode``: K10
   once per attention layer per decode step (896, 0, 288), K6
   ``dispatch_ranks`` once per MoE layer per forward, two calls equal, K6's
   dispatch bit for bit against the plain dispatch on every served MoE
   layer call (the dropped entries printed); teacher forced, prefill +
   decode (through K10) against the full forward within 5% of the
   largest logit, in float32 (bf16 rounding alone moves these models):
   rwkv6 whole over 1024 + 32 and zamba2 whole over 1024 + 128, their
   bf16-stored states in float32 too, and the MoE on two of its layers at
   full width at lossless capacity over 1 x (128 + 32).  Then training
   (``train_phases``, before the distributed sort): deepseek-moe-16b at
   published width, 4 of its 28 layers (2.771 B parameters, bf16, remat),
   eight ``Trainer.run`` steps of 4 x 4096 tokens in microbatches of 2 on one
   fixed batch: every loss finite and the last below the first, K6
   ``dispatch_ranks`` launched 16 times a step (4 layers x 2 microbatches x
   forward and recompute), every dispatch's ``dest`` bit for bit the plain
   ``partition_permutation``'s; reduced deepseek-moe-16b and yi-9b in
   float32: ``train_loss`` and every gradient on the card against the
   CPU's, two ``make_train_step`` steps with and without
   ``compress_grads`` against the CPU's, two ``Trainer`` runs from one seed
   bitwise equal, and a restart (3 steps, a checkpoint, a restore in a
   fresh ``Trainer``, 3 more) bitwise equal to 6 straight steps.  Last, the
   launch tooling (``launch_phases``): ``path ep`` (one deepseek-moe-16b
   MoE layer at published width, float32, 8 x 1024 tokens, expert parallel
   on a (1, 1) NCCL mesh bit for bit the baseline's, then on four gloo
   ranks sharing the card within 2e-5 + 2e-5, one K6 launch a rank with
   ``dest`` equal to the plain one), ``path train sharded`` (the reduced
   models' steps over the (1, 1) mesh bit for bit those without; the
   full-width training case over it with ``explicit_ep``) and ``path
   dryrun`` (the dry run of eight cells in a child process, no row an
   error, and ``launch.report``'s table);
4. timing with CUDA events (median of several runs after warm-up): each
   kernel beside its plain twin, its bound and, where one exists, one
   torch call that computes the same function, and each kernel's own
   device time by torch.profiler (``device_ms``: events around the wrapper
   also time its host work); K1's and K5's device kernels per call (one
   each) and their launches (registers, shared memory, threads, CTAs an SM
   from ``cudaFuncGetAttributes``); K2's and K4 ``rank_hist_batched``'s
   kernels per call (at most 5; the four kernels' device times) and their
   rank kernel's launch; K6's kernels per call (one) and its launch, and
   the memset of its scratch; K7's launch by key width against
   ``classify.schedule`` and its skewed keys beside uniform ones; each entry point beside
   ``torch.sort`` (per row: ``dim=1``) and ``torch.topk``, and K8/K9 beside
   the out-of-place ``index_select`` of the blocks; profiles of
   three sorts and of one ``external_sort`` (device time, idle share,
   host <-> device copies), the 1-D tree sort's with every kernel listed,
   which fails the run if it launches a ``searchsorted``, ``index_put`` or
   ``nonzero`` kernel, copies from the host, or makes more than 40 kernel
   launches; G5-G7 at the main path's shapes (G7 also at its empty list and
   at one bucket of 2^24) and G7's launch; the serve path's prefill ms and decode ms per
   step and tokens/s on the K10 and the eager path, K10 (at the last
   step's length, 1056) and K11 (at (1, 32, 4096, 128), bf16 and f32,
   causal, window 1024 and non-causal, and the f32 kernel's launch:
   threads, registers, shared memory, CTAs) beside
   ``scaled_dot_product_attention`` (K10 with a boolean length mask), and
   a profile of 8 decode steps (device time, launches, idle share); K10
   also at one request of length 4096 and at the ragged lengths beside
   SDPA, its device kernels per call counted by torch.profiler (it must be
   one: no memset, no combine launch) and its launch (registers and shared
   memory per CTA, cluster size) from ``cudaFuncGetAttributes``; K8 also
   with the half-in-one-bucket and one-cycle ``dst`` and at 16 KB blocks
   beside ``index_select``, and its teams (chains in flight);
   The 64-bit forms at the 64-bit paths' shapes (K1 on 2^24 doubles, K1r
   on 2^24 uint64, K4 on (64, 2^18) float64, K3 on 2048 windows of 8192),
   K1's and K3's 64-bit launches (K3's at every W; a spill fails),
   ``ops.sort`` of 2^24 and 2^27 doubles and of 2^24
   int64 beside ``torch.sort`` of the same keys, a profile of one double
   sort and its fallback share; ``argsort_records`` of SkySurvey at 2^24
   beside the ``torch.sort`` cascade, ``ops.sort`` learned beside tree at
   2^24 (Uniform and Zipf), and the stream with the planned merge tile
   beside K5's default (the whole external sort and one merge);
   the scheduler's admissions (host clock, queue to admitted list) and its
   bottom-k alone beside ``torch.topk``, the pipeline's length argsort
   beside ``torch.sort``; each served family's prefill ms, decode ms per
   step and tokens/s, a profile of one prefill and of 8 decode steps;
   the training step of deepseek-moe-16b (median of steps 2-8 on the host
   clock, tokens/s, peak memory, its gradients and AdamW timed apart, and a
   profile of one step: device ms, launches, idle share, K6's share);
   and, for the paths above, ``ops.sort`` of 2^24 with obs disabled and
   enabled, ``dist.sort`` at world size 1 beside ``ops.sort`` (median of 5
   by CUDA events), and the four ``gloo`` ranks' host times of their sorts
   (gloo's host copies, not the exchange's cost); the full-width training
   step over the (1, 1) mesh with ``explicit_ep`` beside the unsharded one
   (medians of 3 steps, peak memory, DTensor's host cost a step) and ``time
   roofline``: the dry run's modelled row of that step (t_compute,
   t_memory, model_flops) beside the measured step;
5. a ``{"kernels": [...]}`` JSON line (39 entries: the eleven glue rows
   ``close_placement``, ``segment_ids``, ``composite_ids``,
   ``composite_ids64``, ``scatter_rows``, ``gather_windows``,
   ``codec_encode``, ``codec_decode``, ``sample_splitters``,
   ``fallback_list`` and ``fallback_sort``, whose
   ``replaces`` names the reference's XLA code they stand for; the four 64-bit forms
   are rows of their own, ``level_fused64``, ``level_fused_radix64``,
   ``level_fused_batched64`` and ``sort_windows64``, and so are K5's int64
   form, ``merge_path64``, and K7 by key width, ``classify_histogram8``,
   ``classify_histogram16``, ``classify_histogram64``,
   ``classify_histogram_batched64`` and ``radix_histogram64``, whose rows
   add ``launches_by_kind``, the launches of each key kind's path), then
   the last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --parent DIR

times K1 (tree, radix, batched, with 32- and 64-bit keys), the 32-bit K3,
K3's 64-bit form (at every W from 16 to 16384 on 2^24 keys), K5 and K7
(tree mode on 8-, 16-, 32- and 64-bit keys and on equal float32 keys,
batched on 32- and 64-bit rows, radix mode on int32 and int64 codes) of the
CUDA sources under DIR (an earlier commit, unpacked by ``git archive``)
beside this tree's, in turns,
and checks that both give the same outputs; and K2 ``rank_hist``, K4
``rank_hist_batched`` and K6's three entry points (and ``dispatch_ranks``
on the skewed routing) of DIR's sources through DIR's own wrappers (their
C entry points differ), in a child process with ``DIR/src`` on its path:
entry point by events, device time and kernels of a call, the earlier
tree's device time per kernel, and equal outputs; and, the same way, the
sort's seven entry points whose glue G1-G4 took over (``ops.sort`` of 2^24
float32 by the tree, ``argsort``, the radix sort of full-range int32,
double, ``batched_sort`` of (64, 2^18), ``argsort_records`` of SkySurvey
(2^24 records of 3 words) and ``segmented_sort`` of 4096 segments): events,
device time, kernels a call, idle share and synchronizing calls a call.

It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent



def _card_table() -> dict:
    """The card's rated figures from the port's one table
    (``repro_torch.launch.roofline.HW``), so that the kernels' bounds and
    the dry run's roofline cannot drift apart; empty where the port is not
    beside this script (``main`` then refuses to run)."""
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.launch.roofline import HW
    except ImportError:
        return {}
    return HW


# H100 SXM data-sheet peaks (dense, at the 700 W limit).  The kernels do
# 32-bit integer work outside the tensor cores; the data sheet gives no
# integer rate there, so the bound takes its 32-bit float rate, which no
# integer instruction mix exceeds: the bound stays a least time.
HW = _card_table()
HBM_BYTES_PER_S = HW.get("hbm_bw")
OPS_32BIT_PER_S = HW.get("fp32_flops")

N_BIG = 1 << 24
N_SMALL = 1 << 17
B_BULK, N_ROW = 64, 1 << 18  # the bulk rows: 2^24 keys, two levels per row
B_SCHED, N_SCHED = 256, 512  # the serve scheduler's admission queues
TOP_K = 64
# the out-of-core stream: 1 GiB of float32 keys on the host in 16 chunks (a
# real out-of-core stream exceeds the card's 80 GB; cut for the time limit)
N_STREAM, CHUNK = 1 << 28, 1 << 24
STREAM_K = 1024
N_GROUPS, CHUNK_GROUPS = 1 << 26, 1 << 22  # streaming_group_by, RootDup int32
# the plan cache: races and sweeps at 2^22 float32, an external sort of 2^26
# in chunks of 2^22 with the tuned chunk sorter and merge tile
N_PLAN, N_PLAN_STREAM = 1 << 22, 1 << 26
# the distributed sort: four ranks on the one card (gloo) with 2^22 float32
# keys a rank (2^24 in all), world size 1 on NCCL at 2^24, rank-k at k = 1024
DIST_WORLD, N_DIST_LOCAL, DIST_K = 4, 1 << 22, 1024
# MoE routing of deepseek-moe-16b: 64 routed experts, top-6, 2^21 tokens
MOE_EXPERTS, MOE_TOP, MOE_TOKENS = 64, 6, 1 << 21
MOE_LAYERS = 8  # per-layer routing rows for the batched placement
NB_PART = 257  # partition_ranks: 2k + 1 buckets at k = 128
SEGMENTS = 4096
# double once at 2^27 (1 GiB of keys): the default kmax = 128 takes two
# levels up to 2^24 keys, so the paper's k = 256 and a slack of 4 (buckets
# of W / 4 expected) cover 2^27
N_HUGE = 1 << 27
HUGE_KMAX, HUGE_SLACK = 256, 4
K_RADIX = 256  # radix_histogram: 8 bits per level
# the block path: 2^28 int32 keys (1 GiB) in blocks of 1024 over 256 buckets
N_BLOCK_KEYS, BLOCK, N_BUCKETS = 1 << 28, 1024, 256
BLOCK16 = 4096  # K8 also at blocks of 16 KB (a CTA team of 4 warps)
# serving yi-9b at full width and depth: 8 requests of 1024-token prompts,
# 32 new tokens each, a 4096-slot cache per request
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 8, 1024, 32, 4096
DECODE_LENGTHS = (1, 1, 17, 1024, 1025, 2048, 4095, 4096)  # K10's ragged check
ATTN_S = 4096  # K11's check and timing: (1, 32, 4096, 128)
BF16_FLOPS_PER_S = HW.get("peak_flops")  # dense bf16 on the tensor cores
TF32_FLOPS_PER_S = HW.get("tf32_flops")  # dense tf32 on the tensor cores
# |got - want| <= atol + rtol * |want| for the attention kernels against
# their twins: f32 is the same math in another summation order; bf16 is the
# output's rounding, one step of 2^-8 relative, above an absolute floor of
# about twice the largest sound difference (one bf16 step, 2^-9, at outputs
# in [0.25, 0.5)), far below what a dropped tile of keys moves (PERF.md)
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 2 ** -8)}
FAULT_KEYS = 64  # the fault each attention check must flag: one tile dropped
# the served model's teacher-forced checks, max |a - b| over max |b| of the
# logits: random bf16 weights through 48 layers, where the two sides round
# at other places (the eager path rounds the softmax weights to bf16, K10
# keeps them f32; the full forward's products have other shapes)
SERVE_TOL = 0.05
# the other served families at full width (bf16, random weights): 8 requests
# of 1024 prompt tokens admitted from a queue of 65,536, 32 new tokens each
FAMILIES = ("deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b")
# their caches hold 2048 slots: zamba2's shared attention takes a cache of
# exactly HYBRID_ATTN_WINDOW = 4096 slots for its ring (the reference's rule),
# and decodes on a ring without K10
FAMILY_MAX_SEQ = 2048
SCHED_QUEUE, SCHED_BATCH, SCHED_MAX_NEW = 1 << 16, 256, 4096  # the scheduler's queue
SCHED_GROUPS, SCHED_GROUP_N, SCHED_WIDE_N = 64, 4096, 1 << 14  # admit_many fleets
SCHED_BACKLOG = 1 << 14
# the data pipeline: the length argsort at 2^22 documents, whole packs of 8192
PACK_SORT_N, PACK_N, PACK_SEQ, PACK_CHUNK = 1 << 22, 8192, 1024, 2048
# the MoE's teacher-forced check: 1 x (128 + 32) at lossless capacity, two layers
MOE_TF_PROMPT, MOE_TF_LAYERS = 128, 2
RWKV_PROFILE_TOKENS = 128  # rwkv6's prefill profile: its first 128 tokens
HYBRID_TF_NEW = 128  # zamba2's: 1024 + 128 (its chunks of 128 must divide the length)
# training deepseek-moe-16b at its published width, 4 of its 28 layers: 2.771 B
# parameters, whose bf16 weights and grads, float32 accumulators and float32
# AdamW moments take ~44 GB of the 80 before activations (six layers would
# take ~63 GB of state alone); the registry's train_4k sequence at global
# batch 4 in microbatches of 2, eight Trainer.run steps on one fixed batch
TRAIN_ARCH, TRAIN_LAYERS = "deepseek-moe-16b", 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 4, 2, 8
# the reduced models (float32) on the card against the CPU: every gradient
# within TRAIN_TOL * max |CPU's| per leaf, the loss to TRAIN_TOL relative
# (the same float32 math summed in other orders by cuBLAS and the CPU's
# kernels), the parameters after a step that moves them to TRAIN_TOL absolute
TRAIN_REDUCED = ("deepseek-moe-16b", "yi-9b")
TRAIN_TOL = 1e-4
TRAIN_REDUCED_SEQ = 64
# the launch tooling (launch_phases): one deepseek-moe-16b MoE layer at
# published width (64 routed experts, top-6, d 2048, d_ff_expert 1408, two
# shared experts), float32, over 8 x 1024 tokens, expert parallel on a (1, 1)
# NCCL mesh and on four gloo ranks on the card (a (1, 4) mesh, 16 experts a
# rank), its output and expert gradients held to the baseline within EP_TOL
# (atol, rtol: the reference's own bound for its column), the router's and
# the shared experts' gradients (sums over every token, added in another
# order) within EP_TOL's rtol of each leaf's largest, and its dropped entries
# and counts exactly
EP_WORLD, EP_TOKENS, EP_DEVICE = 4, (8, 1024), "cuda"
EP_TOL = (2e-5, 2e-5)
SHARDED_STEPS = 3  # steps of the full-width case timed over the (1, 1) mesh
# the dry-run cells the smoke traces (the whole table of 40 takes minutes of
# the host's time: ``python -m repro_torch.launch.dryrun --all``): every family
# and every shape kind once, the skip of a full-attention long_500k cell,
# rwkv6's decode on the two-pod mesh and deepseek-moe-16b's train step with
# and without expert parallelism
DRYRUN_CELLS = (
    ("yi-9b", "prefill_32k", ()), ("internvl2-76b", "prefill_32k", ()),
    ("musicgen-medium", "decode_32k", ()), ("zamba2-2.7b", "long_500k", ()),
    ("llama3-405b", "long_500k", ()), ("rwkv6-1.6b", "decode_32k", ("--multi-pod",)),
    ("deepseek-moe-16b", "train_4k", ()),
    ("deepseek-moe-16b", "train_4k", ("--explicit-ep", "--tag", "ep")),
)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over integer tensors or tuples of them."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def moved_bits(torch, arrays) -> tuple:
    """Every tensor of a dict as signed ints of its element's width (bool as
    uint8), so that ``max_abs_err`` compares the bits a move left."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return tuple((a.to(torch.uint8) if a.dtype == torch.bool else a.view(ints[a.element_size()]))
                 for a in arrays.values())


def bound_ms(nbytes: float, ops: float, ops_per_s: float = OPS_32BIT_PER_S):
    """The least time for the work: the larger of the byte and op times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_us(e) -> float:
    """A profiler event's own device time in us."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


# cycles of torch.cuda._sleep's ``spin_kernel``, the sentinel launched at each
# end of a profiled window (tens of us)
SENTINEL_CYCLES = 100_000


def device_events(torch, fn, reps: int):
    """The device-side events (kernels, copies, memsets) of ``reps`` calls of
    ``fn``, by torch.profiler.  The calls are profiled twice, a warm-up
    window and an active one, and only the active window counts: the first
    launches of a window can go missing from the trace (the trace has kept
    9 of 10 launches in every try on some machines).  So each window waits
    2 ms on the host and opens and closes with a sentinel launch,
    ``torch.cuda._sleep``'s ``spin_kernel``, left out of the events: a
    launch lost at either end of the window is a sentinel."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    active = []
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                       on_trace_ready=lambda p: active.extend(p.key_averages())) as prof:
        for _ in range(2):
            time.sleep(0.002)
            torch.cuda._sleep(SENTINEL_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize()
            prof.step()
    return [e for e in active if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")  # the step's own span
            and "spin_kernel" not in e.key]


def one_kernel_a_call(torch, name, fn, counted, reps: int = 10, tries: int = 5):
    """The device events of ``reps`` calls of ``fn`` in which the events
    that ``counted`` picks are one kernel, launched once a call; fails
    otherwise.  The trace can drop launches but never adds one, so a
    second kernel or a count above ``reps`` fails at once, and a count
    below ``reps`` is profiled again, up to ``tries`` times."""
    for _ in range(tries):
        events = device_events(torch, fn, reps)
        work = {e.key: e.count for e in events if counted(e)}
        if len(work) > 1 or any(c > reps for c in work.values()):
            fail(f"{name} is not one device kernel per call: {work}")
        if list(work.values()) == [reps]:
            return events
        print(f"{name}: the trace kept {work} of {reps} launches; profiling again", flush=True)
    fail(f"{name}: none of {tries} traces kept all {reps} launches: {work}")


def device_ms(torch, fn, reps: int = 20, names=None, launches: int = 1) -> float:
    """Device time in ms by torch.profiler over ``reps`` calls of ``fn``
    (copies and memsets apart), so the host's time between launches is left
    out.  Without ``names``: all of one call's kernels.  With ``names``: one
    launch of each kernel whose name holds one of them, at its mean over
    the launches the trace kept, summed over those kernels; each is
    launched ``launches`` times a call, and a line says when the trace kept
    fewer (it does, more often the longer the kernel); a trace that kept
    none of them is taken again, up to three times in all."""
    for _ in range(3):
        events = [e for e in device_events(torch, fn, reps)
                  if not e.key.startswith(("Memcpy", "Memset"))]
        if names is None:
            return sum(device_us(e) for e in events) / 1e3 / reps
        own = [e for e in events if any(x in e.key for x in names)]
        if own:
            break
        print(f"device_ms: the trace kept no launch of {names}; profiling again", flush=True)
    if any(e.count != reps * launches for e in own):
        print(f"device_ms: the trace kept {[e.count for e in own]} of {reps * launches} launches "
              f"of {[e.key[:60] for e in own]}", flush=True)
    return sum(device_us(e) / e.count for e in own) / 1e3


# the glue kernels a sort of two levels launches (G1-G4), by launch count
GLUE_LAUNCHES = ("close_placement", "segment_ids", "composite_ids", "scatter_rows",
                 "gather_windows")
# and those of every sort entry point (G5's encode, G7's two): G6 runs where a
# level samples (not radix), G5's decode where the keys are not int32/int64
TAIL_LAUNCHES = ("codec_encode", "fallback_list", "fallback_sort")
TAIL_DTYPES = ("int8", "uint8", "int16", "uint16", "float16", "bfloat16", "int32", "uint32",
               "float32", "int64", "uint64", "float64")
# the signed int of each element width (views for bitwise compares)
SIGNED_NAMES = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}
# the seven calls that must make no synchronizing call (obs off)
SYNC_FREE_CALLS = ("ops.sort", "ops.argsort", "ops.topk", "ops.batched_sort", "double",
                   "radix", "ops.segmented_sort")
MAIN_PATH_MAX_LAUNCHES = 40  # the profiled 1-D tree sort of 2^24 float32, at most
# and their device functions (csrc/glue.cu)
GLUE_KERNELS = ("close_sums_kernel", "close_scan_kernel", "close_place_kernel",
                "segment_ids_kernel", "composite_ids_kernel", "scatter_kernel",
                "scatter_staged_kernel", "gather_windows_kernel", "encode_kernel",
                "decode_kernel", "sample_splitters_kernel", "list_kernel(", "sort_kernel<",
                "sort_keys_kernel<")

K2_KERNELS = ("segment_items_kernel", "segment_count_kernel", "segment_tiny_count_kernel",
              "segment_small_kernel", "segment_scan_kernel", "segment_rank_kernel",
              "rank_hist_kernel")

# each row's device functions, by name (csrc/*.cu): a row's device_ms sums
# these alone, without the torch kernels its wrapper launches around them
DEVICE_FUNCTIONS = {
    "level_fused": ("level_fused_kernel",), "level_fused_radix": ("level_fused_kernel",),
    "level_fused_batched": ("level_fused_kernel",),
    # K2's kernels (four a call); the last name: the first design's one kernel
    "rank_hist": K2_KERNELS, "rank_hist_batched": K2_KERNELS,
    "sort_windows": ("sort_windows_kernel", "sort_small_windows_kernel"),
    # the second name: the first design's kernel, which --parent times
    "merge_path": ("merge_kernel<", "merge_path_kernel"),
    # K6's one kernel (the memset of its scratch is not a kernel)
    "dispatch_ranks": ("dispatch_rank_kernel",),
    "partition_ranks": ("dispatch_rank_kernel",),
    "partition_ranks_batched": ("dispatch_rank_kernel",),
    "classify_histogram": ("classify_hist_kernel",),
    "classify_histogram_batched": ("classify_hist_kernel",),
    "radix_histogram": ("classify_hist_kernel",),
    "permute_blocks_by_dest": ("permute_by_dest_kernel",),
    "permute_blocks_inplace": ("permute_inplace_kernel", "permute_inplace_init"),
    "flash_decode": ("flash_decode_",),
    "flash_attention": ("attention_kernel",), "flash_attention_f32": ("attention_kernel",),
    # the 64-bit forms: the same templates, instantiated for long long keys
    "level_fused64": ("level_fused_kernel",), "level_fused_radix64": ("level_fused_kernel",),
    "level_fused_batched64": ("level_fused_kernel",),
    # the merge sort from W = 16; the last name: the first design's bitonic
    # network, which --parent times
    "sort_windows64": ("merge_sort_windows_kernel", "sort_small_windows_kernel",
                       "sort_windows_kernel"),
    # K5's int64 form and K7 by key width: the same templates
    "merge_path64": ("merge_kernel<",),
    "classify_histogram8": ("classify_hist_kernel",),
    "classify_histogram16": ("classify_hist_kernel",),
    "classify_histogram64": ("classify_hist_kernel",),
    "classify_histogram_batched64": ("classify_hist_kernel",),
    "radix_histogram64": ("classify_hist_kernel",),
    # G1-G4 (csrc/glue.cu): G1's three kernels, G4's scatter row by row or
    # staged by bucket, its window gather direct or staged
    "close_placement": ("close_sums_kernel", "close_scan_kernel", "close_place_kernel"),
    "segment_ids": ("segment_ids_kernel",),
    "composite_ids": ("composite_ids_kernel",), "composite_ids64": ("composite_ids_kernel",),
    "scatter_rows": ("scatter_kernel", "scatter_staged_kernel"),
    "gather_windows": ("gather_windows_kernel",),
    # G5 (csrc/codec.cu), G6 (csrc/glue.cu), G7 (csrc/fallback.cu)
    "codec_encode": ("encode_kernel",), "codec_decode": ("decode_kernel",),
    "sample_splitters": ("sample_splitters_kernel",),
    "fallback_list": ("list_kernel(",), "fallback_sort": ("sort_kernel<", "sort_keys_kernel<"),
}


def kernel_ms(torch, name, t, fn, warmup: int = 2, reps: int = 10, device_reps: int = 20):
    """A kernel row's two times for one call of ``fn``: CUDA events around
    it (``ms``, the host's wrapper included, median of ``reps``) and the
    device time of the row's own device functions (``device_ms``,
    torch.profiler over ``device_reps`` calls)."""
    t["ms"] = cuda_ms(torch, fn, warmup=warmup, reps=reps)
    t["device_ms"] = device_ms(torch, fn, reps=device_reps, names=DEVICE_FUNCTIONS[name])


def call_kernels(torch, fn, reps: int = 10):
    """One call's device kernels by torch.profiler (copies and memsets
    apart): (launches a call, device ms a call, {kernel: mean ms a launch})."""
    events = [e for e in device_events(torch, fn, reps)
              if not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in events) / reps, sum(device_us(e) for e in events) / 1e3 / reps,
            {e.key: device_us(e) / e.count / 1e3 for e in events})


def sync_calls(torch, fn) -> int:
    """The synchronizing calls one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` flags them: the second of two
    calls under the mode counts (the first can flag a one-time sync of
    torch's own)."""
    import warnings

    fn()
    torch.cuda.synchronize()
    counted = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counted.append(sum("synchroniz" in str(w.message) for w in seen))
    return counted[-1]


def peak_rise(torch, fn) -> int:
    """Device bytes one call of ``fn`` holds at its peak above what was
    allocated before it (its outputs included)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    rise_ = torch.cuda.max_memory_allocated() - base
    del out
    return rise_


def host_us(torch, fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` in us, launches only (no synchronize
    inside the loop; the device queue absorbs the kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def profile(torch, name, fn, top: int = 14, show=(), cpu: bool = True) -> dict:
    """Where one call's time goes: device time per operation (torch.profiler)
    beside the host clock around the whole call; the ``top`` kernels, and
    those whose name holds one of ``show`` wherever they rank.  ``cpu=False``
    traces the card alone (no host op events): for a call of ~10^5 launches,
    whose host events would take the profiler minutes to sort.  Returns the
    wall and kernel ms, the launches and the kernels' events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    # device-side events only (the aten ops above them repeat their time);
    # copies between host and device are summed apart from the kernels
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=device_us, reverse=True)
    kernel_events = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(device_us(e) for e in kernel_events) / 1e3
    print(f"profile {name}: wall {wall_ms:.3f} ms (host clock, profiler on), "
          f"kernels {busy_ms:.3f} ms in {sum(e.count for e in kernel_events)} launches, "
          f"idle share {1 - busy_ms / wall_ms:.3f} (no kernel running)", flush=True)
    for kind in ("HtoD", "DtoH"):
        copies = [e for e in events if f"Memcpy {kind}" in e.key]
        print(f"  copies {kind}: {sum(device_us(e) for e in copies) / 1e3:.3f} ms in "
              f"{sum(e.count for e in copies)} copies", flush=True)
    for rank_, e in enumerate(events):
        if rank_ < top or any(x in e.key for x in show):
            print(f"  {device_us(e) / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms,
            "launches": sum(e.count for e in kernel_events), "kernels": kernel_events}


def attention_phases(torch, dev) -> dict:
    """Phases 2-4 for K10, K11 and the serve path, after the sort phases have
    freed their tensors.  Returns the attention kernels' rows of the kernels line
    (their ``max_abs_err`` is a float: the largest over phase 2's checks)."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd, ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.attention import _causal_mask, _sdpa
    from repro_torch.models.layers import dense, rms_norm, rope
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.serve import Engine, ServeConfig

    rows = {"flash_decode": {"max_abs_err": 0.0}, "flash_attention": {"max_abs_err": 0.0},
            "flash_attention_f32": {"max_abs_err": 0.0}}
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    k11 = {bf16: "flash_attention", f32: "flash_attention_f32"}  # row (and launch key) by dtype
    cfg = get_config("yi-9b")
    H, KVH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B, T = SERVE_BATCH, SERVE_MAX_SEQ

    def check_close(name, got, want, dtype, what, fault=None):
        """``fault``: (the twin's output with a tile of keys dropped, what
        was dropped), which the limit must flag."""
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
        limit = atol + rtol * want.to(f32).abs()
        diff = (got.to(f32) - want.to(f32)).abs()
        err = float(diff.max())
        ok = bool((diff <= limit).all())  # NaN fails
        line = f"{name} {what}: max_abs_err={err:.3e} (limit {atol} + {rtol} * |want|)"
        caught = True
        if fault is not None:
            fdiff = (fault[0].to(f32) - want.to(f32)).abs()
            caught = bool((fdiff > limit).any())
            line += (f"; a fault ({fault[1]}) would read {float(fdiff.max()):.3e}, "
                     f"{'flagged' if caught else 'NOT flagged'}")
        print(f"{line} {'ok' if ok and caught else 'WRONG'}", flush=True)
        if not ok:
            fail(f"{name} differs from its plain twin on {what}")
        if not caught:
            fail(f"{name}: the limit on {what} does not flag a dropped tile of keys")
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    def drive(path, needed, calls):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        results = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"path {path} launches: {launches} ({time.time() - t0:.1f} s)", flush=True)
        for name in needed:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the path {path}")
        return results, launches

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- 2. K10 and K11 against their plain twins ---------------------------
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    # the fault: the longest request's last tile of keys dropped
    short = torch.where(lengths == T, lengths - FAULT_KEYS, lengths)
    for dtype in (f32, bf16):
        q, ck, cv = randn(B, H, HD, dtype=dtype), randn(B, T, KVH, HD, dtype=dtype), \
            randn(B, T, KVH, HD, dtype=dtype)

        def twin(lens):
            return kref.flash_decode_ref(q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
                                         lens)[:, :, 0]

        want = twin(lengths)
        fault = (twin(short), f"keys {T - FAULT_KEYS}..{T - 1} of the length-{T} request")
        check_close("flash_decode", fd.flash_decode_cache(q, ck, cv, lengths), want, dtype,
                    f"{dtype} cache (B, T, KVH, hd) = ({B}, {T}, {KVH}, {HD}), H={H}, "
                    f"lengths {DECODE_LENGTHS}", fault)
    kx = ck.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    vx = cv.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    check_close("flash_decode", fd.flash_decode(q[:, :, None], kx, vx, lengths)[:, :, 0],
                want, bf16, f"bf16 pre-expanded (B, H, T, hd) = ({B}, {H}, {T}, {HD})", fault)
    del q, ck, cv, kx, vx, want, fault
    attn_cases = ((True, 0, ATTN_S), (True, 1024, ATTN_S), (False, 0, ATTN_S // 2))
    for dtype in (f32, bf16):
        for causal, window, s in attn_cases:
            q, k, v = (randn(1, H, s, HD, dtype=dtype) for _ in range(3))
            want = kref.flash_attention_ref(q, k, v, causal=causal, window=window)
            # the fault: the window (or the whole row) one tile narrower, so
            # the last query rows lose their first tile of keys
            narrow = (window or s) - FAULT_KEYS
            fault = (kref.flash_attention_ref(q, k, v, causal=causal, window=narrow),
                     f"window {narrow}")
            check_close(k11[dtype],
                        fa.flash_attention(q, k, v, causal=causal, window=window), want, dtype,
                        f"{dtype} (1, {H}, {s}, {HD}) causal={causal} window={window}", fault)
            del q, k, v, want, fault
    torch.cuda.empty_cache()

    # ---- 3. the K11 entry point at the prefill shape, then the serve path ----
    print(f"serve: device memory allocated before the model {torch.cuda.memory_allocated()} B",
          flush=True)
    t0 = time.time()
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)  # bf16
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"serve: {cfg.name} {cfg.num_layers} layers, {n_params} parameters, {weight_bytes} B, "
          f"random from a seeded CUDA generator in {time.time() - t0:.1f} s", flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT), generator=gen, device=dev)

    # K11 on layer 0's q, k, v of the served prompts, in their (B, S, H, hd)
    # layout read through strides
    blk = model.layers[0]
    x = rms_norm(blk.ln1, model.embed[prompts], cfg.norm_eps)
    pos = torch.arange(SERVE_PROMPT, device=dev)[None].expand(B, SERVE_PROMPT)

    def heads(w, n):
        return dense(w, x).reshape(B, SERVE_PROMPT, n, HD)

    q0 = rope(heads(blk.attn.wq, H), pos, cfg.rope_theta)
    k0 = rope(heads(blk.attn.wk, KVH), pos, cfg.rope_theta)
    v0 = heads(blk.attn.wv, KVH)
    path = f"flash_attention entry point (layer 0 of {B} x {SERVE_PROMPT} prompt tokens)"
    q0f, k0f, v0f = (x.float() for x in (q0, k0, v0))
    copies = fa.LAYOUT_COPIES["flash_attention"]
    got, launches = drive(path, ("flash_attention", "flash_attention_f32"), {
        "causal": lambda: kops.flash_attention(q0.transpose(1, 2), k0.transpose(1, 2),
                                               v0.transpose(1, 2), causal=True),
        "causal f32": lambda: kops.flash_attention(q0f.transpose(1, 2), k0f.transpose(1, 2),
                                                   v0f.transpose(1, 2), causal=True)})
    for name in k11.values():
        rows[name]["launches"] = launches[name]
    print(f"path {path}: layout copies for TMA "
          f"{fa.LAYOUT_COPIES['flash_attention'] - copies} (strides read as they are)",
          flush=True)
    check_close("flash_attention", got["causal"], kref.flash_attention_ref(
        q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2)), bf16, path)
    check_close("flash_attention_f32", got["causal f32"], kref.flash_attention_ref(
        q0f.transpose(1, 2), k0f.transpose(1, 2), v0f.transpose(1, 2)), f32, path + " f32")
    del q0f, k0f, v0f
    eager = _sdpa(q0, k0, v0, _causal_mask(SERVE_PROMPT, 0, dev))
    print(f"path {path}: against the model's eager prefill attention max |diff| "
          f"{float((got['causal'].transpose(1, 2).reshape(eager.shape).float() - eager.float()).abs().max()):.3e}"
          " (measure only: the eager path rounds its weights to bf16)", flush=True)
    del x, q0, k0, v0, eager, got

    engine = Engine(cfg, ServeConfig(max_seq=SERVE_MAX_SEQ, batch_size=B), model, device=dev)

    def serve(flash=True):
        with compute_policy(flash_decode=flash):
            return engine.generate(prompts, SERVE_NEW)

    path = (f"serve {cfg.name} ({cfg.num_layers} layers, bf16; {B} requests x {SERVE_PROMPT} "
            f"prompt tokens, {SERVE_NEW} new, greedy, flash_decode)")
    got, launches = drive(path, ("flash_decode",), {"generate": serve})
    tokens = got["generate"]
    rows["flash_decode"]["launches"] = launches["flash_decode"]
    if launches["flash_decode"] != cfg.num_layers * SERVE_NEW:
        fail(f"K10 launched {launches['flash_decode']} times, not once per layer per decode "
             f"step ({cfg.num_layers * SERVE_NEW})")
    ok = (tokens.shape == (B, SERVE_NEW) and tokens.dtype == torch.int32
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size)
    print(f"path serve: tokens {tuple(tokens.shape)} {'ok' if ok else 'WRONG'}; "
          f"first request {tokens[0, :12].tolist()}", flush=True)
    if not ok:
        fail("serve: the generated tokens are malformed")
    again = serve()
    print(f"path serve: two generate calls on one engine equal: {torch.equal(tokens, again)}",
          flush=True)
    if not torch.equal(tokens, again):
        fail("serve: two greedy generate calls on one engine differ")
    eager_tokens = serve(flash=False)
    agree = float((eager_tokens == tokens).float().mean())
    print(f"path serve: greedy tokens of the K10 path equal to the eager path's: {agree:.4f} "
          f"(measure only)", flush=True)

    # teacher forced over the generated sequence: at every decode step the
    # K10 path against the eager path on the same cache, and prefill + decode
    # against the full forward at the last positions
    seq = torch.cat([prompts, tokens], dim=1)
    cache = engine.cache
    forward(model, cfg, prompts, cache=cache)
    k10_logits, eager_logits = [], []
    for i in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_NEW):
        tok, pos_i = seq[:, i:i + 1], torch.full((B, 1), i, device=dev)
        with compute_policy(flash_decode=True):
            k10_logits.append(forward(model, cfg, tok, positions=pos_i, cache=cache)[0][:, 0])
        for c in cache["layers"]:
            c["pos"] = i  # the eager step rewrites slot i from the same cache
        eager_logits.append(forward(model, cfg, tok, positions=pos_i, cache=cache)[0][:, 0])
    k10_logits = torch.stack(k10_logits, 1).float()
    eager_logits = torch.stack(eager_logits, 1).float()
    full_logits = forward(model, cfg, seq)[0][:, SERVE_PROMPT:].float()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    for what, err in (("K10 decode against the eager decode, same cache",
                       rel(k10_logits, eager_logits)),
                      ("prefill + eager decode against the full forward",
                       rel(eager_logits, full_logits)),
                      ("prefill + K10 decode against the full forward",
                       rel(k10_logits, full_logits))):
        ok = err <= SERVE_TOL
        print(f"path serve teacher-forced, {what}: max |diff| / max |logit| = {err:.4e} "
              f"(tol {SERVE_TOL}; max |logit| {float(full_logits.abs().max()):.3f}) "
              f"{'ok' if ok else 'WRONG'}", flush=True)
        if not ok:
            fail(f"serve: {what} beyond {SERVE_TOL}")
    print("path serve: argmax of the K10 decode logits equal to the full forward's: "
          f"{float((k10_logits.argmax(-1) == full_logits.argmax(-1)).float().mean()):.4f} "
          "(measure only)", flush=True)
    del k10_logits, eager_logits, full_logits

    # ---- 4. timing ------------------------------------------------------------
    def prefill():
        forward(model, cfg, prompts, cache=cache)

    prefill_ms = cuda_ms(torch, prefill, warmup=1, reps=3)
    for flash in (True, False):
        gen_ms = cuda_ms(torch, lambda: serve(flash), warmup=1, reps=3)
        step_ms = (gen_ms - prefill_ms) / SERVE_NEW
        print(f"time serve {'K10' if flash else 'eager'} path: generate {gen_ms:.3f} ms, "
              f"prefill {prefill_ms:.3f} ms ({B} x {SERVE_PROMPT} tokens), decode "
              f"{step_ms:.3f} ms per step, {B * 1e3 / step_ms:.1f} tokens/s", flush=True)

    def decode_steps(n, flash):
        for c in cache["layers"]:
            c["pos"] = SERVE_PROMPT
        with compute_policy(flash_decode=flash):
            for i in range(SERVE_PROMPT, SERVE_PROMPT + n):
                forward(model, cfg, seq[:, i:i + 1], positions=torch.full((B, 1), i, device=dev),
                        cache=cache)

    profile(torch, f"prefill of {cfg.name} ({B} x {SERVE_PROMPT} tokens, eager attention)",
            prefill, top=8)
    for flash in (True, False):
        prefill()
        profile(torch, f"8 decode steps of {cfg.name} ({B} requests, "
                f"{'K10' if flash else 'eager'} path)", lambda: decode_steps(8, flash), top=12)
    kv_bytes = cfg.num_layers * 2 * B * KVH * (SERVE_PROMPT + SERVE_NEW) * HD * 2
    decode_bound = bound_ms(weight_bytes - model.embed.numel() * 2 + kv_bytes, 0)[0]
    print(f"decode step bound at length {SERVE_PROMPT + SERVE_NEW}: {decode_bound:.3f} ms (the "
          f"weights read once, the embedding only gathered, + {kv_bytes} B of valid KV)",
          flush=True)

    # K10 at the served shape: the last step's length, over the 48 layers'
    # caches in turn, so that each launch finds its cache cold in the L2 as
    # the decode step does (one layer's valid K and V, 17.3 MB, would stay
    # in the 50 MB L2 if one cache were timed over and over).  Device time
    # by the profiler: at ~0.1 ms a launch, CUDA events around one call
    # would mostly time the host's wrapper
    length = SERVE_PROMPT + SERVE_NEW
    layer_kv = [(c["k"], c["v"]) for c in cache["layers"]]
    q = randn(B, H, HD, dtype=bf16)
    q4 = q[:, :, None]
    lens = torch.full((B,), length, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev) < lens[:, None])[:, None, None, :]
    n_kv = len(layer_kv)

    def per_layer(call):
        return lambda: [call(ck, cv) for ck, cv in layer_kv]

    k10 = per_layer(lambda ck, cv: fd.flash_decode_cache(q, ck, cv, lens))
    sdpa = per_layer(lambda ck, cv: F.scaled_dot_product_attention(
        q4, ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask, enable_gqa=True))
    t = rows["flash_decode"]
    k10_names = DEVICE_FUNCTIONS["flash_decode"]  # one launch a call: its mean over those kept
    t["ms"] = device_ms(torch, k10, reps=3, names=k10_names, launches=n_kv)
    t["device_ms"] = t["ms"]  # the layers' caches in turn (events would time the wrapper)
    t["plain_ms"] = device_ms(torch, per_layer(lambda ck, cv: kref.flash_decode_ref(
        q4, ck.transpose(1, 2), cv.transpose(1, 2), lens)), reps=1) / n_kv
    t["bound_ms"], t["bound_by"] = bound_ms(
        2 * B * KVH * length * HD * 2 + 2 * q.numel() * 2 + B * 4,
        4 * B * H * length * HD, BF16_FLOPS_PER_S)
    t["library_ms"] = device_ms(torch, sdpa, reps=3) / n_kv
    ck, cv = layer_kv[0]
    got = fd.flash_decode_cache(q, ck, cv, lens)
    want = F.scaled_dot_product_attention(q4, ck.transpose(1, 2), cv.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=True)[:, :, 0]
    print(f"flash_decode: SDPA (boolean length mask, enable_gqa) against the kernel max |diff| "
          f"{float((want.float() - got.float()).abs().max()):.3e}", flush=True)
    warm_ms = device_ms(torch, lambda: fd.flash_decode_cache(q, ck, cv, lens), names=k10_names)
    kx = ck.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    vx = cv.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    sdpa_expanded_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kx, vx, attn_mask=mask))
    k10_expanded_ms = device_ms(torch, lambda: fd.flash_decode(q4, kx, vx, lens), names=k10_names)
    decode_mask = (torch.arange(T, device=dev) <= length - 1)[None, None, None, :]
    k10_events_ms = cuda_ms(torch, lambda: fd.flash_decode_cache(q, ck, cv, lens), reps=50)
    host = {
        "K10 wrapper": host_us(torch, lambda: fd.flash_decode_cache(q, ck, cv, lens)),
        "SDPA": host_us(torch, lambda: F.scaled_dot_product_attention(
            q4, ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask, enable_gqa=True)),
        "eager _sdpa (decode)": host_us(torch, lambda: _sdpa(q[:, None], ck, cv, decode_mask)),
    }
    del kx, vx, cache, engine, model
    torch.cuda.empty_cache()

    # K10 is one device kernel a call: no memset, no combine launch
    k10_device = {e.key: e.count for e in one_kernel_a_call(
        torch, "K10", lambda: fd.flash_decode_cache(q, ck, cv, lens), lambda e: True)}
    print(f"flash_decode device work in 10 calls (torch.profiler): {k10_device}", flush=True)
    k10_launch = {f"B={b_} {str(dt).split('.')[-1]}": fd.launch_info(b_, KVH, H // KVH, HD, dt)
                  for b_ in (B, 1) for dt in (bf16, f32)}
    for what, info in k10_launch.items():
        print(f"flash_decode launch ({what}, KVH={KVH}, group {H // KVH}, hd {HD}; "
              f"cudaFuncGetAttributes): registers {info['registers']} per thread, shared "
              f"memory {info['static_smem']} static + {info['dynamic_smem']} dynamic B per CTA, "
              f"{info['threads']} threads, cluster of {info['cluster']} CTAs "
              f"({info['resident_clusters']} resident at once), local memory "
              f"{info['local_bytes']} B, {'tensor-core' if info['tensor_cores'] else 'FMA'} "
              f"kernel", flush=True)
    del ck, cv

    # K10 beside SDPA at one request of length 4096 and at the ragged lengths
    # of phase 2, bf16, device time over enough copies of the cache that each
    # call finds its cache cold in the L2
    def k10_beside_sdpa(lengths_):
        b_ = len(lengths_)
        ln = torch.tensor(lengths_, dtype=torch.int32, device=dev)
        valid_bytes = 2 * KVH * sum(lengths_) * HD * 2
        copies = max(2, -(-120_000_000 // valid_bytes))
        qq = randn(b_, H, HD, dtype=bf16)
        caches = [(randn(b_, T, KVH, HD, dtype=bf16), randn(b_, T, KVH, HD, dtype=bf16))
                  for _ in range(copies)]
        m = (torch.arange(T, device=dev) < ln[:, None])[:, None, None, :]
        k_ms = device_ms(torch, lambda: [fd.flash_decode_cache(qq, kk, vv, ln)
                                         for kk, vv in caches], reps=3, names=k10_names,
                         launches=copies)
        s_ms = device_ms(torch, lambda: [F.scaled_dot_product_attention(
            qq[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=m,
            enable_gqa=True) for kk, vv in caches], reps=3) / copies
        b_ms = bound_ms(valid_bytes + 2 * qq.numel() * 2 + b_ * 4,
                        4 * H * sum(lengths_) * HD, BF16_FLOPS_PER_S)[0]
        return k_ms, s_ms, b_ms

    k10_more = {"B=1 length 4096": k10_beside_sdpa((T,)),
                f"B={B} lengths {DECODE_LENGTHS}": k10_beside_sdpa(DECODE_LENGTHS)}
    torch.cuda.empty_cache()

    # K11 at (1, 32, 4096, 128) bf16: causal (the kernels line), windowed and
    # non-causal beside SDPA (is_causal, or the boolean window mask)
    q, k, v = (randn(1, H, ATTN_S, HD, dtype=bf16) for _ in range(3))
    t = rows["flash_attention"]
    kernel_ms(torch, "flash_attention", t, lambda: fa.flash_attention(q, k, v, causal=True),
              reps=5, device_reps=5)
    t["plain_ms"] = cuda_ms(torch, lambda: kref.flash_attention_ref(q, k, v, causal=True),
                            reps=3)
    pairs = ATTN_S * (ATTN_S + 1) // 2  # unmasked (row, col) pairs per head
    t["bound_ms"], t["bound_by"] = bound_ms(4 * q.numel() * 2, 4 * H * pairs * HD,
                                            BF16_FLOPS_PER_S)
    t["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=5)
    # the float32 3xTF32 kernel on the same inputs; its bound is its three
    # TF32 products (big x big, big x small, small x big) at the TF32 rate
    qf, kf, vf = q.float(), k.float(), v.float()
    t = rows["flash_attention_f32"]
    kernel_ms(torch, "flash_attention_f32", t,
              lambda: fa.flash_attention(qf, kf, vf, causal=True), reps=5, device_reps=5)
    t["plain_ms"] = cuda_ms(torch, lambda: kref.flash_attention_ref(qf, kf, vf, causal=True),
                            reps=3)
    t["bound_ms"], t["bound_by"] = bound_ms(4 * qf.numel() * 4, 3 * 4 * H * pairs * HD,
                                            TF32_FLOPS_PER_S)
    t["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True), reps=5)
    f32_launch = fa.launch_info(1, H, ATTN_S, HD)
    rows_ = torch.arange(ATTN_S, device=dev)
    window_mask = (rows_[None, :] <= rows_[:, None]) & (rows_[None, :] > rows_[:, None] - 1024)
    more = {}
    for tag, (x, y, z) in (("bf16", (q, k, v)), ("f32", (qf, kf, vf))):
        more[f"{tag} window 1024"] = (
            cuda_ms(torch, lambda: fa.flash_attention(x, y, z, window=1024), reps=5),
            cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                x, y, z, attn_mask=window_mask), reps=5))
        more[f"{tag} non-causal"] = (
            cuda_ms(torch, lambda: fa.flash_attention(x, y, z, causal=False), reps=5),
            cuda_ms(torch, lambda: F.scaled_dot_product_attention(x, y, z), reps=5))
    del qf, kf, vf
    for name in ("flash_decode", "flash_attention", "flash_attention_f32"):
        r = rows[name]
        how = ("device time, the layers' caches in turn" if name == "flash_decode"
               else "CUDA events")
        print(f"time {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA "
              f"{r['library_ms']:.4f} ms ({how})", flush=True)
    print(f"time flash_decode one cache over and over (warm L2): kernel {warm_ms:.4f} ms; on "
          f"the pre-expanded (B, H, T, hd) copy: kernel {k10_expanded_ms:.4f} ms, SDPA "
          f"{sdpa_expanded_ms:.4f} ms (device time)", flush=True)
    print(f"time flash_decode by CUDA events around one call: {k10_events_ms:.4f} ms (with the "
          "host's wrapper)", flush=True)
    for what, (k_ms, s_ms, b_ms) in k10_more.items():
        print(f"time flash_decode {what} bf16: kernel {k_ms:.4f} ms, SDPA {s_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms (device time, caches cold in the L2)", flush=True)
    print("host us per call at the decode shape: " + ", ".join(
        f"{name} {us:.1f}" for name, us in host.items()), flush=True)
    for name, (ms, lib_ms) in more.items():
        print(f"time flash_attention (1, {H}, {ATTN_S}, {HD}) {name}: kernel {ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms", flush=True)
    print(f"flash_attention_f32 launch ((1, {H}, {ATTN_S}, {HD}); cudaFuncGetAttributes): "
          f"{f32_launch['threads']} threads, registers {f32_launch['registers']} per thread, "
          f"shared memory {f32_launch['static_smem']} static + {f32_launch['dynamic_smem']} "
          f"dynamic B per CTA, {f32_launch['ctas']} CTAs ({f32_launch['ctas_per_sm']} an SM at "
          f"once), local memory {f32_launch['local_bytes']} B", flush=True)
    return rows


def _drive(torch, rows, path, needed, fn):
    """Drive one path of the new phases: the launch counts set to 0 just
    before ``fn`` and read just after, every kernel of ``needed`` required,
    the launches added to the kernels line's rows.  Returns (what ``fn``
    returned, the launches, ms on the host clock)."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = kernels.launch_counts()
    print(f"path {path} launches: {({k: v for k, v in launches.items() if v})} "
          f"({ms:.3f} ms host clock)", flush=True)
    for name in needed:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the path {path}")
    for name, count in launches.items():
        if name in rows:
            rows[name]["launches"] += count
    return res, launches, ms


def _verdict(path, what, ok):
    print(f"path {path}: {what} {'ok' if ok else 'WRONG'}", flush=True)
    if not ok:
        fail(f"path {path} wrong on {what}")


def _sched_oracle(np, rem, k):
    """The reference's admission order on the host: (remaining, arrival)."""
    return np.lexsort((np.arange(len(rem)), rem))[:k]


def dtype_phases(torch, dev, rows) -> None:
    """Phases 2-4 of the key dtypes that the stream, K7, ``s3_sort`` and the
    block path take since the 64-bit form of K5 and K7's key kinds: K5 on
    int64 codes (two duplicate-heavy runs of 2^24 with LLONG_MAX tails, and
    ragged sizes) against its plain twin and as the stable merge
    permutation; K7 on raw keys of float64 and int64 at 2^24 (NaN, +-0.0,
    +-inf, the dtype's max; the integer extremes) and of uint64, uint32,
    float16, uint16, int16, int8 and uint8 (and float32, int32 and bfloat16)
    at 2^24, k = 128 against sampled splitters, its batched form at (64,
    2^18) float64 and its radix mode on
    int64 codes at k = 256 (consumed 0 and 8), each against its plain twin
    and driven once per key kind; then the paths: the stream at its full
    size for each dtype (``external_sort`` and ``external_argsort`` of 2^27
    float64 in 16 chunks of 2^23, ``streaming_topk`` both ways, k = 1024, of
    2^28 bfloat16 keys from a CPU tensor in chunks of 2^24 (the float64 sort
    profiled once more),
    ``streaming_group_by`` of 2^26 RootDup uint16 in chunks of 2^22), each
    against ``torch.sort(stable=True)`` of the encoded keys on the card;
    ``s3_sort`` of 2^24 float64 with an int64 payload against
    ``torch.sort(stable=True)``; ``sort_blocks`` of 2^27 int64 keys in blocks
    of 1024 over 256 buckets, in place by K8.  Last, the new kernel rows'
    times and bounds.  Their launches join the kernels line."""
    import numpy as np

    from repro_torch import ops, stream
    from repro_torch.core import sampling
    from repro_torch.core.s3sort import s3_sort
    from repro_torch.data.distributions import make_input
    from repro_torch.kernels import block_permute as bp, classify as cl, merge_path as mp
    from repro_torch.kernels.ops import sort_blocks

    gen = torch.Generator(device=dev).manual_seed(4321)
    encode = ops.keyspace.encode
    signed_of = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    k = 128
    t_phase = time.time()

    def bits(t):
        return t.view(signed_of[t.element_size()])

    def check_equal(name, got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        print(f"{name} {what}: max_abs_err={err}", flush=True)
        if err != 0:
            fail(f"{name} differs from its plain twin on {what}")
        rows.setdefault(name, {"max_abs_err": 0, "launches": 0})

    def drive(path, needed, fn):
        res, launches, _ = _drive(torch, rows, path, needed, fn)
        return res, launches

    verdict = _verdict

    # ---- 2. K5 on int64 codes: duplicate-heavy runs (each value ~8,400 times
    # in both runs, spread over the high bits), the codes of NaN at the tails
    def sorted_run64(n, lo, hi):
        run = torch.sort(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                       dtype=torch.int64) << 40).values
        run[-max(1, n // 1000):] = torch.iinfo(torch.int64).max
        return run

    merge_a, merge_b = sorted_run64(N_BIG, -1000, 1000), sorted_run64(N_BIG, -1000, 1000)
    k5_cases = ((merge_a, merge_b), (sorted_run64(1_000_003, -50, 50), sorted_run64(77, -50, 50)),
                (sorted_run64(1000, 0, 10), merge_b[:0]))
    for a, b in k5_cases:
        got = mp.merge_path_perm(a, b)
        check_equal("merge_path64", got, mp.merge_path_perm_plain(a, b),
                    f"int64 {a.shape[0]} + {b.shape[0]}")
        if not torch.equal(got.to(torch.int64), torch.sort(torch.cat([a, b]),
                                                           stable=True).indices):
            fail("K5's int64 form is not the stable merge permutation")
    for tile in (mp.TILE, mp.MAX_TILE64):
        info = mp.launch_info(tile, key_bytes=8)
        print(f"merge_path64 launch (tile={tile}; cudaFuncGetAttributes): registers "
              f"{info['registers']} per thread, shared memory {info['static_smem']} static + "
              f"{info['dynamic_smem']} dynamic B per CTA, {info['threads']} threads, "
              f"{info['ctas_per_sm']} CTAs an SM at once, local memory {info['local_bytes']} B",
              flush=True)
        if info["local_bytes"]:
            fail(f"merge_path64 spills at tile {tile}")

    # ---- K7 on raw keys of every new key kind at 2^24, k = 128
    def full_bits(dtype, n):
        """Keys of dtype: random bits over the whole range, a heavy duplicate."""
        signed = signed_of[torch.empty((), dtype=dtype).element_size()]
        info = torch.iinfo(signed)
        x = torch.randint(info.min, info.max, (n,), generator=gen, device=dev, dtype=signed)
        x[::3] = x[1]
        return x.view(dtype)

    def extremes(x):
        s = bits(x)
        unsigned = x.dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
        info = torch.iinfo(s.dtype)
        s[::1009] = -1 if unsigned else info.max  # the dtype's max
        s[1::1013] = 0 if unsigned else info.min  # its min
        return x

    def float_specials(x):
        x[::1009] = float("nan")
        x[1::1013] = -0.0
        x[2::1019] = 0.0
        x[3::1021] = float("inf")
        x[4::1031] = float("-inf")
        x[5::1033] = torch.finfo(x.dtype).max
        return x

    def sorted_splitters(x, k_):
        """k_-1 keys of a sorted sample (keyspace order: NaN last), picked on
        the keys' signed view (torch's unsigned dtypes lack most ops)."""
        pos = torch.randint(0, x.shape[-1], x.shape[:-1] + (4 * k_,), generator=gen, device=dev)
        sample = torch.gather(bits(x), -1, pos)
        order = torch.sort(encode(sample.view(x.dtype)), dim=-1, stable=True).indices
        sample = torch.gather(sample, -1, order)
        return sampling.select_splitters(sample, k_).contiguous().view(x.dtype)

    normal64 = torch.randn(N_BIG, generator=gen, device=dev, dtype=torch.float64)
    normal64[3::3] *= 1e300  # the float64 range beyond float32's
    k7_in = {
        "float64": float_specials(normal64),
        "int64": extremes(full_bits(torch.int64, N_BIG)),
        "uint64": extremes(full_bits(torch.uint64, N_BIG)),
        "uint32": extremes(full_bits(torch.uint32, N_BIG)),
        "float16": float_specials(torch.randn(N_BIG, generator=gen, device=dev).to(torch.float16)),
        "uint16": extremes(full_bits(torch.uint16, N_BIG)),
        "int16": extremes(full_bits(torch.int16, N_BIG)),
        "int8": extremes(full_bits(torch.int8, N_BIG)),
        "uint8": extremes(full_bits(torch.uint8, N_BIG)),
        # the kinds of phase 2's K7 check, driven here by kind too
        "float32": float_specials(torch.randn(N_BIG, generator=gen, device=dev)),
        "int32": extremes(full_bits(torch.int32, N_BIG)),
        "bfloat16": float_specials(torch.randn(N_BIG, generator=gen, device=dev).to(
            torch.bfloat16)),
    }
    k7_spl = {tag: sorted_splitters(x, k) for tag, x in k7_in.items()}
    k7_want = {}
    for tag, x in k7_in.items():
        k7_want[tag] = cl.classify_histogram_plain(x, k7_spl[tag], k=k)
        check_equal(cl.launch_name("classify_histogram", x.dtype),
                    cl.classify_histogram(x, k7_spl[tag], k=k), k7_want[tag],
                    f"{tag} n={N_BIG} k={k}")
    k7_rows = float_specials(torch.randn((B_BULK, N_ROW), generator=gen, device=dev,
                                         dtype=torch.float64))
    k7_rows_spl = sorted_splitters(k7_rows, k)
    k7_want["batched"] = cl.classify_histogram_batched_plain(k7_rows, k7_rows_spl, k=k)
    check_equal("classify_histogram_batched64",
                cl.classify_histogram_batched(k7_rows, k7_rows_spl, k=k), k7_want["batched"],
                f"float64 ({B_BULK}, {N_ROW}) per-row splitters k={k}")
    radix64 = full_bits(torch.int64, N_BIG).clone()
    radix64[::1009] = torch.iinfo(torch.int64).max  # the code of NaN
    for consumed in (0, 8):
        k7_want[f"radix {consumed}"] = cl.radix_histogram_plain(radix64, k=K_RADIX,
                                                                consumed_bits=consumed)
        check_equal("radix_histogram64", cl.radix_histogram(radix64, k=K_RADIX,
                                                            consumed_bits=consumed),
                    k7_want[f"radix {consumed}"],
                    f"int64 codes n={N_BIG} k={K_RADIX} consumed={consumed}")

    # ---- 3. the paths: K5 64-bit, K7 once per key kind
    got, _ = drive(f"K5 int64 ({N_BIG} + {N_BIG})", ("merge_path64",),
                   lambda: mp.merge_path_perm(merge_a, merge_b))
    verdict("K5 int64", "merge_path_perm", torch.equal(got, mp.merge_path_perm_plain(merge_a,
                                                                                    merge_b)))
    for tag, x in k7_in.items():
        name = cl.launch_name("classify_histogram", x.dtype)
        got, launches = drive(f"K7 {tag} ({N_BIG} keys, k={k})", (name,),
                              lambda x=x, tag=tag: cl.classify_histogram(x, k7_spl[tag], k=k))
        verdict(f"K7 {tag}", name, all(torch.equal(g, w) for g, w in zip(got, k7_want[tag])))
        rows[name].setdefault("kinds", {})[tag] = launches[name]
    got, launches = drive(f"K7 float64 batched ({B_BULK}, {N_ROW})",
                          ("classify_histogram_batched64",),
                          lambda: cl.classify_histogram_batched(k7_rows, k7_rows_spl, k=k))
    verdict("K7 float64 batched", "classify_histogram_batched",
            all(torch.equal(g, w) for g, w in zip(got, k7_want["batched"])))
    rows["classify_histogram_batched64"]["kinds"] = {"float64": launches[
        "classify_histogram_batched64"]}
    got, launches = drive(f"K7 int64 radix ({N_BIG} codes, k={K_RADIX})", ("radix_histogram64",),
                          lambda: [cl.radix_histogram(radix64, k=K_RADIX, consumed_bits=c)
                                   for c in (0, 8)])
    verdict("K7 int64 radix", "radix_histogram", all(
        torch.equal(g, w) for c, pair in zip((0, 8), got)
        for g, w in zip(pair, k7_want[f"radix {c}"])))
    rows["radix_histogram64"]["kinds"] = {"int64 codes": launches["radix_histogram64"]}
    print(f"dtype phases: kernels checked and driven in {time.time() - t_phase:.1f} s",
          flush=True)

    # ---- the stream at full size for each dtype
    sort64 = ("level_fused64", "rank_hist", "sort_windows64")
    sort32 = ("level_fused", "rank_hist", "sort_windows")
    t0 = time.time()
    x64 = make_input("Uniform", N_STREAM // 2, np.float64, seed=41)
    x64[3::3] *= -1
    x64[::1009] = np.nan
    x64[1::1013] = -0.0
    x64[2::1019] = 0.0
    x64[4::1021] = np.inf
    x64[5::1031] = -np.inf
    print(f"stream input: {x64.shape[0]} float64 keys on the host in {time.time() - t0:.1f} s",
          flush=True)
    path = f"stream sort ({x64.shape[0]} float64 keys, chunks of {CHUNK // 2})"
    got, _ = drive(path, sort64 + ("merge_path64",), lambda: {
        "external_sort": stream.external_sort(x64, chunk_size=CHUNK // 2),
        "external_argsort": stream.external_argsort(x64, chunk_size=CHUNK // 2)})
    enc = encode(torch.as_tensor(x64, device=dev))
    want = torch.sort(enc, stable=True)
    verdict(path, "external_sort", got["external_sort"].dtype == np.float64 and torch.equal(
        encode(torch.as_tensor(got["external_sort"], device=dev)), want.values))
    verdict(path, "external_argsort", torch.equal(
        torch.as_tensor(got["external_argsort"], device=dev).to(torch.int64), want.indices))
    del got, enc, want
    stream_profile = profile(torch, f"stream.external_sort {x64.shape[0]} float64 keys, chunks "
                             f"of {CHUNK // 2}", lambda: stream.external_sort(
                                 x64, chunk_size=CHUNK // 2), top=10, show=("merge_kernel<",))
    del x64, stream_profile

    bf = torch.randn(N_STREAM, generator=gen, device=dev).to(torch.bfloat16)
    bf[3::3] *= -1
    bf[::1009] = float("nan")
    bf[1::1013] = -0.0
    bf[2::1019] = 0.0
    bf[4::1021] = float("inf")
    bf_host = bf.cpu()  # the host form of bfloat16 keys without ml_dtypes
    path = f"stream top-k ({N_STREAM} bfloat16 keys from a CPU tensor, k={STREAM_K})"
    got, _ = drive(path, sort32 + ("merge_path",), lambda: {
        "streaming_topk": stream.streaming_topk(bf_host, STREAM_K, chunk_size=CHUNK),
        "streaming_bottomk": stream.streaming_topk(bf_host, STREAM_K, chunk_size=CHUNK,
                                                   largest=False)})
    codes = encode(bf)
    for name, c in (("streaming_topk", ~codes), ("streaming_bottomk", codes)):
        order = torch.sort(c, stable=True).indices[:STREAM_K]
        vals, idx = got[name]
        verdict(path, name, vals.dtype == torch.bfloat16
                and torch.equal(torch.as_tensor(idx, device=dev).to(torch.int64), order)
                and torch.equal(encode(vals.to(dev)), codes[order]))
    del got, codes, bf, bf_host

    group16 = make_input("RootDup", N_GROUPS, np.uint16, seed=43)
    path = f"stream group-by ({N_GROUPS} RootDup uint16, chunks of {CHUNK_GROUPS})"
    got, _ = drive(path, sort32 + ("merge_path",), lambda: stream.streaming_group_by(
        group16, chunk_size=CHUNK_GROUPS))
    vals, counts = got
    want_v, want_c = torch.unique(encode(torch.as_tensor(group16.view(np.int16), device=dev)
                                         .view(torch.uint16)), return_counts=True)
    verdict(path, f"streaming_group_by ({vals.shape[0]} groups)", vals.dtype == np.uint16
            and torch.equal(encode(torch.as_tensor(vals.view(np.int16), device=dev)
                                   .view(torch.uint16)), want_v)
            and torch.equal(torch.as_tensor(counts, device=dev), want_c))
    del got, group16

    # ---- s3_sort of 2^24 float64 with an int64 payload, and sort_blocks of
    # 2^27 int64 keys in place by K8
    s3_x = float_specials(torch.randn(N_BIG, generator=gen, device=dev, dtype=torch.float64))
    s3_v = torch.arange(N_BIG, device=dev, dtype=torch.int64)
    path = f"s3-sort ({N_BIG} float64 with NaN/+-0.0/+-inf, int64 payload)"
    got, _ = drive(path, (), lambda: s3_sort(s3_x, s3_v))
    want = torch.sort(s3_x, stable=True)
    verdict(path, "s3_sort", torch.equal(bits(got[0]), bits(want.values))
            and torch.equal(got[1], want.indices))
    print(f"time whole s3_sort {N_BIG} float64 with int64 payload: "
          f"{cuda_ms(torch, lambda: s3_sort(s3_x, s3_v), reps=5):.3f} ms, torch.sort(stable) "
          f"{cuda_ms(torch, lambda: torch.sort(s3_x, stable=True), reps=5):.3f} ms", flush=True)
    del got, want, s3_x, s3_v

    n_blocks64 = N_STREAM // 2 // BLOCK
    bb64 = torch.randint(0, N_BUCKETS, (n_blocks64,), generator=gen, device=dev,
                         dtype=torch.int32)
    keys64 = (torch.arange(n_blocks64, device=dev, dtype=torch.int64)[:, None] * (1 << 32)
              + torch.arange(BLOCK, device=dev, dtype=torch.int64)).reshape(-1)
    before64 = keys64.clone()
    order64 = torch.sort(bb64, stable=True).indices
    want_d = torch.zeros(N_BUCKETS + 1, dtype=torch.int32, device=dev)
    want_d[1:] = torch.cumsum(torch.bincount(bb64, minlength=N_BUCKETS), 0)
    ptr = keys64.data_ptr()
    path = f"sort_blocks ({keys64.shape[0]} int64 keys, blocks of {BLOCK}, {N_BUCKETS} buckets)"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, _ = drive(path, ("permute_blocks_by_dest",),
                   lambda: sort_blocks(keys64, bb64, k=N_BUCKETS, block_elems=BLOCK))
    rise = torch.cuda.max_memory_allocated() - base
    out, d = got
    print(f"sort_blocks int64 in place: data_ptr kept {out.data_ptr() == ptr}, peak rise "
          f"{rise} B of {keys64.numel() * 8} B of data", flush=True)
    verdict(path, "sort_blocks", out.data_ptr() == ptr and rise <= keys64.numel() * 8 // 4
            and torch.equal(d, want_d)
            and torch.equal(out.view(n_blocks64, BLOCK), before64.view(n_blocks64, BLOCK)[order64]))
    body64 = before64.view(n_blocks64, BLOCK)
    print(f"time whole sort_blocks {keys64.shape[0]} int64: "
          f"{cuda_ms(torch, lambda: sort_blocks(keys64, bb64, k=N_BUCKETS, block_elems=BLOCK), warmup=1, reps=3):.3f} ms, "
          f"index_select of the blocks {cuda_ms(torch, lambda: body64.index_select(0, order64), warmup=1, reps=3):.3f} ms",
          flush=True)
    del got, out, before64, keys64, body64
    torch.cuda.empty_cache()
    print(f"dtype phases: paths in {time.time() - t_phase:.1f} s", flush=True)

    # ---- 4. the new kernel rows: device time, bound, plain twin and library
    def time_row(name, call, plain, nbytes, ops, library=None):
        t = rows[name]
        kernel_ms(torch, name, t, call)
        t["plain_ms"] = cuda_ms(torch, plain, reps=3)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, ops)
        t["library_ms"] = cuda_ms(torch, library, reps=5) if library else None

    # K5: a key read (8 B) and a source written (4 B) per output; ~6 ops
    merge_cat = torch.cat([merge_a, merge_b])
    time_row("merge_path64", lambda: mp.merge_path_perm(merge_a, merge_b),
             lambda: mp.merge_path_perm_plain(merge_a, merge_b), 2 * N_BIG * 12, 2 * N_BIG * 6,
             lambda: torch.sort(merge_cat, stable=True))
    work = {e.key: e.count for e in one_kernel_a_call(
        torch, "merge_path64", lambda: mp.merge_path_perm(merge_a, merge_b),
        lambda e: any(f in e.key for f in DEVICE_FUNCTIONS["merge_path64"]))}
    print(f"merge_path64 device work in 10 calls (torch.profiler): {work}", flush=True)
    # K7: a key read and an id written per key, the uppers and the (tiles, 2k)
    # histogram; tree ~3 ops a search step plus ~6, radix ~8
    log_k = k.bit_length() - 1
    for name, tag in (("classify_histogram64", "float64"), ("classify_histogram16", "float16"),
                      ("classify_histogram8", "uint8")):
        x, s = k7_in[tag], k7_spl[tag]
        kb = x.element_size()
        tiles = N_BIG // (cl.default_rows(N_BIG, kb, k) * cl.LANES)
        time_row(name, lambda x=x, s=s: cl.classify_histogram(x, s, k=k),
                 lambda x=x, s=s: cl.classify_histogram_plain(x, s, k=k),
                 N_BIG * (kb + 4) + k * kb + tiles * 2 * k * 4, N_BIG * (3 * log_k + 6))
    tiles = B_BULK * (N_ROW // (cl.default_rows(N_ROW, 8, k) * cl.LANES))
    time_row("classify_histogram_batched64",
             lambda: cl.classify_histogram_batched(k7_rows, k7_rows_spl, k=k),
             lambda: cl.classify_histogram_batched_plain(k7_rows, k7_rows_spl, k=k),
             B_BULK * N_ROW * 12 + B_BULK * k * 8 + tiles * 2 * k * 4,
             B_BULK * N_ROW * (3 * log_k + 6))
    tiles = N_BIG // (cl.default_rows(N_BIG, 8, K_RADIX) * cl.LANES)
    time_row("radix_histogram64", lambda: cl.radix_histogram(radix64, k=K_RADIX),
             lambda: cl.radix_histogram_plain(radix64, k=K_RADIX),
             N_BIG * 12 + tiles * 2 * K_RADIX * 4, N_BIG * 8)
    for tag in ("int64", "uint64", "uint32", "uint16", "int16", "int8"):
        x, s = k7_in[tag], k7_spl[tag]
        print(f"time classify_histogram {tag} (n={N_BIG}, k={k}): kernel "
              f"{cuda_ms(torch, lambda: cl.classify_histogram(x, s, k=k)):.4f} ms, device "
              f"{device_ms(torch, lambda: cl.classify_histogram(x, s, k=k), names=DEVICE_FUNCTIONS['classify_histogram']):.4f} ms",
              flush=True)
    for name in ("merge_path64", "classify_histogram64", "classify_histogram16",
                 "classify_histogram8", "classify_histogram_batched64", "radix_histogram64"):
        r = rows[name]
        print(f"time {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}, "
              f"launches {r['launches']} {r.get('kinds', '')}", flush=True)
    print(f"dtype phases: {time.time() - t_phase:.1f} s in all", flush=True)


def scheduler_phases(torch, dev, rows) -> None:
    """Phases 3 and 4 of the scheduler and the data pipeline at the sizes of a
    serving queue and a corpus: ``Scheduler.next_batch`` on 65,536 requests
    (three admissions of 256), ``admit_many`` over 64 queues of 4096 (rows
    below W, one stable torch sort a row, as the reference plans them) and
    of 16,384, ``attach_backlog`` of 16,384 requests and ``next_batch`` on the
    merged view (K5), each held to the host oracle (``np.lexsort`` on
    (remaining, arrival), the backlog first on ties); then the length
    argsort of ``pack_by_length`` at 2^22 documents against
    ``torch.sort(stable=True)``, and whole packs of 8192 documents (1-D and
    chunked) against the CPU's.  Their launches join the kernels line."""
    import numpy as np

    from repro_torch.data.pipeline import pack_by_length
    from repro_torch.ops import get_sorter
    from repro_torch.serve.scheduler import Request, Scheduler, admit_many

    rng = np.random.default_rng(90)

    def drive(path, needed, fn):
        res, _, ms = _drive(torch, rows, path, needed, fn)
        return res, ms

    verdict = _verdict

    def queue_of(n, start=0, batch=SCHED_BATCH):
        s = Scheduler(batch_size=batch, device=dev)
        rem = rng.integers(1, SCHED_MAX_NEW + 1, n)
        for uid, m in enumerate(rem):
            s.submit(Request(uid=start + uid, prompt_len=1024, max_new=int(m)))
        return s

    # next_batch on a queue of 65,536 (many ties: 4096 values)
    sched = queue_of(SCHED_QUEUE)
    admit_ms = []
    for i in range(3):
        rem = np.asarray([r.remaining for r in sched.queue])
        uids = np.asarray([r.uid for r in sched.queue])
        want = uids[_sched_oracle(np, rem, SCHED_BATCH)].tolist()
        path = f"scheduler next_batch ({len(rem)} requests, batch {SCHED_BATCH}, admission {i})"
        got, ms = drive(path, ("level_fused", "sort_windows"), sched.next_batch)
        admit_ms.append(ms)
        verdict(path, "admitted uids equal the host oracle", [r.uid for r in got] == want)

    # admit_many: 64 queues of 4096 (below W: no level), then 64 of 16,384 (K4)
    for n, needed in ((SCHED_GROUP_N, ()), (SCHED_WIDE_N, ("level_fused_batched", "sort_windows"))):
        fleet = [queue_of(n, batch=8) for _ in range(SCHED_GROUPS)]
        want = [[s.queue[i].uid for i in _sched_oracle(
            np, np.asarray([r.remaining for r in s.queue]), 8)] for s in fleet]
        path = f"scheduler admit_many ({SCHED_GROUPS} queues x {n}, batch 8)"
        got, ms = drive(path, needed, lambda: admit_many(fleet))
        admit_ms.append(ms)
        verdict(path, "every queue's admitted uids equal the host oracle",
                [[r.uid for r in b] for b in got] == want)
        del fleet

    # attach_backlog of 16,384, then next_batch on the merged view
    back = [Request(uid=10_000_000 + i, prompt_len=1024, max_new=int(m))
            for i, m in enumerate(rng.integers(1, SCHED_MAX_NEW + 1, SCHED_BACKLOG))]
    path = f"scheduler attach_backlog ({SCHED_BACKLOG} requests)"
    _, ms = drive(path, ("level_fused", "sort_windows"), lambda: sched.attach_backlog(back))
    b_rem = np.asarray([r.remaining for r in back])
    want_back = [back[i].uid for i in _sched_oracle(np, b_rem, len(back))]
    verdict(path, "the backlog run equals the host oracle", [r.uid for r in sched.backlog]
            == want_back)
    l_rem = np.asarray([r.remaining for r in sched.queue])
    l_order = _sched_oracle(np, l_rem, SCHED_BATCH)
    cands = ([(int(b_rem[i]), 0, j, back[i].uid)
              for j, i in enumerate(_sched_oracle(np, b_rem, SCHED_BATCH))]
             + [(int(l_rem[i]), 1, j, sched.queue[i].uid) for j, i in enumerate(l_order)])
    want = [c[3] for c in sorted(cands)[:SCHED_BATCH]]
    path = f"scheduler next_batch on the merged view ({len(l_rem)} live + {SCHED_BACKLOG} backlog)"
    got, ms = drive(path, ("level_fused", "sort_windows", "merge_path"), sched.next_batch)
    admit_ms.append(ms)
    verdict(path, "admitted uids equal the host oracle (backlog first on ties)",
            [r.uid for r in got] == want)
    print(f"time scheduler admissions (host clock, Python queue to admitted list): next_batch "
          f"on {SCHED_QUEUE} {[round(m, 3) for m in admit_ms[:3]]} ms, admit_many "
          f"{SCHED_GROUPS} x {SCHED_GROUP_N} {admit_ms[3]:.3f} ms, {SCHED_GROUPS} x "
          f"{SCHED_WIDE_N} {admit_ms[4]:.3f} ms, merged view {admit_ms[5]:.3f} ms", flush=True)
    q_keys = torch.as_tensor(rng.integers(0, 1 << 28, SCHED_QUEUE).astype(np.int32), device=dev)
    f = get_sorter(SCHED_QUEUE, torch.int32, "bottomk", k=SCHED_BATCH, device=dev)
    print(f"time scheduler bottomk alone ({SCHED_QUEUE} int32 composite keys, k {SCHED_BATCH}): "
          f"{cuda_ms(torch, lambda: f(q_keys)):.3f} ms by events, torch.topk "
          f"{cuda_ms(torch, lambda: torch.topk(q_keys, SCHED_BATCH, largest=False)):.3f} ms",
          flush=True)
    del sched, back, q_keys

    # the data pipeline
    lengths = torch.as_tensor(rng.integers(1, 4096, PACK_SORT_N).astype(np.int32), device=dev)
    argsort = get_sorter(PACK_SORT_N, torch.int32, op="argsort", device=dev)
    path = f"pipeline length argsort ({PACK_SORT_N} documents, pack_by_length's sorter)"
    idx, _ = drive(path, ("level_fused", "rank_hist", "sort_windows"), lambda: argsort(lengths))
    verdict(path, "equal to torch.sort(stable=True)",
            torch.equal(idx.to(torch.int64), torch.sort(lengths, stable=True).indices))
    sort_ms = cuda_ms(torch, lambda: argsort(lengths))
    print(f"time pipeline length argsort {PACK_SORT_N}: {sort_ms:.3f} ms, torch.sort "
          f"{cuda_ms(torch, lambda: torch.sort(lengths, stable=True)):.3f} ms (CUDA events)",
          flush=True)
    docs = rng.integers(1, 512, PACK_N).astype(np.int32)
    want = pack_by_length(docs, PACK_SEQ, device="cpu")
    for what, kw, needed in (("1-D", {}, ()), (f"chunk_size={PACK_CHUNK}",
                                                {"chunk_size": PACK_CHUNK}, ("merge_path",))):
        path = f"pipeline pack_by_length {what} ({PACK_N} documents, rows of {PACK_SEQ})"
        got, ms = drive(path, needed, lambda: pack_by_length(docs, PACK_SEQ, device=dev, **kw))
        verdict(path, f"{got[2]} rows, row ids and offsets equal the CPU's",
                got[2] == want[2] and np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]))
    del lengths, idx


def family_phases(torch, dev, rows) -> None:
    """Phases 2-4 of the served families at full width: K10 at their two new
    shapes (group 1, hd 128 and hd 80) against its twin, then for each of
    deepseek-moe-16b, rwkv6-1.6b and zamba2-2.7b (bf16, random weights from a
    seeded CUDA generator, published widths and depth) the admission of 8
    requests from a queue of 65,536 and ``Engine.generate`` of 32 greedy tokens
    after 1024-token prompts under ``flash_decode``: K6's dispatch bit for bit
    against the plain dispatch on every served MoE layer (the dropped entries
    printed), K10 once per attention layer per decode step, two calls equal,
    the teacher-forced checks, prefill and decode times and profiles."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd, ref as kref
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import (
        forward, init_decode_cache, init_model, reset_decode_cache,
    )
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    B, T = SERVE_BATCH, SERVE_MAX_SEQ
    gen = torch.Generator(device=dev).manual_seed(777)
    rng = np.random.default_rng(91)

    def drive(path, needed, fn):
        res, launches, _ = _drive(torch, rows, path, needed, fn)
        return res, launches

    verdict = _verdict

    # ---- 2. K10 at the two new shapes, against its twin -------------------
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    short = torch.where(lengths == T, lengths - FAULT_KEYS, lengths)
    for name in ("deepseek-moe-16b", "zamba2-2.7b"):
        cfg = get_config(name)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        for dtype in (f32, bf16):
            q = torch.randn((B, h, hd), generator=gen, device=dev).to(dtype)
            ck = torch.randn((B, T, kvh, hd), generator=gen, device=dev).to(dtype)
            cv = torch.randn((B, T, kvh, hd), generator=gen, device=dev).to(dtype)

            def twin(lens):
                return kref.flash_decode_ref(q[:, :, None], ck.transpose(1, 2),
                                             cv.transpose(1, 2), lens)[:, :, 0].float()

            want, dropped = twin(lengths), twin(short)
            got = fd.flash_decode_cache(q, ck, cv, lengths).float()
            torch.cuda.synchronize()
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            limit = atol + rtol * want.abs()
            diff = (got - want).abs()
            err = float(diff.max())
            ok = bool((diff <= limit).all())
            caught = bool(((dropped - want).abs() > limit).any())
            info = fd.launch_info(B, kvh, h // kvh, hd, dtype)
            print(f"flash_decode {name} {dtype} cache (B, T, KVH, hd) = ({B}, {T}, {kvh}, {hd}), "
                  f"group {h // kvh}, lengths {DECODE_LENGTHS}: max_abs_err={err:.3e} (limit "
                  f"{atol} + {rtol} * |want|); a dropped tile of {FAULT_KEYS} keys "
                  f"{'flagged' if caught else 'NOT flagged'}; "
                  f"{'tensor-core' if info['tensor_cores'] else 'FMA'} kernel, registers "
                  f"{info['registers']}, cluster {info['cluster']}, local memory "
                  f"{info['local_bytes']} B {'ok' if ok and caught else 'WRONG'}", flush=True)
            if not (ok and caught):
                fail(f"flash_decode at {name}'s shape ({dtype}) differs from its twin or its "
                     "limit does not flag a dropped tile")
            rows["flash_decode"]["max_abs_err"] = max(rows["flash_decode"]["max_abs_err"], err)
            del q, ck, cv, want, dropped, got
    torch.cuda.empty_cache()

    # ---- 3 and 4. each family served at full width --------------------------
    for name in FAMILIES:
        t_family = time.time()
        cfg = get_config(name)
        torch.cuda.empty_cache()
        print(f"serve {name}: device memory allocated before the model "
              f"{torch.cuda.memory_allocated()} B", flush=True)
        t0 = time.time()
        model = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        attn_layers = (cfg.num_layers // cfg.ssm.attn_every if cfg.family == "hybrid"
                       else 0 if cfg.family == "ssm" else cfg.num_layers)
        print(f"serve {name}: {cfg.num_layers} layers ({attn_layers} attention), {n_params} "
              f"parameters, {weight_bytes} B, random from a seeded CUDA generator in "
              f"{time.time() - t0:.1f} s", flush=True)
        engine = Engine(cfg, ServeConfig(max_seq=FAMILY_MAX_SEQ, batch_size=B), model,
                        device=dev)
        sched = Scheduler(batch_size=B, device=dev)
        for uid, m in enumerate(rng.integers(SERVE_NEW, SCHED_MAX_NEW + 1, SCHED_QUEUE)):
            sched.submit(Request(uid=uid, prompt_len=SERVE_PROMPT, max_new=int(m)))
        rem = np.asarray([r.remaining for r in sched.queue])
        want_wave = _sched_oracle(np, rem, B).tolist()
        prompts = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT), generator=gen, device=dev)

        def serve(flash=True):
            with compute_policy(flash_decode=flash):
                return engine.generate(prompts, SERVE_NEW)

        def admit_and_serve():
            return sched.next_batch(), serve()

        needed = ["level_fused", "sort_windows"]  # the admission's bottom-k
        if attn_layers:
            needed.append("flash_decode")
        if cfg.family == "moe":
            needed.append("dispatch_ranks")
        path = (f"serve {name} ({cfg.num_layers} layers, bf16; {B} requests admitted from "
                f"{SCHED_QUEUE} x {SERVE_PROMPT} prompt tokens, {SERVE_NEW} new, greedy, "
                "flash_decode)")
        (wave, tokens), launches = drive(path, needed, admit_and_serve)
        verdict(path, "the wave equals the host oracle", [r.uid for r in wave] == want_wave)
        verdict(path, f"K10 launched {launches['flash_decode']} times = {attn_layers} attention "
                f"layers x {SERVE_NEW} decode steps",
                launches["flash_decode"] == attn_layers * SERVE_NEW)
        if cfg.family == "moe":
            verdict(path, f"K6 dispatch_ranks launched {launches['dispatch_ranks']} times = "
                    f"{cfg.num_layers} layers x {SERVE_NEW + 1} forwards",
                    launches["dispatch_ranks"] == cfg.num_layers * (SERVE_NEW + 1))
        verdict(path, f"tokens {tuple(tokens.shape)} in the vocabulary; first request "
                f"{tokens[0, :12].tolist()}", tokens.shape == (B, SERVE_NEW)
                and tokens.dtype == torch.int32 and int(tokens.min()) >= 0
                and int(tokens.max()) < cfg.vocab_size)

        # the same generate again; for the MoE every layer's served routing is
        # recorded and K6's dispatch held to the plain one (the CPU's
        # partition_permutation) bit for bit
        routed = []
        if cfg.family == "moe":
            plain = moe_mod.sort_dispatch

            def recording(expert_id, num_experts, capacity, **kw):
                out = plain(expert_id, num_experts, capacity, **kw)
                routed.append((expert_id.clone(), capacity, tuple(t.clone() for t in out)))
                return out

            moe_mod.sort_dispatch = recording
        try:
            again = serve()
        finally:
            if cfg.family == "moe":
                moe_mod.sort_dispatch = plain
        verdict(path, "two generate calls on one engine equal", torch.equal(tokens, again))
        if cfg.family == "moe":
            same, dropped = True, {}
            for ids, cap, got in routed:
                want = moe_mod.sort_dispatch(ids.cpu(), cfg.moe.num_experts, cap)
                same = same and all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
                key = "prefill" if ids.shape[0] > B * cfg.moe.top_k else "decode"
                dropped[key] = dropped.get(key, 0) + int((~got[1]).sum())
            cap = moe_mod.expert_capacity(B * SERVE_PROMPT, cfg.moe.num_experts, cfg.moe.top_k,
                                          cfg.moe.capacity_factor)
            entries = cfg.num_layers * B * SERVE_PROMPT * cfg.moe.top_k
            verdict(path, f"K6 dispatch equal to the plain dispatch bit for bit on all "
                    f"{len(routed)} served MoE layer calls (dropped entries: prefill "
                    f"{dropped.get('prefill', 0)} of {entries} at capacity {cap}, decode "
                    f"{dropped.get('decode', 0)})", same)
            del routed

        # timing: prefill, then generate; decode per step = (generate - prefill) / 32
        def prefill():
            reset_decode_cache(engine.cache)
            forward(model, cfg, prompts, cache=engine.cache)

        reps = 1 if cfg.family == "ssm" else 2
        prefill_ms = cuda_ms(torch, prefill, warmup=1, reps=reps)
        gen_ms = cuda_ms(torch, serve, warmup=0, reps=reps)
        step_ms = (gen_ms - prefill_ms) / SERVE_NEW
        print(f"time serve {name}: generate {gen_ms:.3f} ms, prefill {prefill_ms:.3f} ms ({B} x "
              f"{SERVE_PROMPT} tokens), decode {step_ms:.3f} ms per step, "
              f"{B * 1e3 / step_ms:.1f} tokens/s", flush=True)
        if cfg.family == "ssm":
            # a loop over the tokens, ~170 launches each: the first 128 tokens
            # alone, the card's events alone (10^5 launches' events would take
            # the profiler minutes to sort; launches and kernel time scale
            # with the tokens)
            def prefill_head():
                reset_decode_cache(engine.cache)
                forward(model, cfg, prompts[:, :RWKV_PROFILE_TOKENS], cache=engine.cache)

            profile(torch, f"prefill of {name} ({B} x {RWKV_PROFILE_TOKENS} of its {SERVE_PROMPT} "
                    "tokens, the card's events alone)", prefill_head, top=8, cpu=False)
        else:
            profile(torch, f"prefill of {name} ({B} x {SERVE_PROMPT} tokens)", prefill, top=8)

        prefill()
        at = [SERVE_PROMPT]  # the decode steps go on from the prompt's end

        def decode_steps(n):
            with compute_policy(flash_decode=True):
                for _ in range(n):
                    forward(model, cfg, prompts[:, -1:], cache=engine.cache,
                            positions=torch.full((B, 1), at[0], device=dev))
                    at[0] += 1

        profile(torch, f"8 decode steps of {name} ({B} requests, K10 path)",
                lambda: decode_steps(8), top=10)
        del engine, sched, tokens, again
        torch.cuda.empty_cache()

        # teacher forced: prefill + decode (K10 and, where the model has
        # attention, eager) against the full forward at the same positions,
        # in float32: in bf16 rounding alone moves these models (the MoE's
        # top-k routing flips on near ties between the K10 path, with f32
        # softmax weights, and the eager one; Mamba2's bf16 dt moves its
        # cumulative decay; rwkv6 in bf16 moved 8.0% of its largest logit over
        # 1024 + 32 on an H100, cuBLAS taking other kernels for 8448, 8192 and
        # 8 rows).  The states the reference stores in bf16 (RWKV's shifts,
        # Mamba2's conv) are f32 here too: stored in bf16, a decode step reads
        # them rounded where the full forward reads them exact (5.5% of the
        # largest logit over 64 steps of a reduced f32 zamba2 on the CPU;
        # 1.8e-4 with f32 states)
        tf_cfg, plen, new, bt = cfg, SERVE_PROMPT, SERVE_NEW, B
        if cfg.family == "moe":  # two layers at full width, lossless capacity
            del model
            torch.cuda.empty_cache()
            tf_cfg = dataclasses.replace(cfg, num_layers=MOE_TF_LAYERS, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            tf_model = init_model(torch.Generator(device=dev).manual_seed(1), tf_cfg,
                                  dtype=f32, device=dev)
            plen, bt = MOE_TF_PROMPT, 1
        else:  # the served model, whole, in f32
            tf_model = model.float()
            if cfg.family == "hybrid":  # a length that its chunks of 128 divide
                new = HYBRID_TF_NEW
        tf_dtype = tf_model.dtype
        seq = torch.cat([prompts[:bt, :plen], torch.randint(
            0, cfg.vocab_size, (bt, new), generator=gen, device=dev)], dim=1)
        cache = init_decode_cache(tf_cfg, bt, FAMILY_MAX_SEQ, dtype=tf_dtype, device=dev)
        for c in cache["layers"]:  # the states kept in bf16 by the reference, in f32
            for state in ("tm_shift", "cm_shift", "conv"):
                if state in c:
                    c[state] = c[state].float()
        with compute_policy(flash_decode=True):
            forward(tf_model, tf_cfg, seq[:, :plen], cache=cache)
            logits = torch.stack([forward(tf_model, tf_cfg, seq[:, i:i + 1], cache=cache,
                                          positions=torch.full((bt, 1), i, device=dev))[0][:, 0]
                                  for i in range(plen, plen + new)], 1).float()
        full = forward(tf_model, tf_cfg, seq)[0][:, plen:].float()
        err = float((logits - full).abs().max()) / float(full.abs().max())
        verdict(f"serve {name}", f"teacher-forced {bt} x ({plen} + {new}), {tf_cfg.num_layers} "
                f"layers, {str(tf_dtype).split('.')[-1]}"
                + (", capacity factor 64" if cfg.family == "moe" else "")
                + f", prefill + {'K10 ' if attn_layers else ''}decode against the full forward: "
                f"max |diff| / max |logit| = {err:.4e} (tol {SERVE_TOL}; max |logit| "
                f"{float(full.abs().max()):.3f})", err <= SERVE_TOL)
        print(f"path serve {name}: argmax of the decode logits equal to the full forward's: "
              f"{float((logits.argmax(-1) == full.argmax(-1)).float().mean()):.4f} "
              "(measure only)", flush=True)
        del logits, full, seq, cache, tf_model, prompts
        if cfg.family != "moe":
            del model
        torch.cuda.empty_cache()
        print(f"serve {name}: {time.time() - t_family:.1f} s for this family's checks, times "
              "and profiles", flush=True)


def train_phases(torch, dev, rows) -> None:
    """Phases 3 and 4 of training.  ``path train deepseek-moe-16b``: 4 of its
    28 layers at published width (bf16, random weights from a seeded CUDA
    generator, ``cfg.remat`` on) through ``train.Trainer`` with the reference's
    ``TrainConfig`` defaults and microbatches of 2, eight ``run`` steps on one
    fixed batch of 4 x 4096 tokens (``data.pipeline.SyntheticLM``): every
    loss finite, the last below the first, K6 ``dispatch_ranks`` launched 4
    layers x 2 microbatches x 2 (forward and recompute) = 16 times a step,
    and every dispatch's ``dest`` (a hook on ``models.moe._stable_dest``)
    bit for bit the plain ``partition_permutation``'s on the CPU.  ``path
    train reduced``: reduced deepseek-moe-16b and yi-9b in float32, the
    card's ``train_loss`` and every gradient against the CPU's (the plain
    twins), two ``make_train_step`` steps with and without
    ``compress_grads`` against the CPU's, two ``Trainer`` runs from one seed
    bitwise equal, and 3 steps, a checkpoint, a restore in a fresh
    ``Trainer`` and 3 more steps bitwise equal to 6 straight.  ``time train``:
    eight more steps of the full-width case, the median step of steps 2-8,
    tokens/s, peak memory, the gradients and the optimizer timed apart, and
    a profile of one step (device ms, launches, idle share, K6's share)."""
    import copy
    import dataclasses
    import itertools
    import math

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_model, param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, init_error_feedback
    from repro_torch.train import TrainConfig, Trainer, make_train_step
    from repro_torch.train.trainer import _accumulate_grads
    from torch.utils import _pytree as pytree

    f32 = torch.float32

    def drive(path, needed, fn):
        res, launches, _ = _drive(torch, rows, path, needed, fn)
        return res, launches

    verdict = _verdict

    def parts(leaves):
        return [t for v in leaves.values() for t in (v if isinstance(v, tuple) else (v,))]

    def quiet_run(trainer, it, n):
        return trainer.run(it, n, ckpt_every=10 ** 9, log_every=10 ** 9, log=lambda *_: None)

    # ---- 3. the full-width case ----------------------------------------------
    t_train = time.time()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(microbatch=TRAIN_MICRO)  # the reference's defaults otherwise
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = Trainer(cfg, tcfg, seed=0, device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    model = trainer.state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = torch.cuda.memory_allocated()
    print(f"train {TRAIN_ARCH}: {TRAIN_LAYERS} of {get_config(TRAIN_ARCH).num_layers} layers at "
          f"published width, {n_params} parameters, remat {cfg.remat}, state (bf16 weights, "
          f"float32 moments) {state_bytes} B on the card, made in {time.time() - t0:.1f} s",
          flush=True)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch(0)
    cap = moe_mod.expert_capacity(TRAIN_MICRO * TRAIN_SEQ, cfg.moe.num_experts, cfg.moe.top_k,
                                  cfg.moe.capacity_factor)
    dests = []
    plain_dest = moe_mod._stable_dest

    def recording(expert_id, num_experts, tile):
        dest, offsets = plain_dest(expert_id, num_experts, tile)
        dests.append((expert_id.clone(), num_experts, tile, dest.clone(), offsets.clone()))
        return dest, offsets

    def eight_steps():
        it = itertools.repeat(batch)  # one fixed batch: the loss must fall
        return [quiet_run(trainer, it, 1)["loss"] for _ in range(TRAIN_STEPS)]

    per_step = TRAIN_LAYERS * (TRAIN_BATCH // TRAIN_MICRO) * 2
    path = (f"train {TRAIN_ARCH} ({TRAIN_LAYERS} layers, bf16, {TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in microbatches of {TRAIN_MICRO}, capacity {cap})")
    moe_mod._stable_dest = recording
    try:
        losses, launches = drive(path, ["dispatch_ranks"], eight_steps)
    finally:
        moe_mod._stable_dest = plain_dest
    verdict(path, f"losses {[round(x, 4) for x in losses]} finite",
            all(math.isfinite(x) for x in losses))
    verdict(path, f"the loss falls on the repeated batch ({losses[0]:.4f} -> {losses[-1]:.4f})",
            losses[-1] < losses[0])
    verdict(path, f"K6 dispatch_ranks launched {launches['dispatch_ranks']} times = {per_step} a "
            f"step ({TRAIN_LAYERS} layers x {TRAIN_BATCH // TRAIN_MICRO} microbatches x forward "
            f"and recompute) x {TRAIN_STEPS} steps",
            launches["dispatch_ranks"] == per_step * TRAIN_STEPS)
    same, dropped = True, 0
    for ids, num_experts, tile, dest, offsets in dests:
        want_dest, want_off = plain_dest(ids.cpu(), num_experts, tile)
        same = same and torch.equal(dest.cpu(), want_dest) and torch.equal(offsets.cpu(), want_off)
        counts = (offsets[:, 1:] - offsets[:, :-1]).cpu()
        dropped += int(torch.clamp(counts - cap, min=0).sum())
    entries = TRAIN_MICRO * TRAIN_SEQ * cfg.moe.top_k
    verdict(path, f"K6's dest bit for bit the plain partition_permutation's on all {len(dests)} "
            f"dispatches ({dropped} of {len(dests) * entries} entries beyond capacity)",
            same and len(dests) == per_step * TRAIN_STEPS)
    del dests

    # ---- 4. its times ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    first = len(trainer.step_times)
    quiet_run(trainer, itertools.repeat(batch), TRAIN_STEPS)
    times = trainer.step_times[first:]
    step_ms = 1e3 * statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"time train {TRAIN_ARCH}: step {step_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}, host "
          f"clock, one loss read a step; steps {[round(1e3 * t, 3) for t in times]}), "
          f"{tokens * 1e3 / step_ms:.1f} tokens/s, peak memory {peak} B "
          f"({peak / 1e9:.3f} GB)", flush=True)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    held = {}

    def grads_only():
        held["grads"] = _accumulate_grads(cfg, tcfg, model, tb)[2]

    grads_ms = cuda_ms(torch, grads_only, warmup=0, reps=1)
    opt = trainer.state["opt"]
    opt_ms = cuda_ms(torch, lambda: adamw_update(param_leaves(model), held["grads"], opt,
                                                 tcfg.adamw, 0.5), warmup=1, reps=3)
    print(f"time train {TRAIN_ARCH}: loss and gradients of {TRAIN_BATCH // TRAIN_MICRO} "
          f"microbatches {grads_ms:.3f} ms, AdamW alone {opt_ms:.3f} ms (CUDA events): the "
          f"optimizer's share of a step {opt_ms / step_ms:.4f}", flush=True)
    del held
    torch.cuda.empty_cache()
    prof = profile(torch, f"one train step of {TRAIN_ARCH} ({TRAIN_LAYERS} layers, "
                   f"{TRAIN_BATCH} x {TRAIN_SEQ})",
                   lambda: quiet_run(trainer, itertools.repeat(batch), 1), top=12,
                   show=DEVICE_FUNCTIONS["dispatch_ranks"])
    k6 = [e for e in prof["kernels"] if "dispatch_rank_kernel" in e.key]
    k6_ms = sum(device_us(e) for e in k6) / 1e3
    print(f"profile one train step: K6 {k6_ms:.4f} ms in {sum(e.count for e in k6)} launches, "
          f"{k6_ms / prof['kernel_ms']:.6f} of the step's kernel time", flush=True)
    del trainer, model, opt, tb
    torch.cuda.empty_cache()

    # ---- 3. the reduced models in float32 against the CPU ---------------------
    print(f"train reduced: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    for arch in TRAIN_REDUCED:
        rcfg = get_reduced(arch)
        needed = ["dispatch_ranks"] if rcfg.family == "moe" else []
        path = f"train reduced {arch} (float32)"
        cpu_model = init_model(torch.Generator().manual_seed(5), rcfg, dtype=f32, device="cpu")
        data = SyntheticLM(rcfg.vocab_size, TRAIN_REDUCED_SEQ, TRAIN_BATCH, seed=3)
        b = data.batch(0)

        def loss_grads(m, where):
            m = copy.deepcopy(m).to(where).requires_grad_(True)
            loss, metrics, grads = _accumulate_grads(
                rcfg, TrainConfig(), m, {k: torch.as_tensor(v, device=where) for k, v in b.items()})
            return float(loss), {k: float(v) for k, v in metrics.items()}, parts(grads)

        (loss, metrics, grads), _ = drive(path, needed, lambda: loss_grads(cpu_model, dev))
        want_loss, want_metrics, want_grads = loss_grads(cpu_model, "cpu")
        err = max(float((g.cpu() - w).abs().max()) / (float(w.abs().max()) + 1e-30)
                  for g, w in zip(grads, want_grads))
        verdict(path, f"train_loss {loss:.6f} (CPU {want_loss:.6f}) and every gradient against "
                f"the CPU's: max |diff| / max |CPU| per leaf {err:.3e} (tol {TRAIN_TOL})",
                abs(loss - want_loss) <= TRAIN_TOL * abs(want_loss) and err <= TRAIN_TOL
                and all(abs(metrics[k] - want_metrics[k]) <= TRAIN_TOL * max(1, abs(
                    want_metrics[k])) for k in want_metrics))
        del grads, want_grads

        for compress in (False, True):
            tc = TrainConfig(microbatch=2, warmup_steps=1, total_steps=6, compress_grads=compress,
                             adamw=AdamWConfig(lr=1e-3))

            def two_steps(where):
                m = copy.deepcopy(cpu_model).to(where)
                leaves = param_leaves(m)
                st = {"params": m, "opt": adamw_init(leaves, tc.adamw)}
                if compress:
                    st["eff"] = init_error_feedback(leaves)
                step = make_train_step(rcfg, tc, device=where)
                out = []
                for i in range(2):  # the first step's learning rate is 0
                    st, mt = step(st, data.batch(i))
                    out.append({k: float(v) for k, v in mt.items()})
                return out, [t.detach().cpu() for t in parts(param_leaves(m))]

            (got_m, got_p), _ = drive(f"{path} make_train_step compress={compress}", needed,
                                      lambda: two_steps(dev))
            want_m, want_p = two_steps("cpu")
            diff = torch.cat([(a - w).abs().flatten() for a, w in zip(got_p, want_p)])
            metrics_ok = all(abs(g[k] - w[k]) <= TRAIN_TOL * max(1.0, abs(w[k]))
                             for g, w in zip(got_m, want_m) for k in w)
            if compress:  # a gradient code may round the other way: ~2 lr moves
                params_ok = (float((diff > TRAIN_TOL).float().mean()) <= 1e-3
                             and float(diff.max()) <= 4 * tc.adamw.lr)
            else:
                params_ok = float(diff.max()) <= TRAIN_TOL
            verdict(path, f"two make_train_step steps (microbatches of 2, compress_grads="
                    f"{compress}) against the CPU's: losses {[round(m['loss'], 6) for m in got_m]}"
                    f", parameters max |diff| {float(diff.max()):.3e}, "
                    f"{int((diff > TRAIN_TOL).sum())} of {diff.numel()} beyond {TRAIN_TOL}",
                    metrics_ok and params_ok)

        # two runs from one seed, and a restart, bit for bit (float32, with the
        # int8 moments and compression on the MoE)
        moe = rcfg.family == "moe"
        tc = TrainConfig(microbatch=2, warmup_steps=2, total_steps=6, compress_grads=moe,
                         adamw=AdamWConfig(lr=1e-3, m_dtype="int8" if moe else "float32"))

        def fresh(ckpt=None):
            t = Trainer(rcfg, tc, ckpt_dir=ckpt, seed=0, device=dev)
            t.init_state()
            t.state["params"].float()  # float32 in place: the leaves stay the same objects
            leaves = param_leaves(t.state["params"])
            t.state["opt"] = adamw_init(leaves, tc.adamw)
            if moe:
                t.state["eff"] = init_error_feedback(leaves)
            return t

        def flat_state(t):
            return [x.detach().cpu() for x in pytree.tree_leaves(t._tree())]

        def runs():
            a, b_ = fresh(), fresh()
            quiet_run(a, iter(data), 6)
            quiet_run(b_, iter(data), 6)
            with tempfile.TemporaryDirectory() as ck:
                c = fresh(ck)
                quiet_run(c, iter(data), 3)
                del c
                d = fresh(ck)
                restored = d.maybe_restore()
                it = iter(data)
                for _ in range(d.step_num):
                    next(it)
                quiet_run(d, it, 3)
            return flat_state(a), flat_state(b_), flat_state(d), restored, d.step_num

        (sa, sb, sd, restored, steps), _ = drive(f"{path} Trainer", needed, runs)
        verdict(path, f"two Trainer runs of 6 steps from seed 0 bitwise equal ({len(sa)} tensors: "
                "parameters, moments" + (", error feedback" if moe else "") + ", counter)",
                all(torch.equal(x, y) for x, y in zip(sa, sb)))
        verdict(path, "3 steps, a checkpoint, a restore in a fresh Trainer and 3 more bitwise "
                "equal to 6 straight", restored and steps == 6
                and all(torch.equal(x, y) for x, y in zip(sa, sd)))
        del cpu_model
    torch.cuda.empty_cache()
    print(f"train: {time.time() - t_train:.1f} s for the training checks, times and profile",
          flush=True)


def _ep_layer(torch, dev):
    """deepseek-moe-16b's MoE layer at published width in float32 and its
    8 x 1024 tokens, from seed 0 on ``dev`` (every rank makes the same)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe

    cfg = get_config(TRAIN_ARCH)
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_moe(gen, cfg.d_model, num_experts=m.num_experts, d_ff_expert=m.d_ff_expert,
                 top_k=m.top_k, num_shared=m.num_shared, d_ff_shared=m.d_ff_shared,
                 dtype=torch.float32, device=dev)
    x = torch.randn((*EP_TOKENS, cfg.d_model), generator=gen, device=dev)
    return p, x, m


def _ep_place(torch, p, x, mesh):
    """The layer's parameters as DTensors over ``mesh`` (the experts' E over
    ``model``, the rest replicated) and the tokens replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tp = mesh.size(1)
    j = mesh.get_local_rank(1)
    for name, t in list(p.named_parameters()):
        *owner, attr = name.split(".")
        if ".experts." in f".{name}.":
            dt = DTensor.from_local(t.detach().chunk(tp)[j].contiguous(), mesh,
                                    [Replicate(), Shard(0)])
        else:
            dt = DTensor.from_local(t.detach(), mesh, [Replicate(), Replicate()])
        setattr(p.get_submodule(".".join(owner)), attr, torch.nn.Parameter(dt))
    return DTensor.from_local(x, mesh, [Replicate(), Replicate()])


def _ep_run(torch, p, x, m, mesh=None):
    """One forward of ``moe_ffn`` and the backward of sum(y^2): (y, aux, the
    dispatches K6 made as (ids, nb, tile, dest, offsets)); expert parallel
    over ``mesh`` when one is given."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import ambient_mesh
    from repro_torch.models.policy import compute_policy

    seen = []
    plain = moe_mod._stable_dest

    def recording(ids, nb, tile):
        dest, off = plain(ids, nb, tile)
        seen.append((ids.clone(), nb, tile, dest.clone(), off.clone()))
        return dest, off

    for t in p.parameters():
        t.requires_grad_(True)
        t.grad = None
    moe_mod._stable_dest = recording
    try:
        with contextlib.ExitStack() as ctx:
            if mesh is not None:
                ctx.enter_context(ambient_mesh(mesh))
                ctx.enter_context(implicit_replication())
                ctx.enter_context(compute_policy(explicit_ep=True))
            y, aux = moe_mod.moe_ffn(p, x, num_experts=m.num_experts, top_k=m.top_k,
                                     capacity_factor=m.capacity_factor)
            (y * y).sum().backward()
    finally:
        moe_mod._stable_dest = plain
    return y, aux, seen


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _ep_rank(rank: int, tmp: str, q) -> None:
    """One of the four gloo ranks of ``path ep``: the baseline on this rank,
    then the expert-parallel column on the (1, 4) mesh; returns the
    differences and the checks, not the tensors."""
    try:
        import torch
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh

        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch import kernels
        from repro_torch.models import moe as moe_mod

        tdist.init_process_group("gloo", init_method=f"file://{tmp}/ep_rdv", rank=rank,
                                 world_size=EP_WORLD)
        dev = torch.device(EP_DEVICE, 0)
        mesh = init_device_mesh(EP_DEVICE, (1, EP_WORLD), mesh_dim_names=("data", "model"))
        p, x, m = _ep_layer(torch, dev)
        y0, aux0, seen0 = _ep_run(torch, p, x, m)
        g0 = {k: t.grad.detach().clone() for k, t in p.named_parameters()}
        base_counts = (seen0[0][4][:, 1:] - seen0[0][4][:, :-1])[0]
        e_loc = m.num_experts // EP_WORLD
        xd = _ep_place(torch, p, x, mesh)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        y1, aux1, seen1 = _ep_run(torch, p, xd, m, mesh)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["dispatch_ranks"]
        atol, rtol = EP_TOL

        def excess(got, want):  # > 0 where |got - want| > atol + rtol |want|
            return float(((got - want).abs() - atol - rtol * want.abs()).max())

        res = {"y": excess(_whole(y1).detach(), y0.detach()),
               "y_max_diff": float((_whole(y1).detach() - y0.detach()).abs().max()),
               "dropped": (int(_whole(aux1["dropped"])), int(aux0["dropped"])),
               "max_load": (int(_whole(aux1["max_load"])), int(aux0["max_load"])),
               "launches": launches, "dispatches": len(seen1)}
        for k, t in p.named_parameters():
            if ".experts." in f".{k}.":  # this rank's experts: the reference's own bound
                res["grad " + k] = excess(t.grad.to_local(), g0[k].chunk(EP_WORLD)[rank])
            else:  # sums over every token, added in another order: to the leaf's largest
                got, want = _whole(t.grad), g0[k]
                res["leaf " + k] = float((got - want).abs().max() / want.abs().max())
        ids, nb, tile, dest, off = seen1[0]
        want_dest, want_off = moe_mod._stable_dest(ids.cpu(), nb, tile)
        res["dest_equal"] = torch.equal(dest.cpu(), want_dest) and torch.equal(off.cpu(),
                                                                               want_off)
        counts = (off[:, 1:] - off[:, :-1])[0][:e_loc]
        res["counts_equal"] = torch.equal(counts.cpu(),
                                          base_counts[rank * e_loc:(rank + 1) * e_loc].cpu())
        q.put((rank, res))
        tdist.destroy_process_group()
    except BaseException:
        import traceback

        q.put((rank, {"__error__": traceback.format_exc()}))


_DRYRUN_CHILD = r"""
import dataclasses, json, os, sys, time
sys.path.insert(0, sys.argv[1])
out_dir, cells, arch, layers, seq, batch, micro = sys.argv[2:9]
from repro_torch.launch import dryrun, report
t0 = time.time()
rcs = [dryrun.main(["--arch", a, "--shape", s, "--out", out_dir] + list(extra))
       for a, s, extra in json.loads(cells)]
t_cells = time.time() - t0
print("TABLE")
print(report.table(report.load(out_dir)))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.registry import Shape
from repro_torch.launch.mesh import fake_group
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.launch.shardings import ShardingStrategy
from repro_torch.train.trainer import TrainConfig
cfg = dataclasses.replace(get_config(arch), num_layers=int(layers))
shape = Shape("smoke_train", int(seq), int(batch), "train")
strat, tcfg = ShardingStrategy(), TrainConfig(microbatch=int(micro))
t0 = time.time()
with fake_group(1):
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cost, raw, peak, trips = dryrun.trace_cost("train", cfg, shape, mesh, strat, tcfg, "cuda",
                                               steps=int(batch) // int(micro))
    args = dryrun.argument_bytes(cfg, shape, mesh, strat, tcfg)
cost.bytes_min += args
rep = roofline_terms(arch=arch, shape=shape.name, mesh_name="1x1", chips=1, cost=cost,
                     model_fl=model_flops(cfg, shape), axis_bw={}, peak_mem=args + peak,
                     note=f"trips {json.dumps(trips)}", raw=raw)
print("ROOFLINE " + rep.to_json())
print("RESULT " + json.dumps({"rcs": rcs, "t_cells": t_cells, "t_step_trace": time.time() - t0}))
"""


def launch_phases(torch, dev, rows) -> None:
    """Phases 3 and 4 of the launch tooling (last, after the distributed
    sort).  ``path ep deepseek-moe-16b``: the expert-parallel MoE column
    (``compute_policy(explicit_ep=True)`` under a ``DeviceMesh``) on one MoE
    layer at published width in float32 over 8 x 1024 tokens: on a (1, 1)
    NCCL mesh its output, ``dropped`` and counts bit for bit the baseline
    ``moe_ffn``'s; on four gloo ranks on the card (a (1, 4) mesh, 16 experts
    a rank) its output and expert gradients within EP_TOL of the
    baseline's, the router's and shared experts' gradients within EP_TOL's
    rtol of each leaf's largest, ``dropped``, ``max_load`` and counts exact,
    K6 launched once a rank a
    call with ``dest`` bit for bit the plain one.  ``path train sharded``:
    ``make_train_step`` over the (1, 1) NCCL mesh (DTensor parameters and
    moments) for reduced deepseek-moe-16b and yi-9b in float32, two steps
    bit for bit those without a mesh; then the full-width training case
    (4 of deepseek-moe-16b's 28 layers, 4 x 4096 tokens in microbatches of
    2) through ``Trainer`` over that mesh with ``explicit_ep``, its step
    time and peak memory beside the unsharded step's in this run.  ``path
    dryrun`` (a child process from the start, on the host's CPU: the fake
    process group is global to its process): ``launch.dryrun`` on
    DRYRUN_CELLS, no row an error, and ``launch.report``'s table.  ``time roofline``: the counter's modelled
    row of the full-width one-card step beside the measured step."""
    import copy
    import dataclasses
    import itertools
    import math

    import torch.distributed as tdist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.registry import Shape
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.shardings import distribute_model
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import init_model, param_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig, Trainer, make_train_step

    t_launch = time.time()
    f32 = torch.float32
    verdict = _verdict

    def drive(path, needed, fn):
        res, launches, _ = _drive(torch, rows, path, needed, fn)
        return res, launches

    def parts(leaves):
        return [t for v in leaves.values() for t in (v if isinstance(v, tuple) else (v,))]

    # path dryrun runs on the host's CPU in a child from the start (the fake
    # group is global to its process); its result is read at the end
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    logs = tempfile.mkdtemp(prefix="chip_smoke_dryrun_logs_")
    # files, not pipes: a full pipe would stall the child until it is read
    child_out = open(os.path.join(logs, "out"), "w+")
    child_err = open(os.path.join(logs, "err"), "w+")
    child = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, str(ROOT / "src"), out_dir,
         json.dumps(DRYRUN_CELLS), TRAIN_ARCH, str(TRAIN_LAYERS), str(TRAIN_SEQ),
         str(TRAIN_BATCH), str(TRAIN_MICRO)], stdout=child_out, stderr=child_err, text=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    tdist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))

    # ---- path ep on the (1, 1) mesh ---------------------------------------------
    p, x, m = _ep_layer(torch, dev)
    y0, aux0, seen0 = _ep_run(torch, p, x, m)
    g0 = {k: t.grad.detach().clone() for k, t in p.named_parameters()}
    path = (f"ep {TRAIN_ARCH} (1, 1) NCCL mesh: one MoE layer at published width, float32, "
            f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens")
    xd = _ep_place(torch, p, x, mesh)
    (y1, aux1, seen1), launches = drive(path, ["dispatch_ranks"],
                                        lambda: _ep_run(torch, p, xd, m, mesh))
    counts0 = (seen0[0][4][:, 1:] - seen0[0][4][:, :-1])[0]
    counts1 = (seen1[0][4][:, 1:] - seen1[0][4][:, :-1])[0][:m.num_experts]
    verdict(path, f"output bit for bit the baseline moe_ffn's, dropped "
            f"{int(_whole(aux1['dropped']))} == {int(aux0['dropped'])}, counts equal, one K6 launch "
            f"({launches['dispatch_ranks']})",
            torch.equal(_whole(y1).detach(), y0.detach())
            and int(_whole(aux1["dropped"])) == int(aux0["dropped"])
            and torch.equal(counts1, counts0) and launches["dispatch_ranks"] == 1)
    gdiff = max(float((_whole(t.grad) - g0[k]).abs().max()) for k, t in p.named_parameters())
    print(f"path {path}: gradients max |diff| against the baseline's {gdiff:.3e}", flush=True)
    del p, x, xd, y0, y1, g0, seen0, seen1
    torch.cuda.empty_cache()

    # ---- path train sharded: reduced models bit for bit ---------------------------
    for arch in TRAIN_REDUCED:
        rcfg = get_reduced(arch)
        needed = ["dispatch_ranks"] if rcfg.family == "moe" else []
        path = f"train sharded reduced {arch} (float32, (1, 1) NCCL mesh)"
        data = SyntheticLM(rcfg.vocab_size, TRAIN_REDUCED_SEQ, TRAIN_BATCH, seed=3)
        tc = TrainConfig(microbatch=2, warmup_steps=1, total_steps=6,
                         adamw=AdamWConfig(lr=1e-3))
        base = init_model(torch.Generator(device=dev).manual_seed(5), rcfg, dtype=f32,
                          device=dev)

        def two_steps(over):
            mdl = copy.deepcopy(base)
            if over is None:
                step = make_train_step(rcfg, tc, device=dev)
            else:
                step, _, _ = make_train_step(rcfg, tc, over)
                distribute_model(mdl, rcfg, over)
            mdl.requires_grad_(True)
            st = {"params": mdl, "opt": adamw_init(param_leaves(mdl), tc.adamw)}
            out = []
            for i in range(2):
                st, mt = step(st, data.batch(i))
                out.append({k: float(_whole(v)) for k, v in mt.items()})
            return out, [_whole(t).detach().clone() for t in parts(param_leaves(mdl))]

        (got_m, got_p), _ = drive(path, needed, lambda: two_steps(mesh))
        want_m, want_p = two_steps(None)
        verdict(path, f"two make_train_step steps over the mesh bit for bit those without "
                f"(losses {[m_['loss'] for m_ in got_m]})",
                got_m == want_m and all(torch.equal(a, b) for a, b in zip(got_p, want_p)))
        del base, got_p, want_p
    torch.cuda.empty_cache()

    # ---- path train sharded: the full-width case, and its times -----------------
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(microbatch=TRAIN_MICRO)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch(0)

    def timed(trainer):
        run = lambda n: trainer.run(itertools.repeat(batch), n, ckpt_every=10 ** 9,  # noqa: E731
                                    log_every=10 ** 9, log=lambda *_: None)
        first_loss = run(1)["loss"]
        torch.cuda.reset_peak_memory_stats()
        k = len(trainer.step_times)
        run(SHARDED_STEPS)
        return (first_loss, 1e3 * statistics.median(trainer.step_times[k:]),
                torch.cuda.max_memory_allocated())

    trainer = Trainer(cfg, tcfg, seed=0, device=dev)
    trainer.init_state()
    loss0, ms0, peak0 = timed(trainer)
    del trainer
    torch.cuda.empty_cache()
    path = (f"train sharded {TRAIN_ARCH} ({TRAIN_LAYERS} layers, bf16, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens in microbatches of {TRAIN_MICRO}, (1, 1) NCCL mesh, explicit_ep)")
    with compute_policy(explicit_ep=True):
        trainer = Trainer(cfg, tcfg, mesh=mesh, seed=0)
        trainer.init_state()
        (loss1, ms1, peak1), launches = drive(path, ["dispatch_ranks"], lambda: timed(trainer))
    per_step = TRAIN_LAYERS * (TRAIN_BATCH // TRAIN_MICRO) * 2
    verdict(path, f"first loss {loss1:.6f} finite and equal to the unsharded step's "
            f"{loss0:.6f}", math.isfinite(loss1) and abs(loss1 - loss0) <= 1e-6 * abs(loss0))
    verdict(path, f"K6 dispatch_ranks launched {launches['dispatch_ranks']} times = {per_step} "
            f"a step x {SHARDED_STEPS + 1} steps",
            launches["dispatch_ranks"] == per_step * (SHARDED_STEPS + 1))
    print(f"time train sharded {TRAIN_ARCH}: step {ms1:.3f} ms over the (1, 1) mesh with "
          f"explicit_ep, {ms0:.3f} ms unsharded (medians of {SHARDED_STEPS} steps after one, "
          f"host clock); their difference {ms1 - ms0:.3f} ms a step (not profiled); peak "
          f"memory {peak1} B "
          f"sharded, {peak0} B unsharded", flush=True)
    del trainer
    torch.cuda.empty_cache()
    tdist.destroy_process_group()

    # ---- path ep on four gloo ranks ------------------------------------------------
    t0 = time.time()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_ep_rank, args=(r, tmp, q)) for r in range(EP_WORLD)]
    for pr in procs:
        pr.start()
    got = {}
    try:
        for _ in procs:
            r, res = q.get(timeout=600)
            if "__error__" in res:
                fail(f"path ep rank {r}:\n{res['__error__']}")
            got[r] = res
    except queue.Empty:
        fail("path ep: the ranks gave no result within 600 s")
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    path = (f"ep {TRAIN_ARCH} four gloo ranks on the card ((1, {EP_WORLD}) mesh, "
            f"{64 // EP_WORLD} experts a rank)")
    print(f"path {path}: {time.time() - t0:.1f} s; rank 0 {got[0]}", flush=True)
    rows["dispatch_ranks"]["launches"] += sum(g["launches"] for g in got.values())
    excess = max(v for g in got.values() for k, v in g.items()
                 if k == "y" or k.startswith("grad "))
    verdict(path, f"output and expert gradients within {EP_TOL[0]} + {EP_TOL[1]} |baseline| "
            f"(largest excess {excess:.3e}; output max |diff| "
            f"{max(g['y_max_diff'] for g in got.values()):.3e})", excess <= 0)
    leaf = max(v for g in got.values() for k, v in g.items() if k.startswith("leaf "))
    verdict(path, f"router and shared-expert gradients within {EP_TOL[1]} of each leaf's "
            f"largest ({leaf:.3e}; each a sum over every token, added in another order)",
            leaf <= EP_TOL[1])
    verdict(path, "dropped and max_load equal to the baseline's, counts exact",
            all(g["dropped"][0] == g["dropped"][1] and g["max_load"][0] == g["max_load"][1]
                and g["counts_equal"] for g in got.values()))
    verdict(path, "K6 launched once a rank a call, dest bit for bit the plain one",
            all(g["launches"] == 1 and g["dispatches"] == 1 and g["dest_equal"]
                for g in got.values()))

    child.wait(timeout=900)
    out, err = (open(f.name).read() for f in (child_out, child_err))
    child_out.close()
    child_err.close()
    if child.returncode != 0:
        fail(f"path dryrun: the child exited {child.returncode}:\n{err[-4000:]}")
    res = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
    roof = json.loads([ln for ln in out.splitlines() if ln.startswith("ROOFLINE ")][-1][9:])
    table = out.split("TABLE\n", 1)[1].split("ROOFLINE ", 1)[0].rstrip()
    print(table, flush=True)
    statuses = [json.load(open(os.path.join(out_dir, f)))["status"]
                for f in sorted(os.listdir(out_dir))]
    print(f"path dryrun: {len(statuses)} rows in {res['t_cells']:.1f} s of the host's time",
          flush=True)
    verdict("dryrun", f"no row an error ({statuses}), every run exited 0 ({res['rcs']})",
            "error" not in statuses and all(rc == 0 for rc in res["rcs"])
            and len(statuses) == len(DRYRUN_CELLS))
    shape = Shape("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mf = model_flops(cfg, shape)
    for label, ms in (("this run's unsharded step", ms0),):
        print(f"time roofline {TRAIN_ARCH} ({TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ}): "
              f"{label} {ms:.3f} ms; model_flops {mf:.6e} -> model_flops / (step s x peak) "
              f"{mf / (ms / 1e3 * HW['peak_flops']):.6f}; modelled t_compute "
              f"{1e3 * roof['t_compute']:.3f} ms, t_memory {1e3 * roof['t_memory']:.3f} ms, "
              f"t_memory_min {1e3 * roof['t_memory_min']:.3f} ms (counted flops "
              f"{roof['flops_per_dev']:.6e}, bytes {roof['bytes_per_dev']:.6e}, useful "
              f"{roof['useful_ratio']:.4f}); measured / max(modelled) "
              f"{ms / 1e3 / max(roof['t_compute'], roof['t_memory_min']):.3f}", flush=True)
    print(f"launch: {time.time() - t_launch:.1f} s for the launch tooling's checks and times",
          flush=True)


def compare_with_parent(parent: Path) -> None:
    """``--parent DIR``: K1 (tree, radix, batched; 32- and 64-bit keys), K3,
    K5 and K7 of the CUDA sources under DIR (a checkout of an earlier commit,
    unpacked by ``git archive``) beside this tree's, through this tree's
    wrappers, on the same inputs and card, in turns (earlier, this, this,
    earlier): CUDA events around the wrapper's launch and the kernel's own
    device time (torch.profiler), and whether both give the same outputs.
    K1 at phase 4's shapes (n = 2^24, k = 128, tile 4096; (64, 2^18) for
    K4; float64 Uniform and int64 full-range codes for the 64-bit forms),
    K3 on 2048 duplicate-heavy windows of 8192 int32 keys, its 64-bit form
    on 2^24 duplicate-heavy int64 keys in windows of every W from 16 to
    16384 (2048 of 8192 and 1024 of 16384 among them), K5 on two
    duplicate-heavy runs of 2^24, K7 in tree mode on 2^24 uint8, float16,
    float32 and float64 keys and on 2^24 equal float32 keys at k = 128,
    batched on (64, 2^18) float32 and float64, in radix mode on 2^24 int32
    and int64 codes at k = 256 (the default tiles).  The C entry points of
    the five kept their signatures."""
    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import ops
    from repro_torch.core import sampling
    from repro_torch.data.distributions import make_input
    from repro_torch.kernels import _build, bitonic, classify as cl, level_fused as lf
    from repro_torch.kernels import merge_path as mp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out_dir = ROOT / "build" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for stem, sigs in (("level_fused", lf._SIGNATURES), ("merge_path", mp._SIGNATURES),
                       ("bitonic", bitonic._SIGNATURES), ("classify", cl._SIGNATURES)):
        so = out_dir / f"lib{stem}.so"
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                str(parent / "src" / "repro_torch" / "csrc" / f"{stem}.cu")],
                               capture_output=True, text=True)
        if built.returncode:
            fail(f"the earlier {stem}.cu does not build: {built.stdout[-2000:]}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in sigs.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = list(argtypes)
                getattr(lib, name).restype = ctypes.c_int
        getattr(lib, f"{stem}_error_string").restype = ctypes.c_char_p
        libs[stem] = {"parent": lib, "this": _build.library(stem, sigs)}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    k = 128
    keys = ops.keyspace.encode(torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=1),
                                               device=dev))
    spl = sampling.select_splitters(torch.sort(keys[torch.randint(
        0, N_BIG, (4 * k,), generator=gen, device=dev)]).values, k)
    rng = np.random.default_rng(9)
    radix_int = torch.as_tensor(rng.integers(-2**31, 2**31, N_BIG, dtype=np.int64)
                                .astype(np.int32), device=dev)
    kb = keys.view(B_BULK, N_ROW)
    pos = torch.randint(0, N_ROW, (B_BULK, 4 * k), generator=gen, device=dev)
    spl_b = sampling.select_splitters(torch.sort(torch.gather(kb, 1, pos), dim=1).values, k)
    keys64 = ops.keyspace.encode(torch.as_tensor(make_input("Uniform", N_BIG, np.float64, seed=1),
                                                 device=dev))
    spl64 = sampling.select_splitters(torch.sort(keys64[torch.randint(
        0, N_BIG, (4 * k,), generator=gen, device=dev)]).values, k)
    radix64 = torch.as_tensor(rng.integers(-2**63, 2**63 - 1, N_BIG, dtype=np.int64), device=dev)
    kb64 = keys64.view(B_BULK, N_ROW)
    spl_b64 = sampling.select_splitters(torch.sort(torch.gather(kb64, 1, pos), dim=1).values, k)

    def run(n, lo, hi):
        x = torch.sort(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                     dtype=torch.int32)).values
        x[-(n // 1000):] = torch.iinfo(torch.int32).max
        return x

    merge_a, merge_b = run(N_BIG, -1000, 1000), run(N_BIG, -1000, 1000)
    wb = torch.sort(torch.randint(0, 64, (2048, 8192), generator=gen, device=dev,
                                  dtype=torch.int32), dim=1).values
    wk = torch.randint(-3, 4, (2048, 8192), generator=gen, device=dev, dtype=torch.int32)
    wide = {}
    for log2w in range(4, bitonic.MAX_W.bit_length()):
        W = 1 << log2w
        wb64 = torch.sort(torch.randint(0, 64, (N_BIG // W, W), generator=gen, device=dev,
                                        dtype=torch.int32), dim=1).values
        wk64 = torch.randint(-3, 4, (N_BIG // W, W), generator=gen, device=dev,
                             dtype=torch.int64)
        wk64[: N_BIG // W // 3] += torch.iinfo(torch.int64).max - 3
        wide[f"sort_windows64 {N_BIG // W} x {W}"] = (
            "bitonic", lambda wb64=wb64, wk64=wk64: bitonic.sort_windows(wb64, wk64, nb=64))
    # K7 at phase 4's shapes: raw keys of 8, 16, 32 and 64 bits at k = 128
    # (NaN, +-0.0, +-inf and the max among the floats), (64, 2^18) rows of 32
    # and 64 bits, radix codes at k = 256, and all-equal float32 keys
    def k7_keys(x):
        if x.dtype.is_floating_point:
            x[::1009] = float("nan")
            x[1::1013] = -0.0
            x[2::1019] = float("inf")
            x[3::1021] = torch.finfo(x.dtype).max
        return x

    def k7_spl(x):
        pos = torch.randint(0, x.shape[-1], x.shape[:-1] + (4 * k,), generator=gen, device=dev)
        sample = torch.sort(torch.gather(x, -1, pos), dim=-1).values
        return sampling.select_splitters(sample, k).contiguous()

    k7 = {"classify_histogram8 uint8": torch.randint(0, 256, (N_BIG,), generator=gen, device=dev,
                                                      dtype=torch.uint8),
          "classify_histogram16 float16": k7_keys(torch.randn(N_BIG, generator=gen, device=dev)
                                                  .to(torch.float16)),
          "classify_histogram float32": k7_keys(torch.randn(N_BIG, generator=gen, device=dev)),
          "classify_histogram64 float64": k7_keys(torch.randn(N_BIG, generator=gen, device=dev,
                                                              dtype=torch.float64)),
          "classify_histogram float32 all equal": torch.full((N_BIG,), 0.25, device=dev)}
    k7_rows = {"classify_histogram_batched float32": k7_keys(torch.randn(
                   (B_BULK, N_ROW), generator=gen, device=dev)),
               "classify_histogram_batched64 float64": k7_keys(torch.randn(
                   (B_BULK, N_ROW), generator=gen, device=dev, dtype=torch.float64))}
    k7_calls = {name: ("classify", lambda x=x, s_=k7_spl(x): cl.classify_histogram(x, s_, k=k))
                for name, x in k7.items()}
    k7_calls.update({name: ("classify", lambda x=x, s_=k7_spl(x): cl.classify_histogram_batched(
        x, s_, k=k)) for name, x in k7_rows.items()})
    k7_calls["radix_histogram int32"] = ("classify", lambda: cl.radix_histogram(
        radix_int, k=K_RADIX))
    k7_calls["radix_histogram64 int64"] = ("classify", lambda: cl.radix_histogram(
        radix64, k=K_RADIX))
    cases = {
        "level_fused": ("level_fused", lambda: lf._level_tiles_kernel(
            keys[None], spl[None], k, N_BIG, lf.TILE)),
        "level_fused_radix": ("level_fused", lambda: lf._level_tiles_kernel(
            radix_int[None], None, k, N_BIG, lf.TILE)),
        "level_fused_batched": ("level_fused", lambda: lf._level_tiles_kernel(
            kb, spl_b, k, N_ROW, lf.TILE, batched=True)),
        "level_fused64": ("level_fused", lambda: lf._level_tiles_kernel(
            keys64[None], spl64[None], k, N_BIG, lf.TILE)),
        "level_fused_radix64": ("level_fused", lambda: lf._level_tiles_kernel(
            radix64[None], None, k, N_BIG, lf.TILE)),
        "level_fused_batched64": ("level_fused", lambda: lf._level_tiles_kernel(
            kb64, spl_b64, k, N_ROW, lf.TILE, batched=True)),
        "merge_path": ("merge_path", lambda: mp.merge_path_perm(merge_a, merge_b)),
        "sort_windows": ("bitonic", lambda: bitonic.sort_windows(wb, wk, nb=64)),
        **wide,
        **k7_calls,
    }
    result = {}
    for name, (stem, call) in cases.items():
        times = {"parent": [], "this": []}
        outs = {}
        for side in ("parent", "this", "this", "parent"):
            _build._LIBS[stem] = libs[stem][side]
            outs[side] = call()
            times[side].append((cuda_ms(torch, call), device_ms(
                torch, call, names=DEVICE_FUNCTIONS[name.split()[0]])))
        _build._LIBS[stem] = libs[stem]["this"]
        got, want = outs["this"], outs["parent"]
        same = all(torch.equal(g, w) for g, w in zip(got, want)) if isinstance(got, tuple) \
            else torch.equal(got, want)
        result[name] = {side: {"ms": [t[0] for t in ts], "device_ms": [t[1] for t in ts]}
                        for side, ts in times.items()}
        result[name]["same_outputs"] = same
        print(f"before/after {name}: " + "; ".join(
            f"{side} events {' '.join(f'{t[0]:.4f}' for t in ts)} ms, device "
            f"{' '.join(f'{t[1]:.4f}' for t in ts)} ms" for side, ts in times.items())
              + f"; same outputs: {same}", flush=True)
        if not same:
            fail(f"{name}: this tree's kernel and the earlier one differ")
    result.update(compare_entry_points_with_parent(torch, parent, keys, dev))
    print(json.dumps({"before_after": result}))


# The entry points of K2, K4 rank_hist_batched and K6 (``entry_calls``,
# through whichever tree's ``repro_torch`` is imported) on the inputs saved
# by compare_entry_points_with_parent.
def entry_calls(torch, x):
    from repro_torch.kernels import dispatch_rank as dr, level_fused as lf

    return {
        "rank_hist": lambda: lf.rank_hist(x["comp"], nb=x["nb"], seg_offsets=x["off"],
                                          seg_width=x["width"], tile=x["tile"]),
        "rank_hist_batched": lambda: lf.rank_hist_batched(
            x["comp_b"], nb=x["nb_b"], seg_offsets=x["off_b"], seg_width=x["width_b"],
            tile=x["tile_b"]),
        "dispatch_ranks": lambda: dr.dispatch_ranks(x["moe"], x["moe_start"],
                                                    num_experts=MOE_EXPERTS),
        "dispatch_ranks skewed": lambda: dr.dispatch_ranks(x["skew"], x["skew_start"],
                                                           num_experts=MOE_EXPERTS),
        "partition_ranks": lambda: dr.partition_ranks(x["part"], x["part_start"], nb=NB_PART),
        "partition_ranks_batched": lambda: dr.partition_ranks_batched(
            x["rows"], x["rows_start"], nb=NB_PART),
        # the sort's entry points, whose glue G1-G4 took over from torch chains
        **entry_point_calls(x),
    }


def entry_point_calls(x):
    """The seven entry points ``--parent`` times whole (through whichever
    tree's ``repro_torch`` is imported) on the inputs of ``entry_inputs``."""
    import torch

    from repro_torch import ops

    return {
        f"ops.sort {N_BIG} float32 tree": lambda: ops.sort(x["sort_x"]),
        f"ops.argsort {N_BIG} float32 tree": lambda: ops.argsort(x["sort_x"]),
        f"ops.sort {N_BIG} int32 full range radix": lambda: ops.sort(x["radix_x"],
                                                                     classifier="radix"),
        f"ops.sort {N_BIG} double": lambda: ops.sort(x["double_x"]),
        f"ops.batched_sort ({B_BULK}, {N_ROW}) float32": lambda: ops.batched_sort(x["bulk_x"]),
        f"ops.argsort_records SkySurvey ({N_BIG}, 3)": lambda: ops.argsort_records(
            x["sky"].view(torch.uint32)),
        f"ops.segmented_sort ({SEGMENTS} segments of {N_BIG})": lambda: ops.segmented_sort(
            x["sort_x"], x["seg_off"], SEGMENTS),
        # beyond the seven: the top-k, and the fallback's heaviest case (radix
        # on floats in [0, 1) leaves most keys in buckets over W/2)
        f"ops.topk {N_BIG} float32 k={STREAM_K}": lambda: ops.topk(x["sort_x"], STREAM_K),
        f"ops.sort {N_BIG} float32 [0, 1) radix": lambda: ops.sort(x["sort_x"],
                                                                  classifier="radix"),
    }


def entry_inputs(torch, dev) -> dict:
    """The entry points' inputs, made on the host from seeds: 2^24 float32
    Uniform, int32 over the whole range, float64 Uniform, (64, 2^18)
    float32 Uniform rows, 2^24 SkySurvey records (three words, as int32) and
    4096 ragged segments."""
    import numpy as np

    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.distributions import make_input

    rng = np.random.default_rng(31)
    cuts = np.sort(rng.integers(0, N_BIG, SEGMENTS - 1))
    return {
        "sort_x": torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=1), device=dev),
        "radix_x": torch.as_tensor(rng.integers(-2**31, 2**31, N_BIG, dtype=np.int64)
                                   .astype(np.int32), device=dev),
        "double_x": torch.as_tensor(make_input("Uniform", N_BIG, np.float64, seed=2),
                                    device=dev),
        "bulk_x": torch.as_tensor(make_input("Uniform", B_BULK * N_ROW, np.float32, seed=3)
                                  .reshape(B_BULK, N_ROW), device=dev),
        "sky": torch.from_numpy(make_dataset("SkySurvey", N_BIG, seed=62).words.view(
            np.int32)).to(dev),
        "seg_off": torch.as_tensor(np.concatenate([[0], cuts, [N_BIG]]).astype(np.int32),
                                   device=dev),
    }


G4_GROUPS = 1024  # G4's scatter: a planned span's buckets, fewer than this (kScatterGroups)


def g4_scatter_paths(torch, dev) -> None:
    """G4's scatter by path, on the scatters that ``ops.sort``,
    ``ops.batched_sort`` and ``ops.segmented_sort`` make of ``--parent``'s
    inputs (2^24 float32 Uniform, 64 rows of 2^18, 4096 ragged segments),
    the radix sort of the same floats in [0, 1) (most keys in a few
    buckets) and ``ops.sort`` of them sorted already: for each launch, its
    spans of ``glue.SCATTER_SPAN`` source rows as the kernel's plan splits
    them for 4-byte rows (planned, or row by row where a span covers
    G4_GROUPS buckets or more or, in a row of more offsets than that, its
    destinations lie within ``glue.ROW_WINDOW_BYTES`` / 4 of each other),
    the window of destinations, the offsets a planned span takes into
    shared memory, the buckets its rows fall in and the rows a bucket; then
    the device time of a 4-byte tensor's scatter by each launch's
    placement, with its offsets (as the level pass makes it) and without
    (every span row by row), beside its byte bound."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.data.distributions import make_input
    from repro_torch.kernels import glue

    x = torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=1), device=dev)
    x_sorted = torch.sort(x).values
    bulk_x = torch.as_tensor(make_input("Uniform", B_BULK * N_ROW, np.float32, seed=3)
                             .reshape(B_BULK, N_ROW), device=dev)  # entry_inputs' too
    cuts = np.sort(np.random.default_rng(31).integers(0, N_BIG, SEGMENTS - 1))  # entry_inputs'
    seg_off = torch.as_tensor(np.concatenate([[0], cuts, [N_BIG]]).astype(np.int32), device=dev)
    seen, real = [], glue.scatter_rows

    def capture(arrays, dest, offsets=None):
        seen.append((dest.clone(), None if offsets is None else offsets.clone()))
        return real(arrays, dest, offsets)

    glue.scatter_rows = capture
    try:
        labels = []
        for call, fn in (("ops.sort", lambda: ops.sort(x)),
                         ("ops.batched_sort", lambda: ops.batched_sort(bulk_x)),
                         ("ops.segmented_sort", lambda: ops.segmented_sort(x, seg_off, SEGMENTS)),
                         ("ops.sort radix [0, 1)", lambda: ops.sort(x, classifier="radix")),
                         ("ops.sort of sorted keys", lambda: ops.sort(x_sorted))):
            before = len(seen)
            fn()
            labels += [f"{call} scatter {i + 1} of {len(seen) - before}"
                       for i in range(len(seen) - before)]
    finally:
        glue.scatter_rows = real
    S = glue.SCATTER_SPAN
    for label, (dest, offsets) in zip(labels, seen):
        n = dest.shape[-1]
        d = dest.reshape(-1, n)
        off = offsets.reshape(d.shape[0], -1)
        m = off.shape[1]
        spans = -(-n // S)
        dv = torch.full((d.shape[0], spans * S), -1, dtype=torch.int32, device=dev)
        dv[:, :n] = d
        real_row = dv >= 0
        b = torch.searchsorted(off, dv.to(off.dtype), right=True) - 1  # each row's bucket
        dv, real_row, b = (t_.reshape(d.shape[0], spans, S) for t_ in (dv, real_row, b))
        lo = torch.where(real_row, dv, n).amin(-1)
        hi = dv.amax(-1)
        window = hi - lo + 1
        if m > G4_GROUPS:  # the offsets between the span's least and greatest destination
            searched = (torch.searchsorted(off, hi.to(off.dtype), right=True)
                        - torch.searchsorted(off, lo.to(off.dtype), right=True))
            wide = window > glue.ROW_WINDOW_BYTES // 4
        else:  # the row's offsets whole, no window taken
            searched = torch.full_like(lo, m - 1)
            wide = torch.ones_like(lo, dtype=torch.bool)
        planned = wide & (searched < G4_GROUPS) & ((dv < n) | ~real_row).all(-1)
        bs = torch.sort(torch.where(real_row, b, torch.iinfo(b.dtype).max), dim=-1).values
        buckets = ((bs[..., 1:] != bs[..., :-1]) & (bs[..., 1:] != torch.iinfo(b.dtype).max)
                   ).sum(-1) + 1  # the buckets a span's rows fall in
        rows_in = real_row.sum(-1)
        p_, r_ = planned.reshape(-1), ~planned.reshape(-1)
        share = rows_in.reshape(-1)[p_].sum().item() / max(1, rows_in.sum().item())

        def stats(t_, sel):
            t_ = t_.reshape(-1)[sel].double()
            return "none" if t_.numel() == 0 else (
                f"mean {t_.mean().item():.1f}, max {t_.max().item():.0f}")

        print(f"g4 path {label}: n {n}, m {m}, spans {spans * d.shape[0]}, planned "
              f"{int(p_.sum())} ({share:.1%} of the rows), row by row {int(r_.sum())} (by the "
              f"window {int((r_ & ~wide.reshape(-1)).sum())}); planned spans: window "
              f"{stats(window, p_)}, offsets staged {stats(searched, p_)}, buckets with rows "
              f"{stats(buckets, p_)}, rows a bucket "
              f"{stats(rows_in.double() / buckets.clamp(min=1), p_)}; row-by-row spans: window "
              f"{stats(window, r_)}, offsets between {stats(searched, r_)}, buckets with rows "
              f"{stats(buckets, r_)}, rows a bucket "
              f"{stats(rows_in.double() / buckets.clamp(min=1), r_)}",
              flush=True)
        keys = torch.randint(-2**31, 2**31 - 1, dest.shape, dtype=torch.int32, device=dev)
        want = glue.scatter_rows_plain({"k": keys}, dest)["k"]
        for how, off_ in (("with its offsets", offsets), ("row by row (no offsets)", None)):
            if not torch.equal(glue.scatter_rows({"k": keys}, dest, off_)["k"], want):
                fail(f"g4 path {label} {how}: the scatter differs from its plain twin")
            ms_ = device_ms(torch, lambda: glue.scatter_rows({"k": keys}, dest, off_),
                            names=DEVICE_FUNCTIONS["scatter_rows"])
            bound_ = bound_ms(dest.numel() * 12 + offsets.numel() * 4, 0)[0]
            print(f"time g4 path {label} {how}: device {ms_:.4f} ms, bound {bound_:.4f} ms "
                  f"({bound_ / ms_:.1%} of the bound's rate)", flush=True)
        del dv, b, bs, keys, want


def short_kernel(key: str) -> str:
    return key.replace("(anonymous namespace)::", "").split("(")[0]


# The earlier tree's entry points, in a child process with that tree's
# ``src`` first on its path: reads an entry point's name a line, answers
# with one JSON line of its timings and its device time per kernel; the
# first call of each saves its outputs.
PARENT_CHILD = r"""
import json, sys, torch
from pathlib import Path
root, parent_src, inputs = sys.argv[1:4]
sys.path[:0] = [parent_src, root]
import repro_torch  # the earlier tree's package: imported before chip_smoke puts this tree's first
assert Path(repro_torch.__file__).resolve().is_relative_to(Path(parent_src).resolve())
import chip_smoke as cs
dev = torch.device("cuda", 0)
x = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in torch.load(inputs).items()}
calls = cs.entry_calls(torch, x)
for line in sys.stdin:
    name = line.strip()
    out = calls[name]()
    out = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    torch.save(tuple(o.cpu() for o in out), str(Path(inputs).with_name(f"parent_{name}.pt")))
    launches, device, kernels = cs.call_kernels(torch, calls[name])
    print(json.dumps({"ms": cs.cuda_ms(torch, calls[name]), "device_ms": device,
                      "launches": launches, "syncs": cs.sync_calls(torch, calls[name]),
                      "peak": cs.peak_rise(torch, calls[name]),
                      "kernels": {cs.short_kernel(k): v for k, v in kernels.items()}}), flush=True)
"""


def compare_entry_points_with_parent(torch, parent: Path, keys, dev) -> dict:
    """``--parent DIR``, K2, K4 ``rank_hist_batched`` and K6: the earlier
    tree's entry points (kernels and any torch epilogue; their C signatures
    differ, so through its own wrappers, in a child process) beside this
    tree's, on the same inputs, in turns (earlier, this, this, earlier):
    CUDA events around the entry point, the device time of all kernels of
    one call and their launches (torch.profiler, copies and memsets apart),
    the earlier tree's device time per kernel, and whether the outputs are
    equal.  K2 and K4 on the composite ids of a real level 1 (2^24 keys;
    (64, 2^18) rows); K6 at phase 2's shapes: the MoE routing (uniform and
    half on one expert), 2^24 ids over 257 buckets with trash ids and
    non-prefix starts, (64, 2^18) rows."""
    from repro_torch.core import ips4o

    cfg = ips4o.SortConfig()
    x = {}
    for tag, rows_, n in (("", 1, N_BIG), ("_b", B_BULK, N_ROW)):
        levels = ips4o.plan_levels(n, cfg)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        if rows_ == 1:
            arrays, off, nb1, _ = ips4o.level_pass({"k": keys}, n, levels[0], cfg, gen)
            comp = ips4o.composite_ids(arrays["k"], off, nb1, n, levels[1], gen)
        else:
            arrays, off, nb1, _ = ips4o.batched_level_pass({"k": keys.view(rows_, n)}, n,
                                                           levels[0], cfg, gen)
            comp = ips4o.batched_composite_ids(arrays["k"], off, nb1, n, levels[1], gen)
        x.update({f"comp{tag}": comp, f"off{tag}": off, f"nb{tag}": nb1 * 2 * levels[1],
                  f"width{tag}": 2 * levels[1], f"tile{tag}": ips4o._auto_tile(
                      n, 2 * levels[1], cfg)})
    gen = torch.Generator(device=dev).manual_seed(21)

    def prefix(ids, nb):
        counts = torch.bincount(ids.reshape(-1), minlength=nb)[:nb].to(torch.int32)
        return torch.cumsum(counts, 0, dtype=torch.int32) - counts

    n_moe = MOE_TOKENS * MOE_TOP
    x["moe"] = torch.randint(0, MOE_EXPERTS, (n_moe,), generator=gen, device=dev,
                             dtype=torch.int32)
    x["skew"] = x["moe"].clone()
    x["skew"][torch.rand(n_moe, generator=gen, device=dev) < 0.5] = 7
    x["moe_start"], x["skew_start"] = prefix(x["moe"], MOE_EXPERTS), prefix(x["skew"],
                                                                            MOE_EXPERTS)
    x["part"] = torch.randint(0, NB_PART + 1, (N_BIG,), generator=gen, device=dev,
                              dtype=torch.int32)
    x["part_start"] = torch.randint(0, 1 << 24, (NB_PART,), generator=gen, device=dev,
                                    dtype=torch.int32)
    x["rows"] = torch.randint(0, NB_PART, (B_BULK, N_ROW), generator=gen, device=dev,
                              dtype=torch.int32)
    x["rows_start"] = torch.stack([prefix(r, NB_PART) for r in x["rows"]])
    x.update(entry_inputs(torch, dev))
    inputs = ROOT / "build" / "parent" / "entry_inputs.pt"
    torch.save({k: v.cpu() if torch.is_tensor(v) else v for k, v in x.items()}, inputs)
    calls = entry_calls(torch, x)
    child = subprocess.Popen([sys.executable, "-c", PARENT_CHILD, str(ROOT),
                              str(parent / "src"), str(inputs)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    result = {}
    try:
        for name, call in calls.items():
            times = {"parent": [], "this": []}
            for side in ("parent", "this", "this", "parent"):
                if side == "parent":
                    child.stdin.write(name + "\n")
                    child.stdin.flush()
                    line = child.stdout.readline()
                    if not line:
                        fail(f"the earlier tree's {name} child process ended")
                    times[side].append(json.loads(line))
                else:
                    launches, device, kernels = call_kernels(torch, call)
                    times[side].append({"ms": cuda_ms(torch, call), "device_ms": device,
                                        "launches": launches, "syncs": sync_calls(torch, call),
                                        "peak": peak_rise(torch, call),
                                        "kernels": {short_kernel(k): v
                                                    for k, v in kernels.items()}})
            got = call()
            got = got if isinstance(got, tuple) else (got,)
            want = torch.load(inputs.with_name(f"parent_{name}.pt"))
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            result[name] = {side: {key: [t.get(key) for t in ts]
                                   for key in ("ms", "device_ms", "launches", "syncs", "peak",
                                               "kernels")}
                            for side, ts in times.items()}
            result[name]["same_outputs"] = same

            def turns(ts, key, fmt=".4f"):
                return " ".join(format(t[key], fmt) for t in ts)

            split = {k: sum(t["kernels"].get(k, 0.0) for t in times["parent"]) / 2
                     for k in times["parent"][0]["kernels"]}
            split_this = {k: sum(t["kernels"].get(k, 0.0) for t in times["this"]) / 2
                          for k in times["this"][0]["kernels"]}
            idle = {side: [1 - t["device_ms"] / t["ms"] for t in ts]
                    for side, ts in times.items()}
            for side in idle:
                result[name][side]["idle_share"] = idle[side]
            print(f"before/after {name} entry point: " + "; ".join(
                f"{side} events {turns(ts, 'ms')} ms, device (all kernels of a call) "
                f"{turns(ts, 'device_ms')} ms, kernels a call {turns(ts, 'launches', 'g')}, "
                f"idle share {' '.join(f'{v:.3f}' for v in idle[side])}, synchronizing calls "
                f"{' '.join(str(t.get('syncs')) for t in ts)}, peak bytes above the inputs "
                f"{' '.join(str(t.get('peak')) for t in ts)}"
                for side, ts in times.items()) + f"; same outputs: {same}; the earlier "
                f"tree's device ms per kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + "; this tree's: " + ", ".join(f"{k} {v:.4f}" for k, v in split_this.items()),
                flush=True)
            if not same:
                fail(f"{name}: this tree's entry point and the earlier one differ")
    finally:
        child.stdin.close()
        try:
            child.wait(timeout=120)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    return result


def _zipf_keys(np, n: int, seed: int):
    """Zipf(1.3) float32 keys capped at 2^30: a heavy skew of duplicates."""
    return np.minimum(np.random.default_rng(seed).zipf(1.3, n), 1 << 30).astype(np.float32)


def _dist_rank(rank: int, world: int, tmp: str, q) -> None:
    """One of the four ranks of ``path dist`` and ``path elastic`` (spawned by
    :func:`dist_phases`, all on ``cuda:0`` with the ``gloo`` backend): every
    check made here, each rank's kernel launches, its times and what obs
    recorded go back to the parent on ``q``."""
    try:
        import os

        # order="auto" records its order in the plan cache: one file a rank,
        # in the run's temporary directory
        os.environ["REPRO_TORCH_OPS_PLAN_CACHE"] = f"{tmp}/plans{rank}.json"
        import numpy as np
        import torch
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.profiler import ProfilerActivity, profile as torch_profile

        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        from repro_torch import dist, kernels, obs, ops
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.data.distributions import make_input
        from repro_torch.dist.exchange import group_for

        made = [0]

        def new_group():
            """A fresh process group (a restarted job) and its two meshes."""
            if tdist.is_initialized():
                tdist.destroy_process_group()
            made[0] += 1
            tdist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous{made[0]}",
                                     rank=rank, world_size=world)
            return {"(4,)": (init_device_mesh("cuda", (4,), mesh_dim_names=("data",)), "data"),
                    "(2, 2)": (init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "data")),
                               ("pod", "data"))}

        meshes = new_group()
        n = N_DIST_LOCAL
        full = {"Uniform": make_input("Uniform", n * world, np.float32, seed=80),
                "TwoDup": make_input("TwoDup", n * world, np.int32, seed=81),
                "Zipf": _zipf_keys(np, n * world, seed=82),
                # radix destinations need key bits that vary at the top: on
                # Uniform [0, 1) floats every key goes to one group at level 0
                # and (2, 2)'s second level overflows, in the reference too
                "int32 full range": np.random.default_rng(83).integers(
                    -2**31, 2**31, n * world, dtype=np.int64).astype(np.int32)}
        want = {}  # each input's stable sort of its codes, on the card
        out = {"checks": [], "info": [], "times": [], "serve_times": []}
        kernels.reset_launch_counts()

        def check(what, ok):
            out["checks"].append((what, bool(ok)))

        def shard(x, pos):
            return torch.as_tensor(x[pos * n:(pos + 1) * n], device=dev)

        def range_ok(tag, res, mesh, axes):
            """This rank's valid prefix is its slice of the stable sort of the
            gathered input; the counts add up; no overflow."""
            keys, counts, ovf = res[0], res[-2], res[-1]
            grp = group_for(mesh, (axes,) if isinstance(axes, str) else axes)
            all_c = grp.all_gather(counts.to(torch.int64))
            c, start = int(counts[0]), int(all_c[:grp.index].sum())
            if tag not in want:
                want[tag] = torch.sort(ops.keyspace.encode(torch.as_tensor(full[tag], device=dev)),
                                       stable=True).values
            return (not bool(ovf[0]) and int(all_c.sum()) == n * world and torch.equal(
                ops.keyspace.encode(keys[:c]), want[tag][start:start + c]))

        def same(a, b):
            return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                   y.view(torch.int32) if y.dtype == torch.float32 else y)
                       for x, y in zip(a, b) if isinstance(x, torch.Tensor))

        for mname, (mesh, axes) in meshes.items():
            pos = group_for(mesh, (axes,) if isinstance(axes, str) else axes).index
            for tag in ("Uniform", "TwoDup", "Zipf"):
                xs = shard(full[tag], pos)
                obs.enabled(tag == "Zipf")
                obs.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = dist.sort(xs, mesh, axes)
                torch.cuda.synchronize()
                out["times"].append((f"{mname} {tag}", 1e3 * (time.perf_counter() - t0)))
                check(f"{mname} {tag} sort", range_ok(tag, res, mesh, axes))
                if tag == "Zipf":
                    out["info"].append((f"{mname} Zipf obs", {
                        "dist.resplit_rounds": obs.hist_values("dist.resplit_rounds"),
                        "dist.collective_bytes": obs.hist_values("dist.collective_bytes")}))
                    obs.enabled(False)
                    obs.reset()
                if tag == "Uniform":
                    check(f"{mname} Uniform overlap bit-identical to sync",
                          same(dist.sort(xs, mesh, axes, overlap=True), res))
                    wide = "int32 full range"
                    check(f"{mname} {wide} radix", range_ok(wide, dist.sort(
                        shard(full[wide], pos), mesh, axes, classifier="radix"), mesh, axes))
                    idx = torch.arange(pos * n, (pos + 1) * n, dtype=torch.int32, device=dev)
                    keys, vals, counts, ovf = dist.sort(
                        xs, mesh, axes, values={"idx": idx, "pair": (xs, idx.to(torch.int64) * 3)})
                    c = int(counts[0])
                    gidx = vals["idx"][:c].to(torch.int64)
                    whole = torch.as_tensor(full[tag], device=dev)
                    check(f"{mname} Uniform payload pytree", range_ok(
                        tag, (keys, counts, ovf), mesh, axes) and torch.equal(
                        whole[gidx].view(torch.int32), keys[:c].view(torch.int32))
                        and torch.equal(vals["pair"][0][:c].view(torch.int32),
                                        keys[:c].view(torch.int32))
                        and torch.equal(vals["pair"][1][:c], gidx * 3))
                    tight = [dist.sort(xs, mesh, axes, slack=0.05) for _ in range(2)]
                    check(f"{mname} Uniform slack 0.05 flags overflow, twice the same",
                          bool(tight[0][-1][0]) == bool(tight[1][-1][0]) and same(*tight)
                          and int(tight[0][-2][0]) <= tight[0][0].shape[0])
                    flags = group_for(mesh, (axes,) if isinstance(axes, str) else axes
                                      ).all_gather(tight[0][-1].to(torch.int32))
                    check(f"{mname} Uniform slack 0.05 overflow raised", int(flags.sum()) > 0)
        # order="auto" on a mis-declared tuple: the slow axis first
        mesh, _ = meshes["(2, 2)"]
        pos = group_for(mesh, ("pod", "data")).index
        res = dist.sort(shard(full["Uniform"], pos), mesh, ("data", "pod"), order="auto")
        check("(2, 2) order='auto' from ('data', 'pod')", range_ok("Uniform", res, mesh,
                                                                 ("pod", "data")))
        # rank 0's profile of one sort: K1, K2 and K3 on the card
        xs = shard(full["Uniform"], pos)
        if rank == 0:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                dist.sort(xs, mesh, ("pod", "data"))
                torch.cuda.synchronize()
            names = {e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}
            for kernel, fns in (("K1", DEVICE_FUNCTIONS["level_fused"]),
                                ("K2", DEVICE_FUNCTIONS["rank_hist"]),
                                ("K3", DEVICE_FUNCTIONS["sort_windows"])):
                check(f"rank 0's profile shows {kernel}",
                      any(f in name for f in fns for name in names))
        else:
            dist.sort(xs, mesh, ("pod", "data"))
        # path elastic: killed after level 1, restored in a fresh process group
        ref = dist.sort(xs, mesh, ("pod", "data"))
        try:
            dist.sort_elastic(xs, mesh, ("pod", "data"), _fail_at_step=1,
                              manager=CheckpointManager(f"{tmp}/elastic", keep=8))
            killed = False
        except RuntimeError as exc:
            killed = "injected shard loss" in str(exc)
        meshes = new_group()
        mesh, _ = meshes["(2, 2)"]
        survivor = CheckpointManager(f"{tmp}/elastic", keep=8)
        resumed_from = survivor.latest_step()
        got = dist.sort_elastic(xs, mesh, ("pod", "data"), manager=survivor)
        whole = dist.sort_elastic(xs, mesh, ("pod", "data"),
                                  manager=CheckpointManager(f"{tmp}/whole", keep=8))
        check("elastic killed after level 1, restored from boundary 1",
              killed and resumed_from == 1)
        check("elastic restored == uninterrupted == dist.sort", same(got, whole) and same(whole, ref))
        # the scheduler's admission and the length packing across the ranks:
        # every rank holds the queue (and the lengths) and gets the same answer
        from repro_torch.data.pipeline import _dist_length_order, pack_by_length
        from repro_torch.serve.scheduler import Request, Scheduler

        rem = np.random.default_rng(84).integers(1, SCHED_MAX_NEW + 1, SCHED_QUEUE)
        oracle = np.lexsort((np.arange(len(rem)), rem))
        docs = np.random.default_rng(85).integers(1, 512, PACK_N).astype(np.int32)
        rows_single = pack_by_length(docs, PACK_SEQ, device=dev)[2]
        for mname, (mesh, axes) in meshes.items():
            sched = Scheduler(batch_size=SCHED_BATCH, device=dev)
            for uid, m in enumerate(rem):
                sched.submit(Request(uid=uid, prompt_len=1024, max_new=int(m)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            waves = [[r.uid for r in sched.next_batch(mesh=mesh, axes=axes)] for _ in range(3)]
            out["serve_times"].append((f"{mname} next_batch(mesh=) x3 on {SCHED_QUEUE}",
                                       1e3 * (time.perf_counter() - t0)))
            check(f"{mname} next_batch(mesh=) three admissions equal the host oracle",
                  waves == [oracle[i * SCHED_BATCH:(i + 1) * SCHED_BATCH].tolist()
                            for i in range(3)])
            idx = _dist_length_order(docs, mesh, axes)
            check(f"{mname} pack_by_length(mesh=)'s length order sorts the {PACK_N} lengths",
                  idx is not None and np.array_equal(np.sort(idx), np.arange(PACK_N))
                  and bool((np.diff(docs[idx]) >= 0).all()))
            check(f"{mname} pack_by_length(mesh=) rows equal the single-device pack's",
                  pack_by_length(docs, PACK_SEQ, mesh=mesh, axes=axes)[2] == rows_single)
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
        q.put((rank, out))
        tdist.destroy_process_group()
    except BaseException:
        import traceback

        q.put((rank, {"error": traceback.format_exc()}))


def dist_phases(torch, dev, rows) -> None:
    """Phases 3 and 4 of the observability layer (``path obs``), the
    distributed sort (``path dist``: NCCL at world size 1 here, then four
    ``gloo`` ranks on the one card) and the elastic sort (``path
    elastic``).  Their launches of K1, K2 and K3 join the kernels line."""
    import warnings

    import numpy as np
    import torch.distributed as tdist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch import dist, kernels, obs, ops
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ips4o
    from repro_torch.data.distributions import make_input

    added = {}
    sort_kernels = ("level_fused", "rank_hist", "sort_windows")

    def drive(path, needed, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"path {path} launches: {({k: v for k, v in launches.items() if v})} "
              f"({time.time() - t0:.1f} s)", flush=True)
        for name in needed:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the path {path}")
        for name, count in launches.items():
            added[name] = added.get(name, 0) + count
        return res

    def verdict(path, what, ok):
        print(f"path {path}: {what} {'ok' if ok else 'WRONG'}", flush=True)
        if not ok:
            fail(f"path {path} wrong on {what}")

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    x = torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=70), device=dev)
    xi = torch.as_tensor(make_input("TwoDup", N_BIG, np.int32, seed=71), device=dev)
    enc = {"Uniform": ops.keyspace.encode(x), "TwoDup": ops.keyspace.encode(xi)}
    order = {tag: torch.sort(e, stable=True).indices for tag, e in enc.items()}

    # ---- path obs: the span tree, the sort's stats, the exports, the profile
    path = f"obs (ops.sort of {N_BIG} float32 Uniform, tree, obs enabled)"
    captured = []
    level_stats = ips4o._obs_level_stats

    def capture(offsets, nb, pad_bucket, level):  # the offsets each level's stats come from
        captured.append((offsets.clone(), nb, pad_bucket, level))
        level_stats(offsets, nb, pad_bucket, level)

    ops.sort(x)  # warm: the spans below time the card's work, not first-call set-up
    ips4o._obs_level_stats = capture
    obs.enabled(True)
    obs.reset()
    try:
        got = drive(path, sort_kernels, lambda: ops.sort(x))
    finally:
        ips4o._obs_level_stats = level_stats
    verdict(path, "sort", torch.equal(bits(got), bits(ops.keyspace.decode(
        enc["Uniform"][order["Uniform"]], torch.float32))))
    stats = obs.span_stats()  # resolves every span's device_ms
    spans = obs.recorder().spans

    def kids(s):
        return [c for c in spans if c["parent"] == s["id"]]

    roots = [s for s in spans if s["parent"] is None]
    tree_ok = [s["name"] for s in roots] == ["ops.sort"]
    top = kids(roots[0]) if tree_ok else []
    tree_ok &= [s["name"] for s in top] == ["ips4o_sort"]
    passes = kids(top[0]) if tree_ok else []
    tree_ok &= [(s["name"], s["attrs"].get("level")) for s in passes] == [
        ("level_pass", 1), ("level_pass", 2), ("base_case", None)]
    for s in passes[:2]:
        tree_ok &= [c["name"] for c in kids(s)] == ["sample", "classify", "partition"]
    verdict(path, "span tree ops.sort > ips4o_sort > level_pass(1) > sample/classify/"
            "partition, level_pass(2), base_case", tree_ok)
    timed = all("device_ms" in s for s in spans)
    nested = timed and all(sum(c["device_ms"] for c in kids(s)) <= s["device_ms"] + 1e-3
                           for s in spans if kids(s))
    print(f"path obs: spans {len(spans)}; device ms: " + ", ".join(
        f"{name} {a['device_ms']:.3f}" for name, a in stats.items() if "device_ms" in a),
        flush=True)
    verdict(path, "every span has device_ms, its children's sum <= its own (+1 us)", nested)
    want_stats = {}
    for offsets, nb, pad_bucket, level in captured:
        sizes = (offsets[1:] - offsets[:-1]).to(torch.int64)
        ids = torch.arange(nb, device=dev)
        mask = (ids % 2 == 0) & (ids != (-1 if pad_bucket is None else pad_bucket))
        szs = torch.where(mask, sizes, 0)
        mean = torch.clamp(szs.sum().to(torch.float32) / int(mask.sum()), min=1.0)
        want_stats[level] = ([float(szs.max().to(torch.float32) / mean)], [float(szs.max())])
        if level == "2":  # the fallback's verdict: an even bucket above W/2
            fallback = bool((mask & (sizes > ips4o.SortConfig().base_case // 2)).any())
    got_stats = {lv: (obs.hist_values("sort.bucket_imbalance", level=lv),
                      obs.hist_values("sort.largest_bucket", level=lv)) for lv in want_stats}
    print(f"path obs: bucket_imbalance/largest_bucket {got_stats}, fallback_engaged "
          f"{obs.counter_value('sort.fallback_engaged')}, base_case "
          f"{obs.counter_value('sort.base_case')}", flush=True)
    verdict(path, "sort.bucket_imbalance and sort.largest_bucket equal plain torch's from the "
            "call's offsets", set(want_stats) == {"1", "2"} and got_stats == want_stats)
    verdict(path, "sort.fallback_engaged equals the fallback's verdict",
            obs.counter_value("sort.fallback_engaged") == int(fallback)
            and obs.counter_value("sort.base_case") == 1 - int(fallback))
    with tempfile.TemporaryDirectory() as tmp:
        obs.export_jsonl(f"{tmp}/obs.jsonl")
        obs.export_chrome_trace(f"{tmp}/obs.trace.json")
        lines = [json.loads(line) for line in open(f"{tmp}/obs.jsonl")]
        trace = json.load(open(f"{tmp}/obs.trace.json"))
    verdict(path, "the JSONL and Chrome-trace exports parse", sum(
        1 for line in lines if line["type"] == "span") == len(spans) and sum(
        1 for e in trace["traceEvents"] if e["ph"] == "X") == len(spans))
    obs.reset()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.sort(x)
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    verdict(path, "the profiler's trace holds the span names", {
        "ops.sort", "ips4o_sort", "level_pass", "sample", "classify", "partition",
        "base_case"} <= keys)
    obs.enabled(False)
    obs.reset()

    def launches_and_syncs(fn):
        """(runtime launch calls on the host and device kernels, by one
        torch.profiler trace (a trace can lose device kernels, never host
        calls); synchronizing calls flagged by ``set_sync_debug_mode``) of
        one call of ``fn``."""
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        ev = p.key_averages()
        calls = sum(e.count for e in ev if "LaunchKernel" in e.key
                    and e.device_type != torch.autograd.DeviceType.CUDA)
        device = sum(e.count for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("Memcpy", "Memset")))
        counted = []
        for _ in range(2):  # the first call under the debug mode also flags a
            # one-time sync of torch's own (torch/cuda/__init__.py): the second counts
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            counted.append(sum(1 for w in caught if "synchroniz" in str(w.message)))
        return calls, device, counted[-1]

    disabled = launches_and_syncs(lambda: ops.sort(x))
    hooks = {name: getattr(obs, name) for name in (
        "trace", "block", "enabled", "count", "gauge", "observe", "jit_count", "jit_observe",
        "jit_event")}
    null = contextlib.nullcontext()
    try:
        obs.trace = lambda *a, **k: null
        obs.block = lambda v: v
        obs.enabled = lambda *a: False
        for name in ("count", "gauge", "observe", "jit_count", "jit_observe", "jit_event"):
            setattr(obs, name, lambda *a, **k: None)
        noop = launches_and_syncs(lambda: ops.sort(x))
    finally:
        for name, fn in hooks.items():
            setattr(obs, name, fn)
    print(f"path obs disabled: launch calls {disabled[0]}, synchronizing calls {disabled[2]} "
          f"(device kernels kept by the trace {disabled[1]}); with no-op hooks: {noop[0]}, "
          f"{noop[2]} ({noop[1]})", flush=True)
    verdict(path, "obs disabled launches and syncs as the no-op hooks",
            (disabled[0], disabled[2]) == (noop[0], noop[2]))

    # ---- path dist at world size 1 on NCCL ------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    tdist.init_process_group("nccl", init_method=f"file://{tmp}/nccl1", rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    # one rank: slack 1 (the default 2 pads the range to 2^25 keys, past the
    # two levels the default config plans with kmax = 128)
    one = dict(slack=1.0)
    path = f"dist world size 1 (NCCL; {N_BIG} float32 Uniform and int32 TwoDup)"

    def world1():
        res = {}
        for tag, xx in (("Uniform", x), ("TwoDup", xi)):
            res[tag, "sort"] = dist.sort(xx, mesh, **one)
            res[tag, "argsort"] = dist.argsort(xx, mesh, **one)
            res[tag, "bottomk"] = dist.bottomk(xx, DIST_K, mesh)
            res[tag, "topk"] = dist.topk(xx, DIST_K, mesh)
            res[tag, "group_by"] = dist.group_by(xx, mesh, **one)
        return res

    got = drive(path, sort_kernels, world1)
    for tag, xx in (("Uniform", x), ("TwoDup", xi)):
        e, o = enc[tag], order[tag]
        keys, counts, ovf = got[tag, "sort"]
        ok = int(counts[0]) == N_BIG and not bool(ovf[0])
        verdict(path, f"{tag} sort == ops.sort == torch.sort(stable=True)", ok and torch.equal(
            bits(keys[:N_BIG]), bits(ops.sort(xx))) and torch.equal(
            ops.keyspace.encode(keys[:N_BIG]), e[o]))
        idx = got[tag, "argsort"][0][:N_BIG].to(torch.int64)
        verdict(path, f"{tag} argsort == ops.argsort == torch.sort(stable=True)", torch.equal(
            idx, ops.argsort(xx).to(torch.int64)) and torch.equal(idx, o))
        for kind, want_i in (("bottomk", o[:DIST_K]),
                             ("topk", torch.sort(~e, stable=True).indices[:DIST_K])):
            v, i = got[tag, kind]
            wv, wi = getattr(ops, kind)(xx, DIST_K)
            verdict(path, f"{tag} {kind} k={DIST_K} == ops.{kind}", torch.equal(
                bits(v), bits(wv)) and torch.equal(i, wi) and torch.equal(i.to(torch.int64), want_i))
        gk, starts, counts, _ = got[tag, "group_by"]
        s = e[o]
        want_starts = torch.ones_like(s, dtype=torch.bool)
        want_starts[1:] = s[1:] != s[:-1]
        verdict(path, f"{tag} group_by", torch.equal(ops.keyspace.encode(gk[:N_BIG]), s)
                and torch.equal(starts[:N_BIG], want_starts) and not bool(starts[N_BIG:].any()))

    path = f"elastic world size 1 (NCCL; {N_DIST_LOCAL} float32 Uniform)"
    xe = x[:N_DIST_LOCAL].clone()

    def elastic1():
        ref = dist.sort(xe, mesh)
        try:
            dist.sort_elastic(xe, mesh, manager=CheckpointManager(f"{tmp}/ck1"), _fail_at_step=1)
            killed = False
        except RuntimeError as exc:
            killed = "injected shard loss" in str(exc)
        return ref, killed

    ref, killed = drive(path, sort_kernels, elastic1)
    tdist.destroy_process_group()
    tdist.init_process_group("nccl", init_method=f"file://{tmp}/nccl2", rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    survivor = CheckpointManager(f"{tmp}/ck1")
    resumed_from = survivor.latest_step()
    got = dist.sort_elastic(xe, mesh, manager=survivor)
    whole = dist.sort_elastic(xe, mesh, manager=CheckpointManager(f"{tmp}/ck_whole"))
    verdict(path, "killed after level 1 (boundary 1), restored in a fresh process group",
            killed and resumed_from == 1)
    verdict(path, "restored == uninterrupted == dist.sort", all(
        torch.equal(bits(a), bits(b)) and torch.equal(bits(b), bits(c))
        for a, b, c in zip(got, whole, ref)))

    # ---- phase 4 for these paths: the cost of obs; dist.sort at world size 1
    t_off = cuda_ms(torch, lambda: ops.sort(x), reps=5)
    obs.enabled(True)
    t_on = cuda_ms(torch, lambda: (obs.reset(), ops.sort(x)), reps=5)
    obs.enabled(False)
    obs.reset()
    t_dist = cuda_ms(torch, lambda: dist.sort(x, mesh, **one), reps=5)
    t_ops = cuda_ms(torch, lambda: ops.sort(x), reps=5)
    print(f"time ops.sort {N_BIG} float32 Uniform: obs disabled {t_off:.3f} ms, obs enabled "
          f"{t_on:.3f} ms (median of 5, CUDA events)", flush=True)
    print(f"time dist.sort world size 1 (NCCL) {N_BIG} float32 Uniform: {t_dist:.3f} ms, "
          f"ops.sort {t_ops:.3f} ms (median of 5, CUDA events)", flush=True)
    tdist.destroy_process_group()

    # ---- path dist and path elastic on four gloo ranks on the one card --------
    # the kernels were built before (phase 1), so four ranks never build at once
    path = (f"dist {DIST_WORLD} gloo ranks on one card ((4,) and (2, 2) meshes, "
            f"{N_DIST_LOCAL} keys a rank)")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_dist_rank, args=(r, DIST_WORLD, tmp, q))
             for r in range(DIST_WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < DIST_WORLD:
            try:
                rank, res = q.get(timeout=5)
            except queue.Empty:  # a rank that died without an answer fails the path now
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.time() - t0 > 600:
                    fail(f"path {path}: ranks ended with {dead} before answering")
                continue
            if "error" in res:
                fail(f"path {path}: rank {rank} failed:\n{res['error']}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    launches = {}
    for res in results.values():
        for name, count in res["launches"].items():
            launches[name] = launches.get(name, 0) + count
    print(f"path {path} launches (all ranks): {({k: v for k, v in launches.items() if v})} "
          f"({time.time() - t0:.1f} s with the ranks' start)", flush=True)
    for name in sort_kernels:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the path {path}")
    for name, count in launches.items():
        added[name] = added.get(name, 0) + count
    for what, ok in results[0]["checks"]:
        verdict(path, what, ok and all(dict(r["checks"]).get(what, True) for r in
                                        results.values()))
    for what, info in results[0]["info"]:
        print(f"path {path}: rank 0 {what}: {info}", flush=True)
    for what, ms in results[0]["times"]:
        print(f"time dist.sort gloo 4 ranks {what}: {ms:.1f} ms on rank 0 (host clock; gloo "
              f"moves CUDA tensors through host copies: not the exchange's cost)", flush=True)
    for what, ms in results[0]["serve_times"]:
        print(f"time scheduler gloo 4 ranks {what}: {ms:.1f} ms on rank 0 (host clock, the "
              f"queue's composite keys built on every rank)", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    for name, count in added.items():
        if name in rows and count:
            rows[name]["launches"] += count


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch import kernels, obs, ops, stream
        from repro_torch.core import ips4o, sampling
        from repro_torch.core.partition import partition_blocks, partition_ranks_kernel
        from repro_torch.core.s3sort import s3_sort
        from repro_torch.configs.ips4o_paper import TPU_BIG_PAYLOAD
        from repro_torch.data.distributions import ELEMENT_TYPES, make_input, make_payload
        from repro_torch.kernels import bitonic, dispatch_rank as dr, glue, level_fused as lf
        from repro_torch.kernels import block_permute as bp, classify as cl
        from repro_torch.kernels import merge_path as mp, permute_inplace as pi, ref as kref
        from repro_torch.kernels.ops import moe_group_tokens, sort_blocks
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        fail("the port imported jax or repro")

    # ---- 1. set-up -----------------------------------------------------
    t_start = time.time()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi: {exc}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {kind}", flush=True)
    t0 = time.time()
    try:
        logs = kernels.build_all()
    except RuntimeError as exc:
        fail(f"kernel build: {exc}")
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s",
          flush=True)
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    def encoded(dist, n, dtype, seed=1):
        return ops.keyspace.encode(torch.as_tensor(make_input(dist, n, dtype, seed=seed),
                                                   device=dev))

    def full_range(shape, seed):
        """int32 keys uniform over the whole int32 range (made on the host)."""
        rng = np.random.default_rng(seed)
        x = rng.integers(-2**31, 2**31, int(np.prod(shape)), dtype=np.int64)
        return torch.as_tensor(x.astype(np.int32).reshape(shape), device=dev)

    def wide_input(name, n, seed):
        """64-bit keys on the card: float64 Uniform with a third negated and
        NaN, +-0.0 and +-inf sprinkled in, int64 TwoDup, or int64 / uint64 /
        float64 bit patterns over the whole range (made on the host from a
        seed)."""
        if name == "float64":
            x = make_input("Uniform", n, np.float64, seed=seed)
            x[3::3] *= -1
            x[::1009] = np.nan
            x[1::1013] = -0.0
            x[2::1019] = 0.0
            x[4::1021] = np.inf
            x[5::1031] = -np.inf
            return torch.as_tensor(x, device=dev)
        if name == "int64 TwoDup":
            return torch.as_tensor(make_input("TwoDup", n, np.int64, seed=seed), device=dev)
        x = torch.as_tensor(np.random.default_rng(seed).integers(
            -2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True), device=dev)
        return {"uint64": x.view(torch.uint64), "float64 full range": x.view(torch.float64)
                }.get(name, x)

    def check_equal(name, got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        print(f"{name} {what}: max_abs_err={err}", flush=True)
        if err != 0:
            fail(f"{name} differs from its plain twin on {what}")
        rows.setdefault(name, {"max_abs_err": 0})

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    def sort_phases():
        """Phases 2-4 for the sort kernels and paths; their tensors are freed
        when it returns."""
        # ---- 2. kernels against their plain twins ------------------------------
        k = 128
        n_real = N_BIG - 12345
        for dist, dtype in (("Uniform", np.float32), ("TwoDup", np.int32)):
            keys = encoded(dist, n_real, dtype)
            keys = ips4o.pad_with_sentinel({"k": keys}, N_BIG)["k"]
            pos = torch.randint(0, n_real, (4 * k,), generator=gen, device=dev)
            spl = sampling.select_splitters(torch.sort(keys[pos]).values, k)
            raw_kernel = lf._level_tiles_kernel(keys[None], spl[None], k, n_real, lf.TILE)
            raw_plain = lf._level_tiles_plain(keys[None], spl[None], k, n_real, lf.TILE)
            check_equal("level_fused", (raw_kernel, lf.level_fused(keys, spl, k=k, n_real=n_real)),
                        (raw_plain, lf.level_fused_plain(keys, spl, k=k, n_real=n_real)),
                        f"{dist} n={N_BIG} n_real={n_real} k={k}")

        # K2 on the composite ids of a real level 1 (two-level plan at n = 2^24)
        cfg = ips4o.SortConfig()
        levels = ips4o.plan_levels(N_BIG, cfg)
        keys = encoded("Uniform", N_BIG, np.float32)
        level_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        arrays, off1, nb1, _ = ips4o.level_pass({"k": keys}, N_BIG, levels[0], cfg, level_gen)
        k2 = levels[1]
        comp = ips4o.composite_ids(arrays["k"], off1, nb1, N_BIG, k2, level_gen)
        nb2 = nb1 * 2 * k2
        k2_args = dict(nb=nb2, seg_offsets=off1, seg_width=2 * k2)
        k2_tile = ips4o._auto_tile(N_BIG, 2 * k2, cfg)
        got = lf.rank_hist(comp, tile=k2_tile, **k2_args)
        want = lf.rank_hist_plain(comp, tile=k2_tile, **k2_args)
        yard = torch.sort(comp, stable=True).indices
        check_equal("rank_hist", got, want, f"composite n={N_BIG} nb={nb2}")
        if not torch.equal(got[0][yard].to(torch.int64), torch.arange(N_BIG, device=dev)):
            fail("K2 is not the inverse of the stable argsort of the composite ids")
        for nb in (3, 520):
            ids = torch.randint(0, nb, (1 << 20,), generator=gen, device=dev, dtype=torch.int32)
            check_equal("rank_hist", lf.rank_hist(ids, nb=nb), lf.rank_hist_plain(ids, nb=nb),
                        f"n={1 << 20} nb={nb}")

        # K3 on duplicate-heavy windows, where stability shows: the main
        # path's W, the scheduler path's and the largest
        for W_, num_w_ in ((256, 1 << 16), (bitonic.MAX_W, 1024)):
            wb = torch.sort(torch.randint(0, 64, (num_w_, W_), generator=gen, device=dev,
                                          dtype=torch.int32), dim=1).values
            wk = torch.randint(-3, 4, (num_w_, W_), generator=gen, device=dev, dtype=torch.int32)
            check_equal("sort_windows", bitonic.sort_windows(wb, wk, nb=64),
                        bitonic.sort_windows_plain(wb, wk, nb=64),
                        f"{num_w_} x {W_} duplicate-heavy")
        W, num_w = cfg.base_case, 2048
        wb = torch.sort(torch.randint(0, 64, (num_w, W), generator=gen, device=dev,
                                      dtype=torch.int32), dim=1).values
        wk = torch.randint(-3, 4, (num_w, W), generator=gen, device=dev, dtype=torch.int32)
        check_equal("sort_windows", bitonic.sort_windows(wb, wk, nb=64),
                    bitonic.sort_windows_plain(wb, wk, nb=64), f"{num_w} x {W} duplicate-heavy")

        # K1r: the radix mode, level 1 (top 7 bits) and a level-2 shift, with pads
        keys_r = full_range((N_BIG,), seed=11)
        keys_r[n_real:] = torch.iinfo(torch.int32).max
        for consumed in (0, 7):
            kw = dict(k=k, n_real=n_real, classifier="radix", consumed_bits=consumed)
            check_equal("level_fused_radix",
                        (lf._level_tiles_kernel(keys_r[None], None, k, n_real, lf.TILE, consumed),
                         lf.level_fused(keys_r, **kw)),
                        (lf._level_tiles_plain(keys_r[None], None, k, n_real, lf.TILE, consumed),
                         lf.level_fused_plain(keys_r, **kw)),
                        f"n={N_BIG} n_real={n_real} k={k} consumed={consumed}")

        # K4 level_fused_batched: per-row splitters or the radix shift, pads per row
        row_real = N_ROW - 333
        kb = encoded("Uniform", B_BULK * N_ROW, np.float32, seed=3).view(B_BULK, N_ROW)
        kb = ips4o.batched_pad_with_sentinel({"k": kb[:, :row_real].contiguous()}, N_ROW)["k"]
        pos = torch.randint(0, row_real, (B_BULK, 4 * k), generator=gen, device=dev)
        spl_b = sampling.select_splitters(torch.sort(torch.gather(kb, 1, pos), dim=1).values, k)
        for mode, s in (("tree", spl_b), ("radix", None)):
            kw = dict(k=k, n_real=row_real, classifier=mode)
            check_equal("level_fused_batched",
                        (lf._level_tiles_kernel(kb, s, k, row_real, lf.TILE, batched=True),
                         lf.level_fused_batched(kb, s, **kw)),
                        (lf._level_tiles_plain(kb, s, k, row_real, lf.TILE),
                         lf.level_fused_batched_plain(kb, s, **kw)),
                        f"{mode} ({B_BULK}, {N_ROW}) n_real={row_real} k={k}")

        # K4 rank_hist_batched on the composite ids of a real batched level 1
        levels_b = ips4o.plan_levels(N_ROW, cfg)
        kb = encoded("Uniform", B_BULK * N_ROW, np.float32, seed=4).view(B_BULK, N_ROW)
        level_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        arrays_b, off1_b, nb1_b, _ = ips4o.batched_level_pass({"k": kb}, N_ROW, levels_b[0], cfg,
                                                              level_gen)
        k2b = levels_b[1]
        comp_b = ips4o.batched_composite_ids(arrays_b["k"], off1_b, nb1_b, N_ROW, k2b, level_gen)
        k4_args = dict(nb=nb1_b * 2 * k2b, seg_offsets=off1_b, seg_width=2 * k2b)
        k4_tile = ips4o._auto_tile(N_ROW, 2 * k2b, cfg)
        got = lf.rank_hist_batched(comp_b, tile=k4_tile, **k4_args)
        want = lf.rank_hist_batched_plain(comp_b, tile=k4_tile, **k4_args)
        check_equal("rank_hist_batched", got, want,
                    f"composite ({B_BULK}, {N_ROW}) nb={k4_args['nb']}")
        yard = torch.sort(comp_b, dim=1, stable=True).indices
        if not torch.equal(torch.gather(got[0], 1, yard).to(torch.int64),
                           torch.arange(N_ROW, device=dev).expand(B_BULK, N_ROW)):
            fail("K4 rank_hist_batched is not the inverse of the per-row stable argsort")

        # ---- the glue kernels G1-G4 (csrc/glue.cu) against their plain twins,
        # bit for bit: G1 on K1's and K4's tile histograms with pads (n_real <
        # n), 1 and 64 rows, all keys in one bucket; G2 on level 1's offsets
        # (nb 257), level 2's (nb 65,792), 64 rows and one bucket; G3 on the
        # 1-D and batched level 2, int64 codes, radix mode and 4097 segments;
        # G4's scatter of payload rows of 1-16 B by the level placements (with
        # their offsets: the staged path) and a permutation (row by row), and
        # its window gathers, direct and in place
        glue_keys = ips4o.pad_with_sentinel(
            {"k": encoded("Uniform", n_real, np.float32, seed=21)}, N_BIG)["k"]
        glue_spl = sampling.select_splitters(torch.sort(glue_keys[torch.randint(
            0, n_real, (4 * k,), generator=gen, device=dev)]).values, k)
        glue_rows = ips4o.batched_pad_with_sentinel(
            {"k": encoded("Uniform", B_BULK * N_ROW, np.float32, seed=22).view(
                B_BULK, N_ROW)[:, :row_real].contiguous()}, N_ROW)["k"]
        glue_rows_spl = sampling.select_splitters(torch.sort(glue_rows[:, : 8 * k], dim=1).values,
                                                  k).contiguous()
        for tag, (rk, rs, real) in {
                f"n={N_BIG} n_real={n_real} k={k}": (glue_keys[None], glue_spl[None], n_real),
                f"all keys in one bucket n={N_BIG}": (
                    torch.zeros((1, N_BIG), dtype=torch.int32, device=dev), glue_spl[None], N_BIG),
                f"({B_BULK}, {N_ROW}) n_real={row_real}": (glue_rows, glue_rows_spl, row_real),
        }.items():
            b_, r_, h_ = lf._level_tiles_kernel(rk, rs, k, real, lf.TILE, batched=True)
            check_equal("close_placement", glue.close_placement(b_, r_, h_, 2 * k + 1, lf.TILE),
                        glue.close_placement_plain(b_, r_, h_, 2 * k + 1, lf.TILE), tag)
        glue_d1, glue_o1 = lf.level_fused(glue_keys, glue_spl, k=k, n_real=n_real)
        glue_db, glue_ob = lf.level_fused_batched(glue_rows, glue_rows_spl, k=k, n_real=row_real)
        glue_d2, glue_o2 = lf.rank_hist(comp, tile=k2_tile, **k2_args)
        one_off = torch.full((2 * k + 2,), N_BIG, dtype=torch.int32, device=dev)
        one_off[: k + 1] = 0  # every position in bucket k
        for tag, off_, n_ in ((f"level 1 nb={2 * k + 1}", glue_o1, N_BIG),
                              (f"level 2 nb={nb2}", glue_o2, N_BIG),
                              (f"({B_BULK}, {N_ROW}) nb={2 * k + 1}", glue_ob, N_ROW),
                              (f"one bucket nb={2 * k + 1}", one_off, N_BIG)):
            check_equal("segment_ids", glue.segment_ids(off_, n_), glue.segment_ids_plain(off_, n_),
                        tag)

        def segment_splitters(rows_keys, off_, k_, seed):
            """Sorted splitters (rows, num_seg, k-1) a segment, from a sample of
            its keys, as level 2 draws them."""
            g_ = torch.Generator(device=dev).manual_seed(seed)
            B_, n_ = rows_keys.shape
            pos_ = sampling.sample_indices(g_, 4 * k_, off_[:, :-1], off_[:, 1:])
            pos_ = pos_.reshape(B_, -1).clamp_(max=n_ - 1)
            sample = torch.gather(rows_keys, 1, pos_).reshape(B_, off_.shape[1] - 1, 4 * k_)
            return sampling.select_splitters(torch.sort(sample, dim=-1).values, k_).contiguous()

        level_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        keys64_l = ops.keyspace.encode(wide_input("float64", N_BIG, seed=31))
        arrays64, off64, nb64, _ = ips4o.level_pass({"k": keys64_l}, N_BIG, k, cfg, level_gen)
        radix_l = full_range((N_BIG,), seed=23)
        arrays_r, off_r, nb_r, _ = ips4o.level_pass(
            {"k": radix_l}, N_BIG, k, ips4o.SortConfig(classifier="radix"), level_gen)
        seg_cuts = np.sort(np.random.default_rng(24).integers(0, N_BIG, SEGMENTS))
        seg_offs = torch.as_tensor(np.concatenate([[0], seg_cuts, [N_BIG]]).astype(np.int32),
                                   device=dev)[None]
        for tag, (rk, off_, ns, k_, radix_mode) in {
                f"level 2 n={N_BIG} segments={nb1} k={k2}": (arrays["k"][None], off1[None], nb1,
                                                             k2, False),
                f"level 2 ({B_BULK}, {N_ROW}) segments={nb1_b} k={k2b}": (
                    arrays_b["k"], off1_b, nb1_b, k2b, False),
                f"level 2 int64 codes n={N_BIG} segments={nb64} k={k2}": (
                    arrays64["k"][None], off64[None], nb64, k2, False),
                f"level 2 radix n={N_BIG} k={k2} consumed=7": (arrays_r["k"][None], off_r[None],
                                                              nb_r, k2, True),
                f"{SEGMENTS + 1} segments n={N_BIG} k=16": (glue_keys[None], seg_offs,
                                                            SEGMENTS + 1, 16, False),
        }.items():
            s_ = None if radix_mode else segment_splitters(rk, off_, k_, seed=ns)
            name = "composite_ids" + ("64" if rk.dtype == torch.int64 else "")
            check_equal(name, glue.composite_ids(rk, off_, ns, k_, s_, 7 if radix_mode else 0),
                        glue.composite_ids_plain(rk, off_, ns, k_, s_, 7 if radix_mode else 0), tag)
        del arrays64, keys64_l, arrays_r, radix_l

        def payload_leaves(lead, seed):
            """Leaves of 1, 2, 4, 8, 12 and 16 bytes a row."""
            g_ = torch.Generator(device=dev).manual_seed(seed)
            return {"bool": torch.rand(lead, generator=g_, device=dev) < 0.5,
                    "bfloat16": torch.randn(lead, generator=g_, device=dev).to(torch.bfloat16),
                    "int32": torch.randint(-9, 9, lead, generator=g_, device=dev,
                                           dtype=torch.int32),
                    "int64": torch.randint(-9, 9, lead, generator=g_, device=dev,
                                           dtype=torch.int64),
                    "(n, 3) float32": torch.randn(lead + (3,), generator=g_, device=dev),
                    "(n, 4) float32": torch.randn(lead + (4,), generator=g_, device=dev)}

        leaves = payload_leaves((N_BIG,), 25)
        perm_ = torch.randperm(N_BIG, generator=gen, device=dev).to(torch.int32)

        def one_g4_launch(name, call, what):
            """A G4 call that moves every tensor of its arrays in one launch."""
            before = kernels.launch_counts()[name]
            got = call()
            if kernels.launch_counts()[name] != before + 1:
                fail(f"{name} made {kernels.launch_counts()[name] - before} launches on {what}")
            return got

        for tag, dest_, off_ in (("level 1 placement", glue_d1, glue_o1),
                                 ("level 2 placement", glue_d2, glue_o2),
                                 ("a permutation", perm_, None)):
            what = f"{tag} n={N_BIG}, {len(leaves)} tensors of 1-16 B rows in one launch"
            check_equal("scatter_rows", moved_bits(torch, one_g4_launch(
                "scatter_rows", lambda: glue.scatter_rows(leaves, dest_, off_), what)),
                        moved_bits(torch, glue.scatter_rows_plain(leaves, dest_)), what)
        rows_leaves = payload_leaves((B_BULK, N_ROW), 26)
        what = f"({B_BULK}, {N_ROW}) level 1 placement, {len(rows_leaves)} tensors in one launch"
        check_equal("scatter_rows", moved_bits(torch, one_g4_launch(
            "scatter_rows", lambda: glue.scatter_rows(rows_leaves, glue_db, glue_ob), what)),
                    moved_bits(torch, glue.scatter_rows_plain(rows_leaves, glue_db)), what)
        del perm_
        W_g, wperm = cfg.base_case, bitonic.sort_windows(wb, wk, nb=64)[0]
        one_row = {name_: leaf[None] for name_, leaf in leaves.items()}
        what = f"{len(one_row)} tensors, 2048 windows of {W_g}, new tensors, one launch"
        check_equal("gather_windows", moved_bits(torch, one_g4_launch(
            "gather_windows", lambda: glue.gather_windows(one_row, wperm, 0), what)),
                    moved_bits(torch, {n_: glue.gather_windows_plain(a_, wperm, 0)
                                       for n_, a_ in one_row.items()}), what)
        inplace = {n_: a_.clone() for n_, a_ in one_row.items()}
        what = f"{len(one_row)} tensors, 2047 windows at {W_g // 2}, in place, one launch"
        one_g4_launch("gather_windows",
                      lambda: glue.gather_windows(inplace, wperm[:-1], W_g // 2, inplace), what)
        check_equal("gather_windows", moved_bits(torch, inplace), moved_bits(torch, {
            n_: glue.gather_windows_plain(a_, wperm[:-1], W_g // 2, a_.clone())
            for n_, a_ in one_row.items()}), what)
        # B rows with a limit: pass one over [0, limit) into copies, pass two
        # at W/2 in place, as base_case_windows runs them for a top-k
        limit_g = N_ROW // 2
        for lo_, per_ in ((0, limit_g // W_g), (W_g // 2, limit_g // W_g - 1)):
            perm_b = torch.argsort(torch.rand((B_BULK * per_, W_g), generator=gen, device=dev),
                                   dim=1).to(torch.int32)
            want_b = {n_: glue.gather_windows_plain(a_, perm_b, lo_, a_.clone())
                      for n_, a_ in rows_leaves.items()}
            got_b = {n_: a_.clone() for n_, a_ in rows_leaves.items()}
            what = (f"({B_BULK}, {N_ROW}) {len(got_b)} tensors, {per_} windows a row at {lo_}, "
                    f"limit {limit_g}, {'in place' if lo_ else 'into copies'}, one launch")
            one_g4_launch("gather_windows", lambda: glue.gather_windows(
                got_b if lo_ else rows_leaves, perm_b, lo_, got_b), what)
            check_equal("gather_windows", moved_bits(torch, got_b), moved_bits(torch, want_b),
                        what)
        del leaves, inplace, one_row, rows_leaves, got_b, want_b, perm_b

        # ---- G5-G7 (csrc/codec.cu, G6 in csrc/glue.cu, csrc/fallback.cu)
        # against their plain twins, bit for bit.  G5: the twelve key dtypes
        # (random bits, NaN, -NaN, +-0.0, +-inf, a subnormal) at 2^20 + 3 keys,
        # padded with and without the index and the complement, one row and
        # (64, 2^14) rows, and the main path's 2^24 float32 with its index;
        # each decode of the first n codes.  G6: level 1 at the main path's
        # (1, 2^24), m = 512, k = 128 with the upper form, batched (64, 2^18),
        # m = 384, int64 codes; level 2 over the real level-1 offsets (257
        # segments, m = 512, k = 128; batched m = 6, k = 2) and over crafted
        # ones (empty segments, an empty last one, a uniform just below 1).
        # G7: the main path's real buckets after both levels (1-D, batched,
        # double), and crafted offsets: one bucket a whole row of 2^24, buckets
        # of W/2+1, C-1, C, C+1 and 3C+5 keys (W = 256), equal keys, rows of
        # other counts, ``limit``, no bucket over W/2; int32 and int64 codes;
        # keys, an int32 index and payload rows moved; two launches a call.
        from repro_torch.kernels import codec, fallback

        SIGNED = {w: getattr(torch, name_) for w, name_ in SIGNED_NAMES.items()}

        def raw_keys(dtype, shape, seed):
            width = torch.empty(0, dtype=dtype).element_size()
            g_ = torch.Generator(device=dev).manual_seed(seed)
            raw = torch.randint(-2**62, 2**62, shape, generator=g_, device=dev).to(SIGNED[width])
            x_ = raw.view(dtype)
            if dtype.is_floating_point:
                sp = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0, float("inf"),
                                   -float("inf"), torch.finfo(dtype).tiny / 2])
                x_.view(-1)[:len(sp)] = sp.to(dtype).to(dev)
            return x_

        def bits(t):
            return t.to(torch.uint8) if t.dtype == torch.bool else t.view(SIGNED[t.element_size()])

        n5 = (1 << 20) + 3
        for dt in (getattr(torch, name_) for name_ in TAIL_DTYPES):
            for shape, n_pad in (((n5,), None), ((n5,), 1 << 21), ((B_BULK, 1 << 14), 1 << 15)):
                x_ = raw_keys(dt, shape, seed=len(shape))
                for index, comp_ in ((False, False), (True, False), (True, True)):
                    got = codec.encode_padded(x_, n_pad, index, comp_)
                    want = codec.encode_padded_plain(x_, n_pad, index, comp_)
                    tag = f"{dt} {shape} n_pad={n_pad} index={index} complement={comp_}"
                    check_equal("codec_encode", got[:1 + index], want[:1 + index], tag)
                    check_equal("codec_decode", bits(codec.decode(got[0], dt, shape[-1], comp_)),
                                bits(codec.decode_plain(want[0], dt, shape[-1], comp_)), tag)
        x_main5 = torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=27), device=dev)
        got = codec.encode_padded(x_main5, N_BIG, True)
        check_equal("codec_encode", got, codec.encode_padded_plain(x_main5, N_BIG, True),
                    f"float32 n={N_BIG} with the index (argsort's)")
        sorted5 = torch.sort(got[0]).values
        check_equal("codec_decode", bits(codec.decode(sorted5, torch.float32)),
                    bits(codec.decode_plain(sorted5, torch.float32)), f"float32 n={N_BIG}")
        del x_main5, sorted5

        k1_b = levels_b[0]
        m1_b = ips4o._level1_sample_size(N_ROW, k1_b, cfg)
        keys64_6 = ops.keyspace.encode(wide_input("float64", 1 << 22, seed=32))[None]
        for tag, (rk, m_, k_) in {
                f"level 1 (1, {N_BIG}) m=512 k={k}": (glue_keys[None], 512, k),
                f"level 1 ({B_BULK}, {N_ROW}) m={m1_b} k={k1_b}": (glue_rows, m1_b, k1_b),
                f"level 1 int64 codes (1, {1 << 22}) m=8192 k=256": (keys64_6, 8192, 256),
        }.items():
            pos6 = torch.randint(0, rk.shape[1], (rk.shape[0], m_), generator=gen, device=dev)
            check_equal("sample_splitters", glue.sample_splitters(rk, pos6, k_, upper=True),
                        glue.sample_splitters_plain(rk, pos6, k_, upper=True), tag)
        crafted6 = torch.tensor([[0, 0, 1000, 1000, 5000, 1 << 22, 1 << 22]], dtype=torch.int32,
                                device=dev)
        m2_b = min(max(sampling.oversampling_factor(N_ROW) * k2b, k2b), 2048)
        for tag, (rk, off_, m_, k_) in {
                f"level 2 (1, {N_BIG}) {nb1} segments m=512 k={k2}": (
                    arrays["k"][None], off1[None], 512, k2),
                f"level 2 ({B_BULK}, {N_ROW}) {nb1_b} segments m={m2_b} k={k2b}": (
                    arrays_b["k"], off1_b, m2_b, k2b),
                "level 2 int64 codes, empty segments, an empty last one": (
                    keys64_6, crafted6, 100, 16),
        }.items():
            u6 = torch.rand((rk.shape[0], off_.shape[1] - 1, m_), generator=gen, device=dev)
            u6[..., 0] = 0.99999994  # the largest float32 below 1
            check_equal("sample_splitters", glue.sample_splitters(rk, u6, k_, seg_offsets=off_),
                        glue.sample_splitters_plain(rk, u6, k_, seg_offsets=off_), tag)
        del keys64_6, pos6, u6

        def fallback_check(tag, arrays_, off_, nb_, W_, pad_, limit_=None):
            """G7's two launches against the plain twin on copies of arrays_,
            and on the keys alone (the kernel that merges the keys)."""
            lead = arrays_["k"].dim()
            fb_ = glue.segment_ids(off_, arrays_["k"].shape[-1])
            for what, names in (("", list(arrays_)), (", the keys alone", ["k"])):
                a1 = {name_: arrays_[name_].clone() for name_ in names}
                a2 = {name_: arrays_[name_].clone() for name_ in names}
                before = (kernels.launch_counts()["fallback_list"],
                          kernels.launch_counts()["fallback_sort"])
                meta_ = fallback.oversized_list(off_, nb_, W_, pad_, limit_,
                                                arrays_["k"].shape[-1])
                fallback.sort_listed(a1, meta_, lead)
                after = (kernels.launch_counts()["fallback_list"],
                         kernels.launch_counts()["fallback_sort"])
                if (after[0] - before[0], after[1] - before[1]) != (1, 1):
                    fail(f"fallback on {tag}: {after} launches after {before}, not one of each")
                fallback.sort_oversized_plain(a2, fb_, off_, nb_, W_, pad_, limit_)
                check_equal("fallback_sort", moved_bits(torch, a1), moved_bits(torch, a2),
                            tag + what)
            summary = meta_[:4].tolist()
            rows_ = off_.numel() // (nb_ + 1)
            head = 4 + (rows_ + 1) + 2 * rows_  # the summary and the rows' words
            plain_meta = fallback.oversized_list_plain(off_.cpu(), nb_, W_, pad_, limit_,
                                                       arrays_["k"].shape[-1])
            check_equal("fallback_list", meta_[:head].cpu(), plain_meta[:head],
                        f"{tag}: {summary[1]} buckets listed, the largest {summary[2]}, "
                        f"{summary[3]} chunks")
            return summary

        idx5 = torch.arange(N_BIG, dtype=torch.int32, device=dev)
        a7, o7, nb7, pad7 = ips4o.partition_passes({"k": glue_keys, "v": idx5}, n_real, cfg,
                                                   levels)
        fallback_check(f"the main path's buckets n={N_BIG}", a7, o7, nb7, cfg.base_case, pad7)
        fallback_check(f"the main path's buckets n={N_BIG}, limit 9216", a7, o7, nb7,
                       cfg.base_case, pad7, 9216)
        a7, o7, nb7, pad7 = ips4o.batched_partition_passes(
            {"k": glue_rows, "v": torch.arange(N_ROW, dtype=torch.int32, device=dev).expand(
                B_BULK, N_ROW).contiguous()}, row_real, cfg, levels_b)
        fallback_check(f"the main path's buckets ({B_BULK}, {N_ROW})", a7, o7, nb7,
                       cfg.base_case, pad7)
        keys64_7 = ops.keyspace.encode(wide_input("float64", N_BIG, seed=33))
        a7, o7, nb7, pad7 = ips4o.partition_passes({"k": keys64_7, "v": idx5}, N_BIG, cfg, levels)
        fallback_check(f"double's buckets n={N_BIG}", a7, o7, nb7, cfg.base_case, pad7)
        del a7, o7, keys64_7

        def crafted_offsets(sizes, n_):
            offs_ = [np.append(np.concatenate([[0], np.cumsum(s)]), n_) for s in sizes]
            nb_ = max(len(o) for o in offs_) - 1
            return torch.as_tensor(np.stack([np.append(o, [n_] * (nb_ + 1 - len(o)))
                                             for o in offs_]).astype(np.int32), device=dev), nb_

        C7 = fallback.CHUNK
        for key_dtype in (torch.int32, torch.int64):
            for tag, (sizes, n_, W_, limit_) in {
                    f"one bucket holding the whole row of {N_BIG}": ([[N_BIG]], N_BIG, 8192, None),
                    "buckets of W/2+1, C-1, C, C+1 and 3C+5 keys (W 256)": (
                        [[129, 1, C7 - 1, 1, C7, 1, C7 + 1, 1, 3 * C7 + 5]], 1 << 16, 256, None),
                    "the same, limit 4000": ([[129, 1, C7 - 1, 1, C7, 1, C7 + 1, 1, 3 * C7 + 5]],
                                             1 << 16, 256, 4000),
                    "rows of other counts, equal keys": ([[5000, 1, 300], [10, 20], [4097]],
                                                         1 << 14, 8192, None),
                    "no bucket over W/2 (an empty list)": ([[100, 200, 300, 400]], 1000, 8192,
                                                           None),
            }.items():
                off_, nb_ = crafted_offsets(sizes, n_)
                B_ = off_.shape[0]
                keys_ = torch.randint(-2**31, 2**31, (B_, n_), generator=gen, device=dev).to(
                    key_dtype)
                if "equal" in tag:
                    keys_[:] = 7
                arrays_ = {"k": keys_, "v": torch.arange(B_ * n_, dtype=torch.int32,
                                                         device=dev).reshape(B_, n_)}
                if n_ < N_BIG:
                    arrays_.update(payload_leaves((B_, n_), 28))
                fallback_check(f"{tag}, {key_dtype}", arrays_, off_, nb_, W_, None, limit_)
        del arrays_, keys_

        # ---- the 64-bit forms (the 64-bit key dtypes' int64 codes) against
        # their plain twins: K1 on float64 Uniform and int64 TwoDup, K1r on
        # int64 and uint64 over the whole range (level 1 and a level-2
        # shift), K4 level_fused_batched in both modes, K3 at W = 8192, 256
        # and 16384 with heavy duplicates at the int64 extremes
        for dist in ("float64", "int64 TwoDup"):
            keys64 = ops.keyspace.encode(wide_input(dist, n_real, seed=31))
            keys64 = ips4o.pad_with_sentinel({"k": keys64}, N_BIG)["k"]
            pos = torch.randint(0, n_real, (4 * k,), generator=gen, device=dev)
            spl64 = sampling.select_splitters(torch.sort(keys64[pos]).values, k)
            check_equal("level_fused64", (
                lf._level_tiles_kernel(keys64[None], spl64[None], k, n_real, lf.TILE),
                lf.level_fused(keys64, spl64, k=k, n_real=n_real)), (
                lf._level_tiles_plain(keys64[None], spl64[None], k, n_real, lf.TILE),
                lf.level_fused_plain(keys64, spl64, k=k, n_real=n_real)),
                f"{dist} n={N_BIG} n_real={n_real} k={k}")
        for dist in ("int64", "uint64"):
            keys64 = ops.keyspace.encode(wide_input(dist, N_BIG, seed=32))
            keys64[n_real:] = torch.iinfo(torch.int64).max
            for consumed in (0, 7):
                kw = dict(k=k, n_real=n_real, classifier="radix", consumed_bits=consumed)
                check_equal("level_fused_radix64", (
                    lf._level_tiles_kernel(keys64[None], None, k, n_real, lf.TILE, consumed),
                    lf.level_fused(keys64, **kw)), (
                    lf._level_tiles_plain(keys64[None], None, k, n_real, lf.TILE, consumed),
                    lf.level_fused_plain(keys64, **kw)),
                    f"{dist} full range n={N_BIG} n_real={n_real} k={k} consumed={consumed}")
        kb64 = ops.keyspace.encode(wide_input("float64", B_BULK * N_ROW, seed=33)).view(
            B_BULK, N_ROW)
        kb64 = ips4o.batched_pad_with_sentinel({"k": kb64[:, :row_real].contiguous()}, N_ROW)["k"]
        pos = torch.randint(0, row_real, (B_BULK, 4 * k), generator=gen, device=dev)
        spl_b64 = sampling.select_splitters(torch.sort(torch.gather(kb64, 1, pos), dim=1).values, k)
        for mode, s in (("tree", spl_b64), ("radix", None)):
            kw = dict(k=k, n_real=row_real, classifier=mode)
            check_equal("level_fused_batched64",
                        (lf._level_tiles_kernel(kb64, s, k, row_real, lf.TILE, batched=True),
                         lf.level_fused_batched(kb64, s, **kw)),
                        (lf._level_tiles_plain(kb64, s, k, row_real, lf.TILE),
                         lf.level_fused_batched_plain(kb64, s, **kw)),
                        f"float64 {mode} ({B_BULK}, {N_ROW}) n_real={row_real} k={k}")
        wide_windows = {}
        for W_, num_w_ in ((cfg.base_case, 2048), (256, 1 << 16), (bitonic.MAX_W, 1024)):
            wb64 = torch.sort(torch.randint(0, 64, (num_w_, W_), generator=gen, device=dev,
                                            dtype=torch.int32), dim=1).values
            wk64 = torch.randint(-3, 4, (num_w_, W_), generator=gen, device=dev,
                                 dtype=torch.int64)
            wk64[: num_w_ // 3] += torch.iinfo(torch.int64).max - 3  # the extremes, duplicated
            wk64[num_w_ // 3: 2 * num_w_ // 3] -= torch.iinfo(torch.int64).max - 3
            wide_windows[W_] = (wb64, wk64)
            check_equal("sort_windows64", bitonic.sort_windows(wb64, wk64, nb=64),
                        bitonic.sort_windows_plain(wb64, wk64, nb=64),
                        f"{num_w_} x {W_} int64 duplicate-heavy")
        for log2w in range(1, bitonic.MAX_W.bit_length()):  # every W, a partial last CTA
            W_ = 1 << log2w
            wb64 = torch.randint(0, 64, (2049, W_), generator=gen, device=dev, dtype=torch.int32)
            wk64 = torch.randint(-3, 4, (2049, W_), generator=gen, device=dev, dtype=torch.int64)
            wk64[::2] += torch.iinfo(torch.int64).max - 3
            wb64[1::3] = torch.sort(wb64[1::3], dim=1, descending=True).values
            wk64[1::3] = torch.sort(wk64[1::3], dim=1, descending=True).values
            check_equal("sort_windows64", bitonic.sort_windows(wb64, wk64, nb=64),
                        bitonic.sort_windows_plain(wb64, wk64, nb=64),
                        f"2049 x {W_} int64, a third descending")
        del wb64, wk64
        del keys64, kb64

        # K5 on two duplicate-heavy runs of 2^24 (the keys of each run repeat
        # ~8,400 times and every value occurs in both), NaN codes at the tails,
        # and at ragged sizes; the yardstick checks the permutation itself
        def sorted_run(n, lo, hi):
            run = torch.sort(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                           dtype=torch.int32)).values
            run[-max(1, n // 1000):] = torch.iinfo(torch.int32).max
            return run

        merge_a, merge_b = sorted_run(N_BIG, -1000, 1000), sorted_run(N_BIG, -1000, 1000)
        for a, b in ((merge_a, merge_b), (sorted_run(1_000_003, -50, 50), sorted_run(77, -50, 50)),
                     (sorted_run(1000, 0, 10), merge_b[:0])):
            got = mp.merge_path_perm(a, b)
            check_equal("merge_path", got, mp.merge_path_perm_plain(a, b),
                        f"{a.shape[0]} + {b.shape[0]}")
            if not torch.equal(got.to(torch.int64), torch.sort(torch.cat([a, b]), stable=True).indices):
                fail("K5 is not the stable merge permutation")

        # K6: dispatch_ranks on the MoE routing (uniform, then half on one expert),
        # partition_ranks with trash ids and non-prefix starts, the batched form
        def counts_prefix(ids, nb):
            counts = torch.bincount(ids.reshape(-1), minlength=nb)[:nb].to(torch.int32)
            return torch.cumsum(counts, 0, dtype=torch.int32) - counts

        n_moe = MOE_TOKENS * MOE_TOP
        moe_uniform = torch.randint(0, MOE_EXPERTS, (n_moe,), generator=gen, device=dev,
                                    dtype=torch.int32)
        moe_skewed = moe_uniform.clone()
        moe_skewed[torch.rand(n_moe, generator=gen, device=dev) < 0.5] = 7
        for tag, ids in (("uniform", moe_uniform), ("skewed", moe_skewed)):
            start = counts_prefix(ids, MOE_EXPERTS)
            got = dr.dispatch_ranks(ids, start, num_experts=MOE_EXPERTS)
            check_equal("dispatch_ranks", got,
                        dr.dispatch_ranks_plain(ids, start, num_experts=MOE_EXPERTS),
                        f"{tag} {MOE_TOKENS} tokens x top-{MOE_TOP} over {MOE_EXPERTS} experts")
            if not torch.equal(got[torch.sort(ids, stable=True).indices].to(torch.int64),
                               torch.arange(n_moe, device=dev)):
                fail("K6 dispatch_ranks is not the inverse of the stable argsort")
        part_ids = torch.randint(0, NB_PART + 1, (N_BIG,), generator=gen, device=dev,
                                 dtype=torch.int32)  # NB_PART is the trash id
        part_start = torch.randint(0, 1 << 24, (NB_PART,), generator=gen, device=dev,
                                   dtype=torch.int32)
        check_equal("partition_ranks", dr.partition_ranks(part_ids, part_start, nb=NB_PART),
                    dr.partition_ranks_plain(part_ids, part_start, nb=NB_PART),
                    f"n={N_BIG} nb={NB_PART} non-prefix starts, trash ids")
        rows_ids = torch.randint(0, NB_PART, (B_BULK, N_ROW), generator=gen, device=dev,
                                 dtype=torch.int32)
        rows_start = torch.stack([counts_prefix(r, NB_PART) for r in rows_ids])
        got = dr.partition_ranks_batched(rows_ids, rows_start, nb=NB_PART)
        check_equal("partition_ranks_batched", got,
                    dr.partition_ranks_batched_plain(rows_ids, rows_start, nb=NB_PART),
                    f"({B_BULK}, {N_ROW}) nb={NB_PART}")
        if not torch.equal(torch.gather(got, 1, torch.sort(rows_ids, dim=1, stable=True).indices)
                           .to(torch.int64), torch.arange(N_ROW, device=dev).expand(B_BULK, N_ROW)):
            fail("K6 partition_ranks_batched is not the inverse of the per-row stable argsort")

        # K7 in tree mode on raw keys: float32 Uniform with NaN, +-0.0, +-inf and
        # finfo.max sprinkled in, int32 TwoDup and bfloat16 normals with the same
        # specials, at k = 128 against a sorted sample's splitters; per-row
        # splitters at (64, 2^18); radix mode at k = 256 on full-range codes
        def raw_specials(x):
            x[::1009] = float("nan")
            x[1::1013] = -0.0
            x[2::1019] = 0.0
            x[3::1021] = float("inf")
            x[4::1031] = float("-inf")
            x[5::1033] = torch.finfo(x.dtype).max
            return x

        def sample_splitters(x, k_):
            pos = torch.randint(0, x.shape[-1], x.shape[:-1] + (4 * k_,), generator=gen, device=dev)
            sample = torch.gather(x, -1, pos) if x.dim() == 2 else x[pos]
            return sampling.select_splitters(torch.sort(sample, dim=-1).values, k_).contiguous()

        k7_in = {
            "float32 Uniform+specials": raw_specials(torch.as_tensor(
                make_input("Uniform", N_BIG, np.float32, seed=15), device=dev)),
            "int32 TwoDup": torch.as_tensor(make_input("TwoDup", N_BIG, np.int32, seed=16),
                                            device=dev),
            "bfloat16 normal+specials": raw_specials(
                torch.randn(N_BIG, generator=gen, device=dev).to(torch.bfloat16)),
        }
        k7_spl = {tag: sample_splitters(x, k) for tag, x in k7_in.items()}
        k7_want = {}
        for tag, x in k7_in.items():
            k7_want[tag] = cl.classify_histogram_plain(x, k7_spl[tag], k=k)
            check_equal("classify_histogram", cl.classify_histogram(x, k7_spl[tag], k=k),
                        k7_want[tag], f"{tag} n={N_BIG} k={k}")
        k7_rows = raw_specials(torch.randn((B_BULK, N_ROW), generator=gen, device=dev))
        k7_rows_spl = sample_splitters(k7_rows, k)
        k7_want["batched"] = cl.classify_histogram_batched_plain(k7_rows, k7_rows_spl, k=k)
        check_equal("classify_histogram_batched",
                    cl.classify_histogram_batched(k7_rows, k7_rows_spl, k=k), k7_want["batched"],
                    f"({B_BULK}, {N_ROW}) per-row splitters k={k}")
        # skewed float32 keys (the histogram's one-slot warps and run merging):
        # all one value, all equal to a splitter, 70% NaN, already sorted, Zipf
        k7_skews = {"all equal": torch.full((N_BIG,), 0.25, device=dev)}
        k7_skews["one splitter"] = k7_spl["float32 Uniform+specials"][k // 2].expand(
            N_BIG).contiguous()
        nan_heavy = k7_in["float32 Uniform+specials"].clone()
        nan_heavy[torch.rand(N_BIG, generator=gen, device=dev) < 0.7] = float("nan")
        k7_skews["NaN-heavy"] = nan_heavy
        k7_skews["sorted"] = torch.sort(k7_in["float32 Uniform+specials"]).values
        k7_skews["zipf"] = torch.as_tensor(_zipf_keys(np, N_BIG, seed=19), device=dev)
        for tag, x in k7_skews.items():
            check_equal("classify_histogram", cl.classify_histogram(
                x, k7_spl["float32 Uniform+specials"], k=k), cl.classify_histogram_plain(
                x, k7_spl["float32 Uniform+specials"], k=k), f"float32 {tag} n={N_BIG} k={k}")
        radix7 = full_range((N_BIG,), seed=17)
        radix7[::1009] = torch.iinfo(torch.int32).max  # the NaN / pad code
        for consumed in (0, 8):
            k7_want[f"radix {consumed}"] = cl.radix_histogram_plain(radix7, k=K_RADIX,
                                                                    consumed_bits=consumed)
            check_equal("radix_histogram", cl.radix_histogram(radix7, k=K_RADIX,
                                                              consumed_bits=consumed),
                        k7_want[f"radix {consumed}"],
                        f"n={N_BIG} full range k={K_RADIX} consumed={consumed}")
        radix7_rows = full_range((B_BULK, N_ROW), seed=18)
        k7_want["radix batched"] = cl.radix_histogram_batched_plain(radix7_rows, k=K_RADIX)
        check_equal("radix_histogram", cl.radix_histogram_batched(radix7_rows, k=K_RADIX),
                    k7_want["radix batched"], f"batched ({B_BULK}, {N_ROW}) k={K_RADIX}")

        # K8 and K9 at 2^28 int32 keys (1 GiB, N = 262,144 blocks of 1024), block
        # buckets uniform over 256 and with half the blocks in one bucket; K8
        # with a partial tail of 1000 keys.  In place: the same data_ptr, and a
        # peak-memory rise of at most a quarter of the data during the call
        def rise(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn()
            torch.cuda.synchronize()
            return out, torch.cuda.max_memory_allocated() - base

        def in_place(name, got, ptr, peak, nbytes):
            same = got.data_ptr() == ptr
            print(f"{name} in place: data_ptr {'same' if same else 'NEW'}, peak rise {peak} B "
                  f"({peak / nbytes:.6f} of the {nbytes} B of data)", flush=True)
            if not same or peak > 0.25 * nbytes:
                fail(f"{name} is not in place")

        def prefix(bb):
            d = torch.zeros(N_BUCKETS + 1, dtype=torch.int32, device=dev)
            d[1:] = torch.cumsum(torch.bincount(bb, minlength=N_BUCKETS), 0)
            return d

        nblocks = N_BLOCK_KEYS // BLOCK
        bb_uniform = torch.randint(0, N_BUCKETS, (nblocks,), generator=gen, device=dev,
                                   dtype=torch.int32)
        bb_skewed = bb_uniform.clone()
        bb_skewed[torch.rand(nblocks, generator=gen, device=dev) < 0.5] = 7
        block_cases = (("uniform", bb_uniform), ("half in one bucket", bb_skewed))
        blocks8 = torch.randint(-2**31, 2**31 - 1, (N_BLOCK_KEYS + 1000,), generator=gen,
                                device=dev, dtype=torch.int32)
        one_cycle = ((torch.arange(nblocks, device=dev) + 1) % nblocks).to(torch.int32)
        # blocks of 16 KB: the same keys as N / 4 blocks of 4 * BLOCK, taken by
        # a CTA team of 4 warps instead of one warp
        nblocks16 = N_BLOCK_KEYS // BLOCK16
        bb16 = torch.randint(0, N_BUCKETS, (nblocks16,), generator=gen, device=dev,
                             dtype=torch.int32)
        for tag, dst, be in [(tag, bp.stable_block_dest(bb), BLOCK) for tag, bb in block_cases] + [
                ("one cycle through every block", one_cycle, BLOCK),
                ("uniform, 16 KB blocks", bp.stable_block_dest(bb16), BLOCK16)]:
            want = bp.permute_blocks_by_dest_plain(blocks8.clone(), dst, block_elems=be)
            ptr = blocks8.data_ptr()
            got, peak = rise(lambda: bp.permute_blocks_by_dest(blocks8, dst, block_elems=be))
            in_place("permute_blocks_by_dest", got, ptr, peak, blocks8.numel() * 4)
            check_equal("permute_blocks_by_dest", got, want,
                        f"{tag} n={blocks8.numel()} ({dst.numel()} blocks of {be} + "
                        f"{blocks8.numel() % be})")
            del want, got
        for be in (BLOCK, BLOCK16):
            info = bp.launch_info(N_BLOCK_KEYS // be, be * 4)
            print(f"permute_blocks_by_dest launch, blocks of {be * 4} B (team "
                  f"{bp.team_shape(be * 4)} warps x words a lane): {info}", flush=True)

        # K9: every block tagged by its source (block i holds i*1024 + [0, 1024)),
        # so the output shows intact blocks and, per bucket, the multiset of
        # its blocks.  K9 is not stable: its order within a bucket follows how
        # its CTAs interleave, so it is held to the plain twin (the replay of
        # the reference's order) after sorting each bucket range's blocks by
        # their tag, and to permute_blocks_ref by the per-bucket multisets
        def tagged(n):
            return torch.arange(n, device=dev, dtype=torch.int32)

        def k9_canonical(x, d, n_blocks):
            """Each bucket range's blocks sorted by their tag."""
            blocks = x.view(n_blocks, -1)
            slots = torch.arange(n_blocks, device=dev, dtype=torch.int32)
            slot_bucket = (torch.searchsorted(d, slots, right=True) - 1).to(torch.int64)
            return blocks[torch.argsort((slot_bucket << 32) | blocks[:, 0].to(torch.int64))]

        def k9_check(bb, d, n_blocks, k9, what, runs=1):
            """``runs`` calls of K9 on tagged blocks: in place, intact, and
            per bucket the twin's blocks.  Returns the twin's canonical form."""
            keys9 = tagged(n_blocks * BLOCK)
            want = k9_canonical(pi.permute_blocks_inplace_plain(keys9.clone(), bb, d, k=k9),
                                d, n_blocks)
            for _ in range(runs):
                keys9 = tagged(n_blocks * BLOCK)
                ptr = keys9.data_ptr()
                got, peak = rise(lambda: pi.permute_blocks_inplace(keys9, bb, d, k=k9))
                in_place("permute_blocks_inplace", got, ptr, peak, keys9.numel() * 4)
                blocks = got.view(n_blocks, BLOCK)
                intact = torch.equal(blocks - blocks[:, :1], tagged(BLOCK).expand(n_blocks, BLOCK))
                if not intact:
                    fail(f"K9 broke a block ({what})")
                check_equal("permute_blocks_inplace", k9_canonical(got, d, n_blocks), want,
                            f"{what}: per-bucket blocks against the twin")
            return want

        k9_want = {}
        for tag, bb in block_cases:
            d9 = prefix(bb)
            k9_want[tag] = k9_check(bb, d9, nblocks, N_BUCKETS, f"{tag} N={nblocks}")
            canon = kref.permute_blocks_ref(tagged(N_BLOCK_KEYS), bb, k=N_BUCKETS, block_elems=BLOCK)
            same_sets = torch.equal(k9_want[tag], k9_canonical(canon, d9, nblocks))
            print(f"permute_blocks_inplace {tag} N={nblocks}: the twin's per-bucket block "
                  f"multisets equal to permute_blocks_ref {same_sets}", flush=True)
            if not same_sets:
                fail(f"K9's twin lost or misplaced blocks ({tag})")
            del canon
        # the claiming under stress, at N = 4096, each case several times in a row
        n_small = 4096
        uniform_small = torch.randint(0, N_BUCKETS, (n_small,), generator=gen, device=dev,
                                      dtype=torch.int32)
        all_but_one = torch.full((n_small,), N_BUCKETS // 2, device=dev, dtype=torch.int32)
        all_but_one[n_small // 3] = N_BUCKETS - 1
        stress = {
            "k=1": (torch.zeros(n_small, device=dev, dtype=torch.int32), 1),
            "every block in its range": (torch.sort(uniform_small).values, N_BUCKETS),
            "empty buckets (every fourth used)": (uniform_small // 4 * 4, N_BUCKETS),
            "all blocks but one in one bucket": (all_but_one, N_BUCKETS),
            "uniform": (uniform_small, N_BUCKETS),
        }
        for tag, (bb, k9) in stress.items():
            d9 = torch.zeros(k9 + 1, dtype=torch.int32, device=dev)
            d9[1:] = torch.cumsum(torch.bincount(bb, minlength=k9), 0)
            k9_check(bb, d9, n_small, k9, f"{tag} N={n_small} k={k9}, 5 runs", runs=5)
        del blocks8

        # ---- 3. the paths ---------------------------------------------------------
        def specials(x):
            x[..., 3::3] *= -1
            x[..., ::1009] = np.nan
            x[..., 1::1013] = -0.0
            x[..., 2::1019] = 0.0
            return x

        def main_input(dist, n):
            if dist == "Uniform":
                return torch.as_tensor(specials(make_input("Uniform", n, np.float32, seed=5)),
                                       device=dev)
            return torch.as_tensor(make_input("TwoDup", n, np.int32, seed=5), device=dev)

        def yardstick(x):
            """Stable sort of the encoded keys (per row for 2-D x)."""
            enc = ops.keyspace.encode(x)
            out = torch.sort(enc, dim=-1, stable=True)
            return ops.keyspace.decode(out.values, x.dtype), out.indices

        def same_keys(a, b):
            return torch.equal(a.view(torch.int32), b.view(torch.int32))

        sched_cfg = ips4o.SortConfig(base_case=256, tile=256, max_sample=256, kmax=64)
        radix = "radix"
        bulk = torch.as_tensor(specials(make_input("Uniform", B_BULK * N_ROW, np.float32, seed=6))
                               .reshape(B_BULK, N_ROW), device=dev)
        sched = torch.as_tensor(make_input("Uniform", B_SCHED * N_SCHED, np.int32, seed=7)
                                .reshape(B_SCHED, N_SCHED), device=dev)
        bulk_radix = full_range((B_BULK, N_ROW), seed=8)
        radix_int = full_range((N_BIG,), seed=9)
        radix_float = torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=10), device=dev)

        # (name, x, the call, the kernels of its path); 1-D and batched sorts and
        # argsorts, and the batched top/bottom-k
        def sort_cases(tag, x, call_sort, call_argsort):
            return [(f"{tag} sort", x, call_sort, "sort"),
                    (f"{tag} argsort", x, call_argsort, "argsort")]

        paths = {
            "1-D tree": (("level_fused", "rank_hist", "sort_windows") + GLUE_LAUNCHES
                         + TAIL_LAUNCHES + ("sample_splitters", "codec_decode"), [
                c for n in (N_BIG, N_SMALL) for dist in ("Uniform", "TwoDup")
                for c in sort_cases(f"{dist} n={n}", main_input(dist, n), ops.sort, ops.argsort)
            ]),
            "1-D radix": (("level_fused_radix", "rank_hist", "sort_windows") + GLUE_LAUNCHES
                          + TAIL_LAUNCHES + ("codec_decode",), [
                c for tag, x in ((f"int32 full range n={N_BIG}", radix_int),
                                 (f"float32 Uniform n={N_BIG}", radix_float))
                for c in sort_cases(tag, x, lambda x: ops.sort(x, classifier=radix),
                                    lambda x: ops.argsort(x, classifier=radix))
            ]),
            "batched tree": (("level_fused_batched", "rank_hist_batched", "sort_windows")
                             + GLUE_LAUNCHES + TAIL_LAUNCHES
                             + ("sample_splitters", "codec_decode"), [
                *sort_cases(f"bulk ({B_BULK}, {N_ROW})", bulk, ops.batched_sort,
                            ops.batched_argsort),
                (f"bulk ({B_BULK}, {N_ROW}) topk k={TOP_K}", bulk,
                 lambda x: ops.batched_topk(x, TOP_K), "topk"),
                (f"bulk ({B_BULK}, {N_ROW}) bottomk k={TOP_K}", bulk,
                 lambda x: ops.batched_bottomk(x, TOP_K), "bottomk"),
                *sort_cases(f"scheduler ({B_SCHED}, {N_SCHED})", sched,
                            lambda x: ops.batched_sort(x, cfg=sched_cfg),
                            lambda x: ops.batched_argsort(x, cfg=sched_cfg)),
            ]),
            "batched radix": (("level_fused_batched", "rank_hist_batched", "sort_windows")
                              + GLUE_LAUNCHES + TAIL_LAUNCHES, [
                *sort_cases(f"int32 full range ({B_BULK}, {N_ROW})", bulk_radix,
                            lambda x: ops.batched_sort(x, classifier=radix),
                            lambda x: ops.batched_argsort(x, classifier=radix)),
            ]),
        }
        torch.cuda.synchronize()
        total_launches = {name: 0 for name in kernels.launch_counts()}
        for path, (needed, cases) in paths.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            results = [call(x) for _, x, call, _ in cases]
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            print(f"path {path} launches: {launches}", flush=True)
            for (name, x, _, kind_), got in zip(cases, results):
                want_keys, want_order = yardstick(x)
                if kind_ == "sort":
                    ok = same_keys(got, want_keys)
                elif kind_ == "argsort":
                    ok = torch.equal(got.to(torch.int64), want_order)
                else:  # top/bottom-k: the sorted prefix, of the complement for topk
                    enc = ops.keyspace.encode(x)
                    order = torch.sort(~enc if kind_ == "topk" else enc, dim=1,
                                       stable=True).indices[:, :TOP_K]
                    want_v = ops.keyspace.decode(torch.gather(enc, 1, order), x.dtype)
                    ok = same_keys(got[0], want_v) and torch.equal(got[1].to(torch.int64), order)
                print(f"path {path}: {name} {'ok' if ok else 'WRONG'}", flush=True)
                if not ok:
                    fail(f"path {path} wrong on {name}")
            for name in needed:
                if launches[name] <= 0:
                    fail(f"kernel {name} was not launched on the path {path}")
            for name, count in launches.items():
                total_launches[name] += count
        # the new paths: each driven with the counts at 0 just before and read just
        # after, then checked against torch on the card
        def drive(path, needed, calls):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.time()
            results = {name: fn() for name, fn in calls.items()}
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            print(f"path {path} launches: {launches} ({time.time() - t0:.1f} s)", flush=True)
            for name in needed:
                if launches[name] <= 0:
                    fail(f"kernel {name} was not launched on the path {path}")
            for name, count in launches.items():
                total_launches[name] += count
            path_launches[path] = launches
            return results

        path_launches = {}
        launches_of = path_launches.__getitem__

        def verdict(path, name, ok):
            print(f"path {path}: {name} {'ok' if ok else 'WRONG'}", flush=True)
            if not ok:
                fail(f"path {path} wrong on {name}")

        sort_kernels = ("level_fused", "rank_hist", "sort_windows")
        t0 = time.time()
        stream_x = specials(make_input("Uniform", N_STREAM, np.float32, seed=12))
        print(f"stream input: {N_STREAM} float32 keys on the host in {time.time() - t0:.1f} s",
              flush=True)
        path = f"stream sort ({N_STREAM} keys, chunks of {CHUNK})"
        got = drive(path, sort_kernels + ("merge_path",), {
            "external_sort": lambda: stream.external_sort(stream_x, chunk_size=CHUNK),
            "external_argsort": lambda: stream.external_argsort(stream_x, chunk_size=CHUNK),
        })
        stream_enc = ops.keyspace.encode(torch.as_tensor(stream_x, device=dev))
        want = torch.sort(stream_enc, stable=True)
        verdict(path, "external_sort", torch.equal(
            ops.keyspace.encode(torch.as_tensor(got["external_sort"], device=dev)), want.values))
        verdict(path, "external_argsort", torch.equal(
            torch.as_tensor(got["external_argsort"], device=dev).to(torch.int64), want.indices))
        del got, want

        path = f"stream top-k ({N_STREAM} keys, k={STREAM_K})"
        got = drive(path, sort_kernels + ("merge_path",), {
            "streaming_topk": lambda: stream.streaming_topk(stream_x, STREAM_K, chunk_size=CHUNK),
            "streaming_bottomk": lambda: stream.streaming_topk(stream_x, STREAM_K, chunk_size=CHUNK,
                                                               largest=False),
        })
        for name, codes in (("streaming_topk", ~stream_enc), ("streaming_bottomk", stream_enc)):
            order = torch.sort(codes, stable=True).indices[:STREAM_K]
            vals, idx = got[name]
            verdict(path, name, torch.equal(torch.as_tensor(idx, device=dev).to(torch.int64), order)
                    and torch.equal(ops.keyspace.encode(torch.as_tensor(vals, device=dev)),
                                    stream_enc[order]))
        del got, stream_enc

        group_x = make_input("RootDup", N_GROUPS, np.int32, seed=13)
        path = f"stream group-by ({N_GROUPS} RootDup int32, chunks of {CHUNK_GROUPS})"
        got = drive(path, sort_kernels + ("merge_path",), {
            "streaming_group_by": lambda: stream.streaming_group_by(group_x,
                                                                    chunk_size=CHUNK_GROUPS),
        })
        vals, counts = got["streaming_group_by"]
        want_v, want_c = torch.unique(torch.as_tensor(group_x, device=dev), return_counts=True)
        verdict(path, f"streaming_group_by ({vals.shape[0]} groups)",
                torch.equal(torch.as_tensor(vals, device=dev), want_v)
                and torch.equal(torch.as_tensor(counts, device=dev), want_c))

        # grouping: the MoE routing ids grouped by expert (both methods), the
        # token rows moved with them, and per-layer routing rows placed at once
        layer_ids = torch.randint(0, MOE_EXPERTS, (MOE_LAYERS, N_ROW * MOE_TOP), generator=gen,
                                  device=dev, dtype=torch.int32)
        layer_off = torch.cat([torch.stack([counts_prefix(r, MOE_EXPERTS) for r in layer_ids]),
                               torch.full((MOE_LAYERS, 1), layer_ids.shape[1], device=dev,
                                          dtype=torch.int32)], 1)
        moe_tok_ids = moe_uniform[: 1 << 16]
        moe_tokens = torch.randn((1 << 16, 2048), generator=gen, device=dev).to(torch.bfloat16)
        path = f"group-by ({MOE_TOKENS} tokens x top-{MOE_TOP} over {MOE_EXPERTS} experts)"
        got = drive(path, ("dispatch_ranks", "partition_ranks", "partition_ranks_batched"), {
            "group_by pallas": lambda: ops.group_by(moe_uniform, num_groups=MOE_EXPERTS,
                                                    method="pallas"),
            "group_by partition": lambda: ops.group_by(moe_skewed, num_groups=MOE_EXPERTS),
            "moe_group_tokens": lambda: moe_group_tokens(moe_tok_ids, moe_tokens, MOE_EXPERTS),
            "partition_ranks_kernel rows": lambda: partition_ranks_kernel(layer_ids, layer_off,
                                                                          MOE_EXPERTS),
        })
        for name, ids in (("group_by pallas", moe_uniform), ("group_by partition", moe_skewed)):
            g = got[name]
            order = torch.sort(ids, stable=True).indices
            verdict(path, name, torch.equal(g.perm.to(torch.int64), order)
                    and torch.equal(g.keys, ids[order])
                    and torch.equal(g.counts, torch.bincount(ids, minlength=MOE_EXPERTS).int()))
        grouped, _, dest = got["moe_group_tokens"]
        order = torch.sort(moe_tok_ids, stable=True).indices
        verdict(path, "moe_group_tokens", torch.equal(grouped, moe_tokens[order])
                and torch.equal(dest[order].to(torch.int64),
                                torch.arange(order.shape[0], device=dev)))
        dest = got["partition_ranks_kernel rows"]
        verdict(path, f"partition_ranks_kernel ({MOE_LAYERS}, {layer_ids.shape[1]})", torch.equal(
            torch.gather(dest, 1, torch.sort(layer_ids, dim=1, stable=True).indices).to(torch.int64),
            torch.arange(layer_ids.shape[1], device=dev).expand_as(layer_ids)))
        del got, moe_tokens, grouped

        # segmented_sort: 4096 ragged segments over 2^24 keys
        seg_x = main_input("Uniform", N_BIG)
        cuts = np.sort(np.random.default_rng(14).integers(0, N_BIG, SEGMENTS - 1))
        seg_off = torch.as_tensor(np.concatenate([[0], cuts, [N_BIG]]).astype(np.int32), device=dev)
        path = f"segmented ({SEGMENTS} segments over {N_BIG} keys)"
        got = drive(path, ("rank_hist", "sort_windows") + GLUE_LAUNCHES[1:] + TAIL_LAUNCHES
                    + ("sample_splitters", "codec_decode"), {
            "segmented_sort": lambda: ops.segmented_sort(seg_x, seg_off, SEGMENTS),
        })
        seg = ips4o.segment_ids(seg_off, N_BIG).to(torch.int64)
        packed = (seg << 32) + (ops.keyspace.encode(seg_x).to(torch.int64) + (1 << 31))
        want = ((torch.sort(packed).values & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
        verdict(path, "segmented_sort", torch.equal(ops.keyspace.encode(got["segmented_sort"]), want))
        del got, packed, want

        # no host read from entry to return (obs off): the seven calls under
        # torch.cuda.set_sync_debug_mode("error"), each once before to warm up
        sync_x = main_input("Uniform", N_BIG)
        sync_double = wide_input("float64", N_BIG, seed=51)
        sync_free = dict(zip(SYNC_FREE_CALLS, (
            lambda: ops.sort(sync_x), lambda: ops.argsort(sync_x),
            lambda: ops.topk(sync_x, STREAM_K), lambda: ops.batched_sort(bulk),
            lambda: ops.sort(sync_double), lambda: ops.sort(radix_int, classifier=radix),
            lambda: ops.segmented_sort(seg_x, seg_off, SEGMENTS))))
        was_enabled = obs.enabled()
        obs.enabled(False)
        for name, call in sync_free.items():
            if sync_calls(torch, call):  # warm, and torch's one-time sync absorbed
                fail(f"{name} made a synchronizing call (set_sync_debug_mode warn)")
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            except RuntimeError as exc:
                fail(f"{name} made a synchronizing call: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"path sync-free {name}: no synchronizing call (set_sync_debug_mode error, "
                  f"obs off)", flush=True)
        obs.enabled(was_enabled)
        del sync_x, sync_double
        # G4 moves every tensor in one launch: ops.sort (the keys) and
        # ops.argsort (the keys and the index) each make one scatter a level
        # and one gather a base-case pass; records' tie-break sorts likewise
        g4_levels = len(ips4o.plan_levels(N_BIG, cfg))
        g4_x = main_input("Uniform", N_BIG)
        for name, call in (("ops.sort", lambda: ops.sort(g4_x)),
                           ("ops.argsort", lambda: ops.argsort(g4_x))):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            call()
            torch.cuda.synchronize()
            c_ = kernels.launch_counts()
            print(f"path G4 launches {name} n={N_BIG}: scatter_rows {c_['scatter_rows']} "
                  f"({g4_levels} levels), gather_windows {c_['gather_windows']} (2 passes)",
                  flush=True)
            if c_["scatter_rows"] != g4_levels or c_["gather_windows"] != 2:
                fail(f"{name}: G4 launched other than once a level and a pass")
        del g4_x

        # ---- every key dtype: the 64-bit paths run the 64-bit kernels, the
        # narrow keys the 32-bit ones; each result held to torch.sort(stable)
        # of the port's encoded keys, keys compared through integer views
        def same_bits(a, b):
            bits_ = ops.keyspace.key_bits(a.dtype)
            signed = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}[bits_]
            return a.dtype == b.dtype and torch.equal(a.view(signed), b.view(signed))

        def sorted_ok(x, keys_out=None, order=None, vals=None, payload=None):
            """The sorted keys (NaN in the canonical bits ``decode`` gives),
            the stable argsort and the payload moved by it, against
            torch.sort(stable) of the encoded keys."""
            enc = ops.keyspace.encode(x)
            want = torch.sort(enc, dim=-1, stable=True)
            ok = True
            if keys_out is not None:
                ok = same_bits(keys_out, ops.keyspace.decode(want.values, x.dtype))
            if order is not None:
                ok = ok and torch.equal(order.to(torch.int64), want.indices)
            if vals is not None:
                ok = ok and torch.equal(vals.view(torch.int64), payload.view(torch.int64)[
                    want.indices])
            return ok

        wide64 = ("level_fused64", "rank_hist", "sort_windows64", "close_placement",
                  "segment_ids", "composite_ids64", "scatter_rows", "gather_windows")
        huge_cfg = ips4o.SortConfig(kmax=HUGE_KMAX, slack=HUGE_SLACK)
        narrow_dtypes = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16,
                         torch.bfloat16, torch.uint32)
        # the paper's element types (§5): double, Pair (1 payload word),
        # Quartet (3) and 100Bytes (a uint64 key and 12 words, 1.75 GB)
        for etype, (np_dtype, words) in ELEMENT_TYPES.items():
            x = torch.as_tensor(make_input("Uniform", N_BIG, np_dtype, seed=40), device=dev)
            if np_dtype == np.float64:
                x[3::3] *= -1
            payload = None if not words else torch.as_tensor(
                make_payload(N_BIG, words, seed=41), device=dev)
            path = f"{etype} ({N_BIG} {np.dtype(np_dtype).name} keys, {words} payload words)"
            calls = {"argsort": lambda: ops.argsort(x)}
            calls["sort"] = (lambda: ops.sort(x)) if payload is None else (
                lambda: ops.sort(x, payload))
            got = drive(path, wide64, calls)
            if payload is None:
                verdict(path, "sort", sorted_ok(x, got["sort"]))
            else:
                verdict(path, "sort + payload", sorted_ok(x, got["sort"][0], vals=got["sort"][1],
                                                          payload=payload))
            verdict(path, "argsort", sorted_ok(x, order=got["argsort"]))
            del got, payload
        big64 = wide_input("float64", N_HUGE, seed=42)
        path = (f"double ({N_HUGE} float64 keys, 1 GiB; kmax={huge_cfg.kmax}, "
                f"slack={huge_cfg.slack})")
        got = drive(path, wide64, {"sort": lambda: ops.sort(big64, cfg=huge_cfg)})
        verdict(path, "sort", sorted_ok(big64, got["sort"]))
        del got, big64
        x64 = {name: wide_input(name, N_BIG, seed=43) for name in (
            "int64 TwoDup", "uint64", "float64 full range")}
        path = f"int64 TwoDup ({N_BIG} keys), argsort"
        got = drive(path, wide64, {"argsort": lambda: ops.argsort(x64["int64 TwoDup"])})
        verdict(path, "argsort", sorted_ok(x64["int64 TwoDup"], order=got["argsort"]))
        for name in ("uint64", "float64 full range"):
            path = f"radix {name} ({N_BIG} keys)"
            got = drive(path, ("level_fused_radix64", "rank_hist", "sort_windows64"), {
                "sort": lambda: ops.sort(x64[name], classifier=radix),
                "argsort": lambda: ops.argsort(x64[name], classifier=radix)})
            verdict(path, "sort", sorted_ok(x64[name], got["sort"]))
            verdict(path, "argsort", sorted_ok(x64[name], order=got["argsort"]))
        xf64 = wide_input("float64", N_BIG, seed=44)
        path = f"topk/bottomk float64 ({N_BIG} keys, k={STREAM_K})"
        got = drive(path, wide64, {"topk": lambda: ops.topk(xf64, STREAM_K),
                                   "bottomk": lambda: ops.bottomk(xf64, STREAM_K)})
        enc = ops.keyspace.encode(xf64)
        for name, codes in (("topk", ~enc), ("bottomk", enc)):
            order = torch.sort(codes, stable=True).indices[:STREAM_K]
            vals, idx = got[name]
            verdict(path, name, torch.equal(idx.to(torch.int64), order)
                    and same_bits(vals, ops.keyspace.decode(enc[order], xf64.dtype)))
        rows64 = wide_input("float64", B_BULK * N_ROW, seed=45).view(B_BULK, N_ROW)
        path = f"batched float64 ({B_BULK}, {N_ROW})"
        got = drive(path, ("level_fused_batched64", "rank_hist_batched", "sort_windows64"), {
            "batched_sort": lambda: ops.batched_sort(rows64),
            "batched_argsort": lambda: ops.batched_argsort(rows64)})
        verdict(path, "batched_sort", sorted_ok(rows64, got["batched_sort"]))
        verdict(path, "batched_argsort", sorted_ok(rows64, order=got["batched_argsort"]))
        seg64 = x64["int64 TwoDup"]
        path = f"segmented int64 ({SEGMENTS} segments over {N_BIG} keys)"
        got = drive(path, ("rank_hist", "sort_windows64"), {
            "segmented_sort": lambda: ops.segmented_sort(seg64, seg_off, SEGMENTS)})
        seg_of = ips4o.segment_ids(seg_off, N_BIG).to(torch.int64)
        by_key = torch.sort(seg64, stable=True).indices
        want = seg64[by_key[torch.sort(seg_of[by_key], stable=True).indices]]
        verdict(path, "segmented_sort", torch.equal(got["segmented_sort"], want))
        root64 = torch.as_tensor(make_input("RootDup", N_BIG, np.int64, seed=46), device=dev)
        path = f"group-by int64 RootDup ({N_BIG} keys)"
        got = drive(path, wide64, {"group_by": lambda: ops.group_by(root64),
                                   "unique": lambda: ops.unique(root64)})
        want_v, want_c = torch.unique(root64, return_counts=True)
        g = got["group_by"]
        order = torch.sort(root64, stable=True).indices
        num = want_v.shape[0]
        verdict(path, "group_by", torch.equal(g.perm.to(torch.int64), order)
                and torch.equal(g.keys, root64[order]) and int(g.num_groups) == num
                and torch.equal(g.counts[:num], want_c.to(torch.int32)))
        vals, counts, num_u = got["unique"]
        verdict(path, "unique", int(num_u) == num and torch.equal(vals[:num], want_v)
                and torch.equal(counts[:num], want_c.to(torch.int32)))
        del got, x64, xf64, rows64, root64, g, vals, counts, order, want, enc
        path = (f"TPU_BIG_PAYLOAD double ({N_BIG // 2} float64 keys, W=16384, kmax=64, "
                "tile 8192)")
        big_payload = wide_input("float64", N_BIG // 2, seed=47)
        got = drive(path, wide64, {"sort": lambda: ops.sort(big_payload, cfg=TPU_BIG_PAYLOAD),
                                   "argsort": lambda: ops.argsort(big_payload,
                                                                  cfg=TPU_BIG_PAYLOAD)})
        verdict(path, "sort", sorted_ok(big_payload, got["sort"]))
        verdict(path, "argsort", sorted_ok(big_payload, order=got["argsort"]))
        del got, big_payload
        narrow = {}
        for dtype in narrow_dtypes:
            bits_ = ops.keyspace.key_bits(dtype)
            signed = {8: torch.int8, 16: torch.int16, 32: torch.int32}[bits_]
            raw = torch.randint(-2**31, 2**31 - 1, (N_BIG,), generator=gen, device=dev,
                                dtype=torch.int32)
            narrow[dtype] = (raw.to(signed) if bits_ < 32 else raw).view(dtype)
            if dtype.is_floating_point:
                narrow[dtype][::1009] = float("nan")
                narrow[dtype][1::1013] = -0.0
        for clf in ("tree", radix):
            path = (f"narrow keys ({N_BIG} each of "
                    f"{', '.join(str(d)[6:] for d in narrow_dtypes)}), {clf}")
            needed = ("level_fused_radix" if clf == radix else "level_fused", "rank_hist",
                      "sort_windows")
            got = drive(path, needed, {str(d): (lambda d=d: ops.sort(narrow[d], classifier=clf))
                                       for d in narrow_dtypes})
            for d in narrow_dtypes:
                verdict(path, str(d), sorted_ok(narrow[d], got[str(d)]))
        del got, narrow

        # the block path: partition_blocks moves 2^28 int32 keys and an int32
        # payload (2 GiB) in place by K8, once per tensor; equal to the gather
        # by the stable block order, d the prefix of the block counts
        pb_bb = bb_uniform
        pb_keys = torch.randint(-2**31, 2**31 - 1, (N_BLOCK_KEYS,), generator=gen, device=dev,
                                dtype=torch.int32)
        pb_keys_before = pb_keys.clone()
        pb_arrays = {"k": pb_keys, "v": tagged(N_BLOCK_KEYS)}
        block_order = torch.sort(pb_bb, stable=True).indices
        want_d = prefix(pb_bb)
        ptr = pb_keys.data_ptr()
        path = (f"block path ({N_BLOCK_KEYS} int32 keys + int32 payload, blocks of {BLOCK}, "
                f"{N_BUCKETS} buckets)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = drive(path, ("permute_blocks_by_dest",), {
            "partition_blocks": lambda: partition_blocks(pb_arrays, pb_bb, N_BUCKETS, BLOCK),
        })
        pb_peak = torch.cuda.max_memory_allocated() - base
        out, d = got["partition_blocks"]
        in_place("partition_blocks", out["k"], ptr, pb_peak, N_BLOCK_KEYS * 4)
        if kernels.launch_counts()["permute_blocks_by_dest"] != 2:
            fail("partition_blocks did not launch K8 once per tensor")
        verdict(path, "partition_blocks", torch.equal(d, want_d)
                and torch.equal(out["v"].view(nblocks, BLOCK),
                                block_order[:, None].to(torch.int32) * BLOCK + tagged(BLOCK))
                and torch.equal(out["k"].view(nblocks, BLOCK),
                                pb_keys_before.view(nblocks, BLOCK)[block_order]))
        sb_keys = pb_keys_before.clone()
        path = f"sort_blocks ({N_BLOCK_KEYS} int32 keys, blocks of {BLOCK}, {N_BUCKETS} buckets)"
        got = drive(path, ("permute_blocks_by_dest",), {
            "sort_blocks": lambda: sort_blocks(sb_keys, pb_bb, k=N_BUCKETS, block_elems=BLOCK),
        })
        out, d = got["sort_blocks"]
        verdict(path, "sort_blocks", out.data_ptr() == sb_keys.data_ptr() and torch.equal(d, want_d)
                and torch.equal(out.view(nblocks, BLOCK),
                                pb_keys_before.view(nblocks, BLOCK)[block_order]))
        del got, out, sb_keys, pb_keys_before

        # s3-sort, the out-of-place baseline: 2^24 float32 Uniform with NaN and
        # +-0.0 and a payload, equal to torch.sort(stable=True) of the raw keys
        s3_x = main_input("Uniform", N_BIG)
        s3_v = torch.arange(N_BIG, device=dev, dtype=torch.int32)
        path = f"s3-sort ({N_BIG} float32 Uniform with NaN/+-0.0, int32 payload)"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = drive(path, (), {"s3_sort": lambda: s3_sort(s3_x, s3_v)})
        s3_peak = torch.cuda.max_memory_allocated() - base
        keys_s3, vals_s3 = got["s3_sort"]
        want = torch.sort(s3_x, stable=True)
        verdict(path, "s3_sort", same_keys(keys_s3, want.values)
                and torch.equal(vals_s3.to(torch.int64), want.indices))
        del got, keys_s3, vals_s3, want

        # K7's entry points and K9's, at phase 2's shapes
        path = "classify+histogram (K7 entry points)"
        got = drive(path, ("classify_histogram", "classify_histogram_batched", "radix_histogram"), {
            **{f"classify_histogram {tag}": (lambda tag=tag: cl.classify_histogram(
                k7_in[tag], k7_spl[tag], k=k)) for tag in k7_in},
            "classify_histogram_batched": lambda: cl.classify_histogram_batched(k7_rows, k7_rows_spl,
                                                                                k=k),
            "radix_histogram": lambda: cl.radix_histogram(radix7, k=K_RADIX),
            "radix_histogram_batched": lambda: cl.radix_histogram_batched(radix7_rows, k=K_RADIX),
        })
        for name, want in ((f"classify_histogram {tag}", k7_want[tag]) for tag in k7_in):
            verdict(path, name, all(torch.equal(g, w) for g, w in zip(got[name], want)))
        for name, key in (("classify_histogram_batched", "batched"), ("radix_histogram", "radix 0"),
                          ("radix_histogram_batched", "radix batched")):
            verdict(path, name, all(torch.equal(g, w) for g, w in zip(got[name], k7_want[key])))
        keys9 = tagged(N_BLOCK_KEYS)
        d_uniform = prefix(bb_uniform)
        path = f"in-place block permutation (K9, {nblocks} blocks of {BLOCK}, {N_BUCKETS} buckets)"
        got = drive(path, ("permute_blocks_inplace",), {
            "permute_blocks_inplace": lambda: pi.permute_blocks_inplace(keys9, bb_uniform, d_uniform,
                                                                        k=N_BUCKETS),
        })
        verdict(path, "permute_blocks_inplace (per-bucket block multisets)", torch.equal(
            k9_canonical(got["permute_blocks_inplace"], d_uniform, nblocks), k9_want["uniform"]))
        del got, k9_want

        # ---- the paths of payload pytrees, records, the learned classifier and
        # the plan cache, each against an oracle of torch (or numpy) calls
        from repro_torch.classify import classifier_for, learned
        from repro_torch.data.datasets import make_dataset, oracle_argsort
        from repro_torch.ops.plan import PlanCache

        def payload_of(lead, seed):
            """{"id": int64, "rows": (..., 4) f32, "tag": bf16, "none": None}."""
            g = torch.Generator(device=dev).manual_seed(seed)
            size = int(np.prod(lead))
            return {"id": torch.arange(size, device=dev).view(lead),
                    "rows": torch.randn(lead + (4,), generator=g, device=dev),
                    "tag": torch.randn(lead, generator=g, device=dev).to(torch.bfloat16),
                    "none": None}

        def moved(got, vals, order):
            """Each leaf of ``got`` is the leaf of ``vals`` gathered by the
            stable argsort ``order`` (per row for 2-D), the None leaf None."""
            if got["none"] is not None or set(got) != set(vals):
                return False
            for name in ("id", "rows", "tag"):
                v = vals[name]
                if order.dim() == 1:
                    want_v = v[order]
                else:
                    idx = order.view(order.shape + (1,) * (v.dim() - 2)).expand(v.shape)
                    want_v = torch.gather(v, 1, idx)
                a, b = got[name], want_v
                if a.dtype == torch.bfloat16:
                    a, b = a.view(torch.int16), b.view(torch.int16)
                if not torch.equal(a, b):
                    return False
            return True

        x_pt = main_input("Uniform", N_BIG)
        p_pt = payload_of((N_BIG,), 60)
        rows_pt = bulk
        prow_pt = payload_of((B_BULK, N_ROW), 61)
        ids_pt = torch.randint(0, MOE_EXPERTS, (N_BIG,), generator=gen, device=dev,
                               dtype=torch.int32)
        path = (f"pytree ({N_BIG} float32 and ({B_BULK}, {N_ROW}) rows with an int64, (n, 4) "
                "float32, bfloat16 and None payload)")
        got = drive(path, sort_kernels + ("level_fused_batched", "rank_hist_batched",
                                          "partition_ranks"), {
            "sort": lambda: ops.sort(x_pt, p_pt),
            "batched_sort": lambda: ops.batched_sort(rows_pt, prow_pt),
            "group_by sort": lambda: ops.group_by(x_pt, p_pt),
            "group_by partition": lambda: ops.group_by(ids_pt, p_pt, num_groups=MOE_EXPERTS),
        })
        want_k, want_o = yardstick(x_pt)
        k_, v_ = got["sort"]
        verdict(path, "sort", same_keys(k_, want_k) and moved(v_, p_pt, want_o))
        want_kb, want_ob = yardstick(rows_pt)
        k_, v_ = got["batched_sort"]
        verdict(path, "batched_sort", same_keys(k_, want_kb) and moved(v_, prow_pt, want_ob))
        g_ = got["group_by sort"]
        verdict(path, "group_by sort", torch.equal(g_.perm.to(torch.int64), want_o)
                and moved(g_.values, p_pt, want_o))
        want_og = torch.sort(ids_pt, stable=True).indices
        g_ = got["group_by partition"]
        verdict(path, "group_by partition", torch.equal(g_.perm.to(torch.int64), want_og)
                and moved(g_.values, p_pt, want_og))
        del got, p_pt, prow_pt, ids_pt, g_, k_, v_, want_k, want_o, want_kb, want_ob, want_og

        def lsd_order(words):
            """The oracle: an LSD cascade of torch.sort(stable=True) over the
            encoded word columns, last word first, on the card."""
            order = torch.arange(words.shape[0], device=dev)
            for j in reversed(range(words.shape[1])):
                col = ops.keyspace.encode(words[:, j].contiguous())[order]
                order = order[torch.sort(col, stable=True).indices]
            return order

        def passes_taken(sorted_words):
            """The tie-break passes a sorted record matrix needed: the words
            l >= 1 at which some run of equal prefixes still tied."""
            head = torch.zeros(sorted_words.shape[0], dtype=torch.bool, device=dev)
            head[0] = True
            taken = 0
            for j in range(sorted_words.shape[1]):
                col = sorted_words[:, j].view(torch.int32)
                if j:
                    taken += int(not bool(torch.all(head)))
                head[1:] |= col[1:] != col[:-1]
            return taken

        record_sets = {}
        t0 = time.time()
        for name, n_rec, width in (("SkySurvey", N_BIG, None), ("TenantTuples", N_BIG, None),
                                   ("UrlPaths", 1 << 20, 8), ("RnaSequences", 1 << 20, 8)):
            ds = make_dataset(name, n_rec, seed=62, width=width)
            words = torch.from_numpy(ds.words.view(np.int32)).to(dev).view(torch.uint32)
            record_sets[name] = (words, ds if n_rec == 1 << 20 else None)
        print(f"records input: {', '.join(f'{k} {tuple(w.shape)}' for k, (w, _) in record_sets.items())} "
              f"uint32 words in {time.time() - t0:.1f} s", flush=True)
        for name, (words, ds) in record_sets.items():
            want_o = lsd_order(words)
            if ds is not None:
                verdict(f"records {name}", "the LSD oracle equals oracle_argsort",
                        torch.equal(want_o.cpu(), torch.from_numpy(oracle_argsort(ds))))
            for clf in ("tree", radix, "auto"):
                path = f"records {name} {tuple(words.shape)}, {clf}"
                needed = ("level_fused_radix" if clf == radix else "level_fused", "rank_hist",
                          "sort_windows")
                got = drive(path, needed, {
                    "argsort_records": lambda: ops.argsort_records(words, classifier=clf),
                    "sort_records": lambda: ops.sort_records(
                        words, {"id": torch.arange(words.shape[0], device=dev)},
                        classifier=clf),
                })
                out, vals = got["sort_records"]
                verdict(path, "argsort_records", torch.equal(
                    got["argsort_records"].to(torch.int64), want_o))
                verdict(path, "sort_records", torch.equal(vals["id"], want_o) and torch.equal(
                    out.view(torch.int32), words.view(torch.int32)[want_o]))
            print(f"records {name}: tie-break passes taken {passes_taken(out)} of "
                  f"{words.shape[1] - 1}", flush=True)
        sky_words = record_sets["SkySurvey"][0]
        del got, out, vals, record_sets, want_o

        zipf = np.random.default_rng(63).zipf(1.3, N_BIG).astype(np.float32)
        learned_inputs = {"Uniform": main_input("Uniform", N_BIG),
                          "Zipf": torch.as_tensor(zipf, device=dev)}
        for name, x in learned_inputs.items():
            learned.ROUTES.clear()
            model = name == "Uniform"
            path = f"learned {name} ({N_BIG} float32)"
            needed = ("rank_hist", "sort_windows") + (() if model else ("level_fused",))
            got = drive(path, needed, {
                "sort": lambda: ops.sort(x, classifier="learned"),
                "argsort": lambda: ops.argsort(x, classifier="learned")})
            print(f"path {path}: level 1 kept the model {learned.ROUTES['model']} times, "
                  f"fell back {learned.ROUTES['fallback']} times", flush=True)
            verdict(path, "fallback as expected (model kept on Uniform, taken on Zipf)",
                    learned.ROUTES["model" if model else "fallback"] == 2
                    and learned.ROUTES["fallback" if model else "model"] == 0)
            if model and launches_of(path)["level_fused"]:
                fail(f"path {path}: the tree's K1 ran though the model was kept")
            want_k, want_o = yardstick(x)
            verdict(path, "sort", same_keys(got["sort"], want_k))
            verdict(path, "argsort", torch.equal(got["argsort"].to(torch.int64), want_o))
        learned.ROUTES.clear()
        path = f"learned batched ({B_BULK}, {N_ROW})"
        got = drive(path, ("rank_hist_batched", "sort_windows"), {
            "batched_sort": lambda: ops.batched_sort(bulk, classifier="learned"),
            "batched_argsort": lambda: ops.batched_argsort(bulk, classifier="learned")})
        print(f"path {path}: level 1 kept the model {learned.ROUTES['model']} times, fell back "
              f"{learned.ROUTES['fallback']} times", flush=True)
        want_kb, want_ob = yardstick(bulk)
        verdict(path, "batched_sort", same_keys(got["batched_sort"], want_kb))
        verdict(path, "batched_argsort",
                torch.equal(got["batched_argsort"].to(torch.int64), want_ob))
        if launches_of(path)["level_fused_batched"] and learned.ROUTES["model"]:
            fail(f"path {path}: K4 level_fused_batched ran though the model was kept")
        # level 1's placement by kernel name: K2's (K4's) kernels twice a
        # learned two-level sort (level 1 and level 2), K1 none; and the glue
        # kernels (G1-G4) a call
        x_l = learned_inputs["Uniform"]
        for tag, fn in (("ops.sort learned", lambda: ops.sort(x_l, classifier="learned")),
                        ("ops.sort tree", lambda: ops.sort(x_l)),
                        ("ops.batched_sort learned",
                         lambda: ops.batched_sort(bulk, classifier="learned"))):
            names = {}
            for e in device_events(torch, fn, 3):
                for key_ in ("level_fused_kernel",) + K2_KERNELS + GLUE_KERNELS:
                    if key_ in e.key:
                        names[key_] = names.get(key_, 0) + e.count / 3
            print(f"kernels a call, {tag}: {names}", flush=True)
        del got, want_kb, want_ob, zipf

        plan_dir = tempfile.TemporaryDirectory()
        pc = PlanCache(str(Path(plan_dir.name) / "plans.json"))
        x_plan = torch.as_tensor(make_input("Uniform", N_PLAN, np.float32, seed=64), device=dev)
        stream_plan_x = make_input("Uniform", N_PLAN_STREAM, np.float32, seed=65)
        path = (f"plan (classifier race and tuned sorters at {N_PLAN} float32, external_sort "
                f"of {N_PLAN_STREAM} in chunks of {N_PLAN})")
        t0 = time.time()
        got = drive(path, sort_kernels + ("merge_path",), {
            "classifier_for": lambda: classifier_for(x_plan, cache=pc, tune=True),
            "sort": lambda: pc.get_sorter(N_PLAN, torch.float32, "sort", tune=True)(x_plan),
            "topk": lambda: pc.get_sorter(N_PLAN, torch.float32, "topk", k=STREAM_K,
                                          tune=True)(x_plan),
            "external_sort": lambda: stream.external_sort(stream_plan_x, chunk_size=N_PLAN,
                                                          cache=pc, tune=True),
        })
        plan_tile = pc.stream_plan(N_PLAN, N_PLAN_STREAM // N_PLAN, torch.float32).merge_tile
        print(f"path plan: winners: classifier {got['classifier_for']}, sort "
              f"{pc.config_for('sort', N_PLAN, torch.float32)}, topk "
              f"{pc.config_for('topk', N_PLAN, torch.float32, k=STREAM_K)}, stream merge tile "
              f"{plan_tile} ({time.time() - t0:.1f} s with the sweeps)", flush=True)
        print(f"path plan: entries {json.dumps(pc._plans, sort_keys=True)}", flush=True)
        again = PlanCache(pc.path)
        verdict(path, "the JSON reloads to the same plans", json.load(open(pc.path)) == pc._plans
                and again.config_for("sort", N_PLAN, torch.float32)
                == pc.config_for("sort", N_PLAN, torch.float32)
                and again.classifier_hint(N_PLAN, torch.float32) == got["classifier_for"]
                and again.stream_plan(N_PLAN, N_PLAN_STREAM // N_PLAN, torch.float32).merge_tile
                == plan_tile)
        want_k, _ = yardstick(x_plan)
        verdict(path, "sort", same_keys(got["sort"], want_k))
        tv, ti = got["topk"]
        want_t = torch.sort(~ops.keyspace.encode(x_plan), stable=True).indices[:STREAM_K]
        verdict(path, "topk", torch.equal(ti.to(torch.int64), want_t))
        verdict(path, "external_sort", np.array_equal(
            ops.keyspace.encode_np(got["external_sort"]),
            np.sort(ops.keyspace.encode_np(stream_plan_x))))
        del got, want_k, tv, ti, want_t

        # peak device memory per key, above the inputs: the in-place block move
        # against the out-of-place s3-sort and the port's ops.sort
        _, sort_peak = rise(lambda: ops.sort(s3_x))
        print(f"peak bytes per key: partition_blocks {pb_peak / N_BLOCK_KEYS:.6f} ({N_BLOCK_KEYS} "
              f"keys + payload, 8 B of data per key), s3_sort {s3_peak / N_BIG:.4f} ({N_BIG} keys "
              f"+ payload), ops.sort {sort_peak / N_BIG:.4f} ({N_BIG} keys)", flush=True)
        torch.cuda.empty_cache()

        for name, r in rows.items():
            r["launches"] = total_launches[name]

        # where the robustness fallback engages (the default sampling leaves some
        # buckets above W/2 at n = 2^24; radix on float Uniform keys leaves most)
        def fallback_share(tag, passes, arrays, n_real, cfg_, levels_):
            _, off, nb, pad_bucket = passes(arrays, n_real, cfg_, levels_)
            big = fallback.oversized_mask(off, nb, cfg_.base_case, pad_bucket)
            sizes = off[..., 1:] - off[..., :-1]
            keys_big = int(sizes[big].sum())
            total = arrays["k"].numel()
            print(f"fallback {tag}: {int(big.sum())} of {big.numel()} buckets above W/2 hold "
                  f"{keys_big} of {total} keys ({keys_big / total:.4f}), the largest "
                  f"{int(sizes[big].max()) if bool(big.any()) else 0}", flush=True)

        radix_cfg = ips4o.SortConfig(classifier=radix)
        enc = ops.keyspace.encode
        fallback_share(f"tree Uniform n={N_BIG}", ips4o.partition_passes,
                       {"k": enc(paths["1-D tree"][1][0][1])}, N_BIG, cfg, levels)
        for tag, x in ((f"radix int32 full range n={N_BIG}", radix_int),
                       (f"radix float32 Uniform n={N_BIG}", radix_float)):
            fallback_share(tag, ips4o.partition_passes, {"k": enc(x)}, N_BIG, radix_cfg, levels)
        fallback_share(f"batched tree bulk ({B_BULK}, {N_ROW})", ips4o.batched_partition_passes,
                       {"k": enc(bulk)}, N_ROW, cfg, levels_b)
        fallback_share(f"batched radix ({B_BULK}, {N_ROW})", ips4o.batched_partition_passes,
                       {"k": enc(bulk_radix)}, N_ROW, radix_cfg, levels_b)
        double1 = wide_input("float64", N_BIG, seed=50)
        fallback_share(f"tree double n={N_BIG}", ips4o.partition_passes, {"k": enc(double1)},
                       N_BIG, cfg, levels)

        # ---- 4. timing ------------------------------------------------------------
        # Op counts for the bounds, per element: K1 3 per search step (load,
        # compare, add) over log2(k) steps plus ~12 for eq, pad routing, the warp
        # match, the popcounts and the scan; K1r ~6 for the bit extraction (xor,
        # shift, mask, the sentinel test, 2j + eq) in place of the search; K3 4
        # per compare-exchange (a 64-bit compare is two, the swap two).  Bytes:
        # each input read once, each output written once (keys in, bucket and
        # rank out).
        log_k = k.bit_length() - 1
        keys1 = encoded("Uniform", N_BIG, np.float32)
        spl1 = sampling.select_splitters(
            torch.sort(keys1[torch.randint(0, N_BIG, (4 * k,), generator=gen,
                                           device=dev)]).values, k)
        tiles1 = -(-N_BIG // lf.TILE)
        t = rows["level_fused"]
        k1_call = lambda: lf._level_tiles_kernel(keys1[None], spl1[None], k, N_BIG, lf.TILE)
        kernel_ms(torch, "level_fused", t, k1_call)
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(keys1[None], spl1[None], k,
                                                                     N_BIG, lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            N_BIG * 12 + k * 4 + tiles1 * (2 * k + 1) * 4, N_BIG * (3 * log_k + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused(keys1, spl1, k=k))

        # K2 at the 1-D path's level 2: 8 B per id (the id read, dest written)
        # and the offsets; ~16 ops per id (the count's load and atomic, the
        # rank's mask, counter and popcounts, the store)
        t = rows["rank_hist"]
        k2_call = lambda: lf._segment_place_kernel(comp[None], off1[None], nb1, 2 * k2, k2_tile,
                                                   "rank_hist")
        kernel_ms(torch, "rank_hist", t, k2_call)
        t["plain_ms"] = cuda_ms(torch, lambda: lf.rank_hist_plain(comp, tile=k2_tile, **k2_args),
                                reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 8 + (nb1 + 1) * 4 + (nb2 + 1) * 4,
                                                N_BIG * 16)
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(comp, stable=True), reps=5)
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.rank_hist(comp, tile=k2_tile, **k2_args))

        t = rows["sort_windows"]
        kernel_ms(torch, "sort_windows", t, lambda: bitonic.sort_windows(wb, wk, nb=64))
        t["plain_ms"] = cuda_ms(torch, lambda: bitonic.sort_windows_plain(wb, wk, nb=64))
        log_w = W.bit_length() - 1
        compare_exchanges = (num_w * W // 2) * log_w * (log_w + 1) // 2
        t["bound_ms"], t["bound_by"] = bound_ms(num_w * W * 16, compare_exchanges * 4)
        packed = (wb.to(torch.int64) << 32) + (wk.to(torch.int64) + (1 << 31))
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(packed, dim=1, stable=True))

        # K1r at the 1-D radix path's level 1: n = 2^24 int32 full range
        t = rows["level_fused_radix"]
        kernel_ms(torch, "level_fused_radix", t, lambda: lf._level_tiles_kernel(
            radix_int[None], None, k, N_BIG, lf.TILE))
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(radix_int[None], None, k,
                                                                     N_BIG, lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 12 + tiles1 * (2 * k + 1) * 4,
                                                N_BIG * (6 + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused(radix_int, k=k,
                                                                classifier=radix))

        # K4 level_fused_batched at the bulk path's level 1, tree mode (radix printed)
        kb = encoded("Uniform", B_BULK * N_ROW, np.float32, seed=4).view(B_BULK, N_ROW)
        tiles_b = B_BULK * -(-N_ROW // lf.TILE)
        t = rows["level_fused_batched"]
        kernel_ms(torch, "level_fused_batched", t, lambda: lf._level_tiles_kernel(
            kb, spl_b, k, N_ROW, lf.TILE, batched=True))
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(kb, spl_b, k, N_ROW,
                                                                     lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            B_BULK * N_ROW * 12 + B_BULK * k * 4 + tiles_b * (2 * k + 1) * 4,
            B_BULK * N_ROW * (3 * log_k + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused_batched(kb, spl_b, k=k))
        radix_k4_ms = cuda_ms(torch, lambda: lf._level_tiles_kernel(bulk_radix, None, k, N_ROW,
                                                                    lf.TILE, batched=True))

        # K4 rank_hist_batched at the bulk path's level 2
        t = rows["rank_hist_batched"]
        k4_call = lambda: lf._segment_place_kernel(comp_b, off1_b, nb1_b, 2 * k2b, k4_tile,
                                                   "rank_hist_batched")
        kernel_ms(torch, "rank_hist_batched", t, k4_call)
        t["plain_ms"] = cuda_ms(torch, lambda: lf.rank_hist_batched_plain(
            comp_b, tile=k4_tile, **k4_args), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            B_BULK * N_ROW * 8 + B_BULK * (nb1_b + 1) * 4 + B_BULK * (k4_args["nb"] + 1) * 4,
            B_BULK * N_ROW * 16)
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(comp_b, dim=1, stable=True), reps=5)
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.rank_hist_batched(comp_b, tile=k4_tile,
                                                                      **k4_args))
        # G1-G4 at the 1-D main path's shapes: n = 2^24 float32 Uniform, k =
        # 128, level 2 over 257 segments at k2 = 128 (nb 65,792); G4's gather
        # at pass two's 2047 windows of 8192, in place.  Bytes, each input read
        # once and each output written once: G1 bucket and rank in, dest out
        # (12 B a key), the histogram in and the offsets out; G2 the ids out
        # (4 B a key) and the offsets in; G3 the key in and the id out (8 B a
        # key, 12 B for int64 codes), the offsets and splitters in; G4 the
        # position and the row in, the row out (12 B a 4-byte key).  Ops, far
        # below: ~10 a key for G1, ~4 a search step for G2 and G3 (log2 of a
        # span's offsets, log2 k2 for G3's descent), ~6 for G4.  The library
        # calls (timed here, used nowhere in the port): G4's scatter as
        # index_copy_ by int64 positions, its gather as one index gather by
        # int64 sources, G2 as one searchsorted, G3 as one searchsorted over
        # the packed (segment, key) pairs (int32 codes; no single call for
        # int64 codes); G1 has none
        b_m, r_m, h_m = k1_call()
        t = rows["close_placement"]
        kernel_ms(torch, "close_placement", t, lambda: glue.close_placement(
            b_m, r_m, h_m, 2 * k + 1, lf.TILE))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.close_placement_plain(
            b_m, r_m, h_m, 2 * k + 1, lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 12 + h_m.numel() * 4 + (2 * k + 2) * 4,
                                                N_BIG * 10)
        t["library_ms"] = None
        d_m, o_m = (x_[0] for x_ in glue.close_placement(b_m, r_m, h_m, 2 * k + 1, lf.TILE))
        d2_m, o2_m = lf.rank_hist(comp, tile=k2_tile, **k2_args)
        t = rows["segment_ids"]
        kernel_ms(torch, "segment_ids", t, lambda: glue.segment_ids(o2_m, N_BIG))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.segment_ids_plain(o2_m, N_BIG), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 4 + o2_m.numel() * 4, N_BIG * 4 * 5)
        pos_m = torch.arange(N_BIG, dtype=torch.int32, device=dev)
        t["library_ms"] = cuda_ms(torch, lambda: torch.searchsorted(o2_m, pos_m, right=True),
                                  reps=5)
        t["wrapper_ms"] = t["ms"]
        log_k2 = k2.bit_length() - 1
        spl_m = segment_splitters(arrays["k"][None], off1[None], k2, seed=7)
        t = rows["composite_ids"]
        kernel_ms(torch, "composite_ids", t, lambda: glue.composite_ids(
            arrays["k"][None], off1[None], nb1, k2, spl_m))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.composite_ids_plain(
            arrays["k"][None], off1[None], nb1, k2, spl_m), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            N_BIG * 8 + off1.numel() * 4 + spl_m.numel() * 4, N_BIG * 4 * (log_k2 + 2))
        seg_m = glue.segment_ids(off1, N_BIG).to(torch.int64)
        packed_k = (seg_m << 32) + (arrays["k"].to(torch.int64) + (1 << 31))
        packed_s = ((torch.arange(nb1, dtype=torch.int64, device=dev) << 32)[:, None]
                    + (spl_m[0].to(torch.int64) + (1 << 31))).reshape(-1)
        t["library_ms"] = cuda_ms(torch, lambda: torch.searchsorted(packed_s, packed_k), reps=5)
        del seg_m, packed_k, packed_s, pos_m
        t = rows["scatter_rows"]
        kernel_ms(torch, "scatter_rows", t, lambda: glue.scatter_rows({"k": keys1}, d_m, o_m))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.scatter_rows_plain({"k": keys1}, d_m),
                                reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 12 + o_m.numel() * 4, N_BIG * 6)
        d_m64 = d_m.to(torch.int64)
        out_m = torch.empty_like(keys1)
        t["library_ms"] = cuda_ms(torch, lambda: out_m.index_copy_(0, d_m64, keys1), reps=5)
        glue_more = {
            "scatter_rows level 1, row by row (no offsets)": cuda_ms(
                torch, lambda: glue.scatter_rows({"k": keys1}, d_m)),
            f"scatter_rows level 2 (nb {nb2}), staged": cuda_ms(
                torch, lambda: glue.scatter_rows({"k": keys1}, d2_m, o2_m)),
            "scatter_rows level 1, int64 rows, staged": cuda_ms(
                torch, lambda: glue.scatter_rows({"k": d_m64}, d_m, o_m)),
        }
        perm_m = bitonic.sort_windows(wb, wk, nb=64)[0]
        buf_m = keys1[None].clone()
        t = rows["gather_windows"]
        kernel_ms(torch, "gather_windows", t, lambda: glue.gather_windows(
            {"k": buf_m}, perm_m[:-1], W // 2, {"k": buf_m}))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.gather_windows_plain(
            buf_m, perm_m[:-1], W // 2, buf_m), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms((num_w - 1) * W * 12, (num_w - 1) * W * 6)
        src_m = (perm_m[:-1].to(torch.int64) + torch.arange(
            W // 2, N_BIG - W // 2, W, dtype=torch.int64, device=dev)[:, None]).reshape(-1)
        t["library_ms"] = cuda_ms(torch, lambda: keys1[src_m], reps=5)
        glue_more["gather_windows pass one (2048 windows into a new tensor)"] = cuda_ms(
            torch, lambda: glue.gather_windows({"k": keys1[None]}, perm_m, 0))
        # G4's device time, one tensor and argsort's two (keys and the int32
        # index: one launch), beside each case's byte bound
        idx_m = torch.arange(N_BIG, dtype=torch.int32, device=dev)
        buf64 = d_m64[None].clone()
        buf_i = idx_m[None].clone()
        g4_cases = {
            "scatter_rows level 1": (lambda: glue.scatter_rows({"k": keys1}, d_m, o_m), 12),
            f"scatter_rows level 2 (nb {nb2})": (
                lambda: glue.scatter_rows({"k": keys1}, d2_m, o2_m), 12),
            "scatter_rows level 1, keys + int32 index": (
                lambda: glue.scatter_rows({"k": keys1, "i": idx_m}, d_m, o_m), 20),
            "scatter_rows level 1, int64 rows": (
                lambda: glue.scatter_rows({"k": d_m64}, d_m, o_m), 20),
            "scatter_rows level 1, row by row (no offsets)": (
                lambda: glue.scatter_rows({"k": keys1}, d_m), 12),
            "gather_windows pass two in place": (lambda: glue.gather_windows(
                {"k": buf_m}, perm_m[:-1], W // 2, {"k": buf_m}), 12),
            "gather_windows pass two, keys + int32 index": (lambda: glue.gather_windows(
                {"k": buf_m, "i": buf_i}, perm_m[:-1], W // 2, {"k": buf_m, "i": buf_i}), 20),
            "gather_windows pass two, int64 rows": (lambda: glue.gather_windows(
                {"k": buf64}, perm_m[:-1], W // 2, {"k": buf64}), 20),
            "gather_windows pass one into a new tensor": (
                lambda: glue.gather_windows({"k": keys1[None]}, perm_m, 0), 12),
        }
        g4_device = {what: (device_ms(torch, fn_, names=DEVICE_FUNCTIONS[
            "scatter_rows" if what.startswith("scatter") else "gather_windows"]),
                            bound_ms(N_BIG * per_key, 0)[0])
                     for what, (fn_, per_key) in g4_cases.items()}
        g4_scatter_paths(torch, dev)
        del buf_m, src_m, out_m, d_m64, buf64, buf_i, idx_m

        # G5-G7 at the main path's shapes (2^24 float32, the tree's two
        # levels).  Bytes, each input read once and each output written once:
        # G5's encode the key in and the code out (8 B a key; the index, 4 B
        # more, is argsort's), its decode the code in and the key out; G6 the
        # drawn uniform and the gathered key in (8 B a sample), the offsets in
        # and the splitters out; G7's list the offsets in and the list out,
        # its sort the listed keys in and each array's listed rows in and out
        # (a key and an int32 index: 4 + 2 * (4 + 4) B a listed position, the
        # data this run holds).  Ops: G5 ~6 a key; G6 a bitonic network of
        # P/2 log2 P (log2 P + 1) / 2 compare-exchanges a segment, ~4 ops
        # each; G7's sort ~4 ops a compare, C log2^2 C / 4 compares a chunk
        # and one a merged output a round.  Library calls (timed here, used
        # nowhere in the port): G6 ``torch.sort`` of the gathered samples,
        # G7 the parent's stable sort of the oversized keys (packed with their
        # bucket into int64, as the plain twin packs them); G5 none (the
        # encode is a few elementwise ops, not one call)
        x_t = torch.as_tensor(make_input("Uniform", N_BIG, np.float32, seed=1), device=dev)
        t = rows["codec_encode"]
        kernel_ms(torch, "codec_encode", t, lambda: codec.encode_padded(x_t, N_BIG))
        t["plain_ms"] = cuda_ms(torch, lambda: codec.encode_padded_plain(x_t, N_BIG), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 8, N_BIG * 6)
        t["library_ms"] = None
        glue_more["codec_encode with argsort's index"] = cuda_ms(
            torch, lambda: codec.encode_padded(x_t, N_BIG, True))
        codes_t = torch.sort(codec.encode_padded(x_t, N_BIG)[0]).values
        t = rows["codec_decode"]
        kernel_ms(torch, "codec_decode", t, lambda: codec.decode(codes_t, torch.float32))
        t["plain_ms"] = cuda_ms(torch, lambda: codec.decode_plain(codes_t, torch.float32), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 8, N_BIG * 6)
        t["library_ms"] = None
        del codes_t
        m_t = 512
        u_t = torch.rand((1, nb1, m_t), generator=gen, device=dev)
        keys_l2 = arrays["k"][None]
        t = rows["sample_splitters"]
        kernel_ms(torch, "sample_splitters", t, lambda: glue.sample_splitters(
            keys_l2, u_t, k2, seg_offsets=off1[None]))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.sample_splitters_plain(
            keys_l2, u_t, k2, seg_offsets=off1[None]), reps=5)
        log_p = (m_t - 1).bit_length()
        t["bound_ms"], t["bound_by"] = bound_ms(
            nb1 * m_t * 8 + off1.numel() * 4 + nb1 * (k2 - 1) * 4,
            nb1 * (1 << log_p) // 2 * log_p * (log_p + 1) // 2 * 4)
        pos_t = sampling.positions_from_uniform(u_t, off1[None, :-1], off1[None, 1:]).reshape(
            1, -1).clamp_(max=N_BIG - 1)
        gathered_t = torch.gather(keys_l2, 1, pos_t).reshape(1, nb1, m_t)
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(gathered_t, dim=-1), reps=5)
        pos1_t = torch.randint(0, N_BIG, (1, m_t), generator=gen, device=dev)
        glue_more[f"sample_splitters level 1 (m {m_t}, k {k}, the upper form)"] = cuda_ms(
            torch, lambda: glue.sample_splitters(keys1[None], pos1_t, k, upper=True))
        del u_t, pos_t, gathered_t, pos1_t
        idx_t = torch.arange(N_BIG, dtype=torch.int32, device=dev)
        arrays_t, off_t, nb_t, pad_t = ips4o.partition_passes({"k": keys1, "v": idx_t}, N_BIG,
                                                              cfg, levels)
        W = cfg.base_case
        meta_t = fallback.oversized_list(off_t, nb_t, W, pad_t, None, N_BIG)
        listed, largest_t = int(meta_t[1]), int(meta_t[2])
        fb_t = glue.segment_ids(off_t, N_BIG)
        big_t = fallback.oversized_mask(off_t, nb_t, W, pad_t)
        pos_big = torch.nonzero(big_t[fb_t.to(torch.int64)]).squeeze(1)
        held = int(pos_big.numel())
        print(f"fallback_sort main path: {listed} buckets listed of {nb_t}, {held} keys, the "
              f"largest {largest_t}", flush=True)
        t = rows["fallback_list"]
        kernel_ms(torch, "fallback_list", t, lambda: fallback.oversized_list(
            off_t, nb_t, W, pad_t, None, N_BIG))
        # the chain it replaced: the verdict's torch ops and its host read
        t["plain_ms"] = cuda_ms(torch, lambda: bool(torch.any(fallback.oversized_mask(
            off_t, nb_t, W, pad_t))), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(off_t.numel() * 4 + meta_t.numel() * 4,
                                                nb_t * 6)
        t["library_ms"] = None
        # the row: ops.sort's case, the keys alone (merged themselves): each
        # listed key read once and written once; argsort's (the keys and the
        # index moved by the order) printed beside it
        keys_only_t = {"k": arrays_t["k"]}
        t = rows["fallback_sort"]
        kernel_ms(torch, "fallback_sort", t, lambda: fallback.sort_listed(keys_only_t, meta_t, 1))
        t["plain_ms"] = cuda_ms(torch, lambda: fallback.sort_oversized_plain(
            keys_only_t, fb_t, off_t, nb_t, W, pad_t), reps=5)
        log_c = fallback.CHUNK.bit_length() - 1
        t["bound_ms"], t["bound_by"] = bound_ms(held * 8, held * (log_c * log_c // 4 + 8) * 4)
        glue_more["fallback_sort with argsort's index (the order moves keys and index)"] = \
            cuda_ms(torch, lambda: fallback.sort_listed(arrays_t, meta_t, 1))
        packed_t = (fb_t[pos_big].to(torch.int64) << 32) + (
            arrays_t["k"][pos_big].to(torch.int64) + (1 << 31))
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(packed_t, stable=True), reps=5)
        # the empty list (every bucket of W/2: nothing to sort) and a bucket
        # that holds the whole row, list and sort together
        even_off = torch.arange(0, N_BIG + 1, W // 2, dtype=torch.int32, device=dev)
        whole = {"k": keys1.clone(), "v": idx_t.clone()}
        whole_off = torch.tensor([0, N_BIG], dtype=torch.int32, device=dev)
        glue_more["fallback_list + fallback_sort, an empty list (2^24 keys in buckets of W/2)"] = \
            cuda_ms(torch, lambda: fallback.sort_oversized(
                {"k": keys1, "v": idx_t}, None, even_off, even_off.numel() - 1, W, None))
        glue_more[f"fallback_list + fallback_sort, one bucket of {N_BIG} keys and an index"] = \
            cuda_ms(torch, lambda: fallback.sort_oversized(whole, None, whole_off, 1, W, None),
                    warmup=1, reps=3)
        whole_k = {"k": keys1.clone()}
        glue_more[f"fallback_list + fallback_sort, one bucket of {N_BIG} keys alone"] = \
            cuda_ms(torch, lambda: fallback.sort_oversized(whole_k, None, whole_off, 1, W, None),
                    warmup=1, reps=3)
        del whole_k
        for bits_ in (32, 64):
            info = fallback.launch_info(bits_)
            print(f"launch fallback_sort {bits_}-bit keys: {info}", flush=True)
            if info["local_bytes"]:
                fail(f"fallback_sort spills at {bits_}-bit keys: {info['local_bytes']} B")
        del arrays_t, fb_t, big_t, pos_big, packed_t, whole, x_t

        # the 64-bit forms at the 64-bit paths' shapes: K1 on double (float64
        # Uniform) at n = 2^24, k = 128; K1r on uint64 over the whole range;
        # K4 on (64, 2^18) float64 rows; K3 on 2048 windows of 8192.  Bytes:
        # K1 8 B of key in, 4 B of bucket and 4 B of rank out an element; K3
        # 8 B of key and 4 B of bucket in, 4 B of index and 4 B of bucket out.
        # Ops: a 64-bit compare is two, so K1's descent 4 a step; K1r ~8 for
        # the 64-bit digit; K3 9 a compare-exchange (a 96-bit compare is
        # three, the swap of three words six).  No torch call
        # computes K1, and none sorts windows by (bucket, 64-bit key) in one
        # call, so their library_ms is null
        keys64 = ops.keyspace.encode(double1)
        spl64 = sampling.select_splitters(torch.sort(keys64[torch.randint(
            0, N_BIG, (4 * k,), generator=gen, device=dev)]).values, k)
        t = rows["level_fused64"]
        k1_64_call = lambda: lf._level_tiles_kernel(keys64[None], spl64[None], k, N_BIG, lf.TILE)
        kernel_ms(torch, "level_fused64", t, k1_64_call)
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(
            keys64[None], spl64[None], k, N_BIG, lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            N_BIG * 16 + k * 8 + tiles1 * (2 * k + 1) * 4, N_BIG * (4 * log_k + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused(keys64, spl64, k=k))
        radix64 = ops.keyspace.encode(wide_input("uint64", N_BIG, seed=51))
        t = rows["level_fused_radix64"]
        kernel_ms(torch, "level_fused_radix64", t, lambda: lf._level_tiles_kernel(
            radix64[None], None, k, N_BIG, lf.TILE))
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(radix64[None], None, k,
                                                                     N_BIG, lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(N_BIG * 16 + tiles1 * (2 * k + 1) * 4,
                                                N_BIG * (8 + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused(radix64, k=k, classifier=radix))
        kb64 = ops.keyspace.encode(wide_input("float64", B_BULK * N_ROW, seed=52)).view(
            B_BULK, N_ROW)
        spl_b64 = sampling.select_splitters(torch.sort(torch.gather(kb64, 1, torch.randint(
            0, N_ROW, (B_BULK, 4 * k), generator=gen, device=dev)), dim=1).values, k)
        t = rows["level_fused_batched64"]
        kernel_ms(torch, "level_fused_batched64", t, lambda: lf._level_tiles_kernel(
            kb64, spl_b64, k, N_ROW, lf.TILE, batched=True))
        t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(kb64, spl_b64, k, N_ROW,
                                                                     lf.TILE), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            B_BULK * N_ROW * 16 + B_BULK * k * 8 + tiles_b * (2 * k + 1) * 4,
            B_BULK * N_ROW * (4 * log_k + 12))
        t["library_ms"] = None
        t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused_batched(kb64, spl_b64, k=k))
        radix_k4_64_ms = cuda_ms(torch, lambda: lf._level_tiles_kernel(kb64, None, k, N_ROW,
                                                                       lf.TILE, batched=True))
        wb64, wk64 = wide_windows[W]
        t = rows["sort_windows64"]
        kernel_ms(torch, "sort_windows64", t, lambda: bitonic.sort_windows(wb64, wk64, nb=64))
        t["plain_ms"] = cuda_ms(torch, lambda: bitonic.sort_windows_plain(wb64, wk64, nb=64))
        # the work itself, whatever sort does it: 20 B an element (8 B of key
        # and 4 B of bucket in, 4 B of index and 4 B of bucket out) and
        # log2 W compares an element of a comparison sort, ~9 operations
        # each (a 96-bit compare and the select of three words)
        t["bound_ms"], t["bound_by"] = bound_ms(num_w * W * 20, num_w * W * log_w * 9)
        # no one call takes the (bucket, 64-bit key) pairs: the stable sort of
        # the int64 keys of each window, as the 32-bit row's of its packed pairs
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(wk64, dim=1, stable=True))
        # G3's int64 form at double's level 2 (n = 2^24, 257 segments, k2 =
        # 128): 12 B a key
        gen64 = torch.Generator(device=dev).manual_seed(cfg.seed)
        a64_m, o64_m, nb64_m, _ = ips4o.level_pass({"k": keys64}, N_BIG, k, cfg, gen64)
        spl64_m = segment_splitters(a64_m["k"][None], o64_m[None], k2, seed=8)
        t = rows["composite_ids64"]
        kernel_ms(torch, "composite_ids64", t, lambda: glue.composite_ids(
            a64_m["k"][None], o64_m[None], nb64_m, k2, spl64_m))
        t["plain_ms"] = cuda_ms(torch, lambda: glue.composite_ids_plain(
            a64_m["k"][None], o64_m[None], nb64_m, k2, spl64_m), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(
            N_BIG * 12 + o64_m.numel() * 4 + spl64_m.numel() * 8, N_BIG * 4 * (log_k2 + 2))
        # one searchsorted of the keys in every segment's splitters at once
        # (after level 1 the segments' key ranges, and so their sorted
        # splitters, follow one another)
        flat64_m = spl64_m.reshape(-1).contiguous()
        t["library_ms"] = cuda_ms(torch, lambda: torch.searchsorted(flat64_m, a64_m["k"]),
                                  reps=5)
        del flat64_m
        del a64_m, spl64_m
        k3_64_more = {f"{w_.shape[0]} x {w_.shape[1]}": cuda_ms(
            torch, lambda w_=w_, k_=k_: bitonic.sort_windows(w_, k_, nb=64))
            for W_, (w_, k_) in wide_windows.items() if W_ != W}
        for name, call in (("level_fused64", k1_64_call),):
            work = {e.key: e.count for e in one_kernel_a_call(
                torch, name, call, lambda e: any(f in e.key for f in DEVICE_FUNCTIONS[name]))}
            print(f"{name} device work in 10 calls (torch.profiler): {work}", flush=True)
        for what, info in {f"{mode} k={k} tile={tile_}": lf.launch_info(
                k, tile_, mode == "radix", key_bits=64)
                for mode in ("tree", "radix") for tile_ in (lf.TILE, lf.MAX_TILE64)}.items():
            print(f"level_fused64 launch ({what}; cudaFuncGetAttributes): registers "
                  f"{info['registers']} per thread, shared memory {info['static_smem']} "
                  f"static + {info['dynamic_smem']} dynamic B per CTA, {info['threads']} "
                  f"threads, {info['ctas_per_sm']} CTAs an SM at once, local memory "
                  f"{info['local_bytes']} B", flush=True)
        for log2w in range(1, bitonic.MAX_W.bit_length()):
            info = bitonic.launch_info(1 << log2w)
            print(f"sort_windows64 launch (W={1 << log2w}; cudaFuncGetAttributes): registers "
                  f"{info['registers']} per thread, shared memory {info['dynamic_smem']} dynamic "
                  f"B per CTA, {info['threads']} threads, {info['ctas_per_sm']} CTAs an SM at "
                  f"once, local memory {info['local_bytes']} B", flush=True)
            if info["local_bytes"]:
                fail(f"sort_windows64 spills at W={1 << log2w}: {info}")
        del keys64, radix64, kb64, wide_windows

        # K2 and K4: every kernel of one call (at most 5, no torch op over the
        # ids) and the rank kernel's launch
        for name, call in (("rank_hist", k2_call), ("rank_hist_batched", k4_call),
                           ("rank_hist entry point", lambda: lf.rank_hist(
                               comp, tile=k2_tile, **k2_args)),
                           ("rank_hist_batched entry point", lambda: lf.rank_hist_batched(
                               comp_b, tile=k4_tile, **k4_args))):
            per_call, _, kernels_ms = call_kernels(torch, call)
            print(f"{name} device kernels a call (torch.profiler): {per_call:g}; "
                  + ", ".join(f"{k.replace('(anonymous namespace)::', '').split('(')[0]} "
                              f"{v:.4f} ms" for k, v in kernels_ms.items()), flush=True)
            if per_call > 5:
                fail(f"{name} launches {per_call} kernels a call")
        k2_launch = {f"width={2 * k2} tile={k2_tile}": lf.segment_launch_info(2 * k2, k2_tile),
                     f"width={2 * k2b} tile={k4_tile}": lf.segment_launch_info(2 * k2b, k4_tile),
                     f"width={lf.MAX_NB} tile={lf.MAX_TILE}": lf.segment_launch_info(
                         lf.MAX_NB, lf.MAX_TILE)}
        for what, info in k2_launch.items():
            print(f"rank_hist rank kernel launch ({what}; cudaFuncGetAttributes): registers "
                  f"{info['registers']} per thread, shared memory {info['static_smem']} static + "
                  f"{info['dynamic_smem']} dynamic B per CTA, {info['threads']} threads, "
                  f"{info['ctas_per_sm']} CTAs an SM at once, local memory "
                  f"{info['local_bytes']} B", flush=True)

        # K5 at the stream's last tournament round shape class (2^24 + 2^24), on
        # the duplicate-heavy runs: 8 B per output (a key read, a source written),
        # ~6 ops per output (compare, two selects, the source, the store)
        t = rows["merge_path"]
        kernel_ms(torch, "merge_path", t, lambda: mp.merge_path_perm(merge_a, merge_b))
        t["plain_ms"] = cuda_ms(torch, lambda: mp.merge_path_perm_plain(merge_a, merge_b), reps=5)
        t["bound_ms"], t["bound_by"] = bound_ms(2 * N_BIG * 8, 2 * N_BIG * 6)
        merge_cat = torch.cat([merge_a, merge_b])
        t["library_ms"] = cuda_ms(torch, lambda: torch.sort(merge_cat, stable=True), reps=5)

        # K1 and K5: one device kernel per call each (K1's wrapper adds the
        # uppers' fill and cat), and their launches from the CUDA runtime
        k5_call = lambda: mp.merge_path_perm(merge_a, merge_b)
        for name, call in (("level_fused", k1_call), ("merge_path", k5_call)):
            work = {e.key: e.count for e in one_kernel_a_call(
                torch, name, call, lambda e: any(f in e.key for f in DEVICE_FUNCTIONS[name]))}
            print(f"{name} device work in 10 calls (torch.profiler): {work}", flush=True)
        k1_launch = {f"{mode} k={k} tile={lf.TILE}": lf.launch_info(k, lf.TILE, mode == "radix")
                     for mode in ("tree", "radix")}
        k1_launch[f"tree k=512 tile={lf.MAX_TILE}"] = lf.launch_info(512, lf.MAX_TILE)
        k5_launch = {f"tile={tile}": mp.launch_info(tile) for tile in (mp.TILE, mp.MAX_TILE)}
        for name, launches in (("level_fused", k1_launch), ("merge_path", k5_launch)):
            for what, info in launches.items():
                print(f"{name} launch ({what}; cudaFuncGetAttributes): registers "
                      f"{info['registers']} per thread, shared memory {info['static_smem']} "
                      f"static + {info['dynamic_smem']} dynamic B per CTA, {info['threads']} "
                      f"threads, {info['ctas_per_sm']} CTAs an SM at once, local memory "
                      f"{info['local_bytes']} B", flush=True)

        # K6 at its main-path shapes: 8 B per id (id read, dest written) and the
        # starts; ~16 ops per id (the atomicOr, the mask and counter reads,
        # two popcounts, the warp start, the staged rank and the store)
        def k6_call_work(name, call):
            """One call's device kernels (one: the memset of the scratch is
            no kernel) and the memset's device time."""
            is_copy = lambda e: e.key.startswith(("Memcpy", "Memset"))
            events = one_kernel_a_call(torch, name, call, lambda e: not is_copy(e))
            kernels_ms = {e.key: device_us(e) / e.count / 1e3 for e in events if not is_copy(e)}
            memset = [e for e in events if e.key.startswith("Memset")]
            memset_ms = sum(device_us(e) for e in memset) / 1e3 / 10
            print(f"{name} device kernels a call (torch.profiler): 1; "
                  + ", ".join(f"{short_kernel(k)} {v:.4f} ms" for k, v in kernels_ms.items())
                  + f"; memsets a call {sum(e.count for e in memset) / 10:g}, "
                    f"{memset_ms:.4f} ms", flush=True)

        def time_k6(name, call, plain, ids, nb, library):
            t = rows[name]
            kernel_ms(torch, name, t, call)
            t["plain_ms"] = cuda_ms(torch, plain, reps=5)
            t["bound_ms"], t["bound_by"] = bound_ms(ids.numel() * 8 + ids.numel() // ids.shape[-1]
                                                    * nb * 4, ids.numel() * 16)
            t["library_ms"] = cuda_ms(torch, library, reps=5)
            k6_call_work(name, call)

        moe_start = counts_prefix(moe_uniform, MOE_EXPERTS)
        time_k6("dispatch_ranks",
                lambda: dr.dispatch_ranks(moe_uniform, moe_start, num_experts=MOE_EXPERTS),
                lambda: dr.dispatch_ranks_plain(moe_uniform, moe_start, num_experts=MOE_EXPERTS),
                moe_uniform, MOE_EXPERTS, lambda: torch.sort(moe_uniform, stable=True))
        skew_start = counts_prefix(moe_skewed, MOE_EXPERTS)
        skew_call = lambda: dr.dispatch_ranks(moe_skewed, skew_start, num_experts=MOE_EXPERTS)
        skew_ms = cuda_ms(torch, skew_call)
        skew_device_ms = device_ms(torch, skew_call, names=DEVICE_FUNCTIONS["dispatch_ranks"])
        k6_call_work("dispatch_ranks skewed", skew_call)
        time_k6("partition_ranks", lambda: dr.partition_ranks(part_ids, part_start, nb=NB_PART),
                lambda: dr.partition_ranks_plain(part_ids, part_start, nb=NB_PART),
                part_ids, NB_PART, lambda: torch.sort(part_ids, stable=True))
        time_k6("partition_ranks_batched",
                lambda: dr.partition_ranks_batched(rows_ids, rows_start, nb=NB_PART),
                lambda: dr.partition_ranks_batched_plain(rows_ids, rows_start, nb=NB_PART),
                rows_ids, NB_PART, lambda: torch.sort(rows_ids, dim=1, stable=True))
        for nb_, tile_ in ((MOE_EXPERTS, dr.TILE), (NB_PART, dr.TILE), (dr.MAX_NB, dr.TILE)):
            info = dr.launch_info(nb_, tile_)
            print(f"dispatch_rank launch (nb={nb_} tile={tile_}, warps and tile "
                  f"{dr.schedule(nb_, tile_)}; cudaFuncGetAttributes): registers "
                  f"{info['registers']} per thread, shared memory {info['static_smem']} static + "
                  f"{info['dynamic_smem']} dynamic B per CTA, {info['threads']} threads, "
                  f"{info['ctas_per_sm']} CTAs an SM at once, local memory "
                  f"{info['local_bytes']} B", flush=True)

        # K7 at phase 2's shapes: a key read and an id written per element, the
        # uppers and the (tiles, 2k) histogram; tree ~3 ops per search step plus
        # ~6 (eq, the atomic, the store), radix ~8 (xor, shift, mask, the
        # sentinel test, 2j + eq, the atomic)
        def time_k7(name, call, plain, n_keys, key_bytes, k_, tiles, ops_per_key, uppers):
            t = rows[name]
            kernel_ms(torch, name, t, call)
            t["plain_ms"] = cuda_ms(torch, plain, reps=3)
            t["bound_ms"], t["bound_by"] = bound_ms(
                n_keys * (key_bytes + 4) + uppers * 4 + tiles * 2 * k_ * 4, n_keys * ops_per_key)
            t["library_ms"] = None

        # K7's launch by key width (registers, shared memory, CTAs an SM, spills)
        # against classify.schedule
        k7_code = {torch.float32: torch.int32, torch.float64: torch.int64}
        for dtype_ in (torch.uint8, torch.float16, torch.float32, torch.float64):
            for mode in ("tree", "radix") if dtype_ in k7_code else ("tree",):
                k_ = k if mode == "tree" else K_RADIX
                info = cl.launch_info(k7_code[dtype_] if mode == "radix" else dtype_, k_,
                                      mode == "radix")
                sch = cl.schedule(dtype_.itemsize, k_, mode == "radix")
                print(f"K7 launch {mode} {str(dtype_).split('.')[-1]} k={k_}: "
                      f"{info['registers']} registers, {info['dynamic_smem']} dynamic B per CTA, "
                      f"{info['threads']} threads, {info['ctas_per_sm']} CTAs an SM at once, "
                      f"{info['warp_step']} keys a warp step, at most {info['tiles']} tiles a "
                      f"CTA, local memory {info['local_bytes']} B", flush=True)
                if (info["dynamic_smem"], info["threads"], info["warp_step"], info["tiles"]) \
                        != (sch.smem_bytes, sch.threads, sch.warp_step, sch.tiles):
                    fail(f"K7's launch {info} is not classify.schedule's {sch}")

        xf, sf = k7_in["float32 Uniform+specials"], k7_spl["float32 Uniform+specials"]
        tile7 = cl.default_rows(N_BIG, 4, k) * cl.LANES
        time_k7("classify_histogram", lambda: cl.classify_histogram(xf, sf, k=k),
                lambda: cl.classify_histogram_plain(xf, sf, k=k), N_BIG, 4, k, N_BIG // tile7,
                3 * log_k + 6, k)
        time_k7("classify_histogram_batched",
                lambda: cl.classify_histogram_batched(k7_rows, k7_rows_spl, k=k),
                lambda: cl.classify_histogram_batched_plain(k7_rows, k7_rows_spl, k=k),
                B_BULK * N_ROW, 4, k, B_BULK * N_ROW // tile7, 3 * log_k + 6, B_BULK * k)
        tile7r = cl.default_rows(N_BIG, 4, K_RADIX) * cl.LANES
        time_k7("radix_histogram", lambda: cl.radix_histogram(radix7, k=K_RADIX),
                lambda: cl.radix_histogram_plain(radix7, k=K_RADIX), N_BIG, 4, K_RADIX,
                N_BIG // tile7r, 8, 0)
        k7_more = {
            f"classify_histogram {tag}": cuda_ms(torch, lambda tag=tag: cl.classify_histogram(
                k7_in[tag], k7_spl[tag], k=k)) for tag in ("int32 TwoDup", "bfloat16 normal+specials")
        }
        k7_more["radix_histogram_batched"] = cuda_ms(
            torch, lambda: cl.radix_histogram_batched(radix7_rows, k=K_RADIX))
        # the skewed keys of phase 2 beside uniform ones: the histogram's atomics
        # on one address (all equal, one splitter) and the descents' paths
        for tag, x in {"Uniform+specials": xf, **k7_skews}.items():
            skew_ms = device_ms(torch, lambda x=x: cl.classify_histogram(x, sf, k=k),
                                names=DEVICE_FUNCTIONS["classify_histogram"])
            print(f"time classify_histogram float32 {tag} (n={N_BIG}, k={k}): device "
                  f"{skew_ms:.4f} ms", flush=True)

        # K8 and K9 at 2^28 int32 keys, uniform block buckets: every block read
        # once and written once (2 GiB), the dst or the block buckets read; a
        # few ops per block.  Library: the out-of-place gather of the blocks by
        # the stable order (index_select), which is what both compute up to
        # K9's order within a bucket
        body = pb_keys.view(nblocks, BLOCK)
        dst_uniform = bp.stable_block_dest(bb_uniform)
        gather_ms = cuda_ms(torch, lambda: body.index_select(0, block_order), warmup=1, reps=3)
        block_bound = bound_ms(2 * N_BLOCK_KEYS * 4 + nblocks * 4, nblocks * 16)
        t = rows["permute_blocks_by_dest"]
        kernel_ms(torch, "permute_blocks_by_dest", t,
                  lambda: bp.permute_blocks_by_dest(pb_keys, dst_uniform))
        t["plain_ms"] = cuda_ms(torch, lambda: bp.permute_blocks_by_dest_plain(pb_keys, dst_uniform),
                                warmup=1, reps=3)
        t["bound_ms"], t["bound_by"] = block_bound
        t["library_ms"] = gather_ms
        t = rows["permute_blocks_inplace"]
        kernel_ms(torch, "permute_blocks_inplace", t, lambda: pi.permute_blocks_inplace(
            keys9, bb_uniform, d_uniform, k=N_BUCKETS), warmup=1, reps=10, device_reps=5)
        t["plain_ms"] = cuda_ms(torch, lambda: pi.permute_blocks_inplace_plain(
            keys9, bb_uniform, d_uniform, k=N_BUCKETS), warmup=0, reps=1)
        t["bound_ms"], t["bound_by"] = block_bound
        t["library_ms"] = gather_ms
        dst_skewed = bp.stable_block_dest(bb_skewed)
        dst16 = bp.stable_block_dest(bb16)
        order16 = torch.sort(bb16, stable=True).indices
        k8_more = {
            "one cycle through every block": (
                cuda_ms(torch, lambda: bp.permute_blocks_by_dest(pb_keys, one_cycle)),
                cuda_ms(torch, lambda: body.index_select(0, (one_cycle - 2) % nblocks),
                        warmup=1, reps=3)),
            f"blocks of {BLOCK16 * 4} B, uniform": (
                cuda_ms(torch, lambda: bp.permute_blocks_by_dest(pb_keys, dst16,
                                                                 block_elems=BLOCK16)),
                cuda_ms(torch, lambda: pb_keys.view(-1, BLOCK16).index_select(0, order16),
                        warmup=1, reps=3)),
            "half the blocks in one bucket": (
                cuda_ms(torch, lambda: bp.permute_blocks_by_dest(pb_keys, dst_skewed)),
                cuda_ms(torch, lambda: body.index_select(
                    0, torch.sort(bb_skewed, stable=True).indices), warmup=1, reps=3)),
        }
        k9_skew_ms = cuda_ms(torch, lambda: pi.permute_blocks_inplace(
            keys9, bb_skewed, prefix(bb_skewed), k=N_BUCKETS), warmup=1, reps=10)
        del keys9

        # the entry points beside one torch call that does the same
        timed = {}
        for path, (_, cases) in paths.items():
            for name, x, call, kind_ in cases:
                if kind_ == "sort":
                    library = lambda x=x: torch.sort(x, dim=-1, stable=True)
                elif kind_ == "argsort":
                    library = lambda x=x: torch.sort(x, dim=-1, stable=True).indices
                else:
                    library = lambda x=x, big=kind_ == "topk": torch.topk(x, TOP_K, dim=1,
                                                                          largest=big)
                timed[f"{path}: {name}"] = (cuda_ms(torch, lambda call=call, x=x: call(x), reps=5),
                                            cuda_ms(torch, library, reps=5))
        # the new entry points, whole calls (host -> host for the stream), beside
        # the device sort of the whole stream as the yardstick
        stream_dev = ops.keyspace.encode(torch.as_tensor(stream_x, device=dev))
        stream_calls = {
            "external_sort": lambda: stream.external_sort(stream_x, chunk_size=CHUNK),
            "external_argsort": lambda: stream.external_argsort(stream_x, chunk_size=CHUNK),
            f"streaming_topk k={STREAM_K}":
                lambda: stream.streaming_topk(stream_x, STREAM_K, chunk_size=CHUNK),
            f"streaming_bottomk k={STREAM_K}":
                lambda: stream.streaming_topk(stream_x, STREAM_K, chunk_size=CHUNK, largest=False),
        }
        for name, call in stream_calls.items():
            timed[f"stream ({N_STREAM} keys): {name}"] = (
                cuda_ms(torch, call, warmup=0, reps=3),
                cuda_ms(torch, lambda: torch.sort(stream_dev, stable=True), reps=3))
        del stream_dev
        group_dev = torch.as_tensor(group_x, device=dev)
        timed[f"stream ({N_GROUPS} RootDup): streaming_group_by"] = (
            cuda_ms(torch, lambda: stream.streaming_group_by(group_x, chunk_size=CHUNK_GROUPS),
                    warmup=0, reps=3),
            cuda_ms(torch, lambda: torch.unique(group_dev, return_counts=True), reps=3))
        timed[f"group-by ({n_moe} ids): group_by pallas"] = (
            cuda_ms(torch, lambda: ops.group_by(moe_uniform, num_groups=MOE_EXPERTS,
                                                method="pallas"), reps=5),
            cuda_ms(torch, lambda: torch.sort(moe_uniform, stable=True), reps=5))
        timed[f"segmented ({SEGMENTS} segments, {N_BIG} keys): segmented_sort"] = (
            cuda_ms(torch, lambda: ops.segmented_sort(seg_x, seg_off, SEGMENTS), reps=5),
            cuda_ms(torch, lambda: torch.sort(seg_x), reps=5))
        timed[f"block path ({N_BLOCK_KEYS} keys + payload): partition_blocks"] = (
            cuda_ms(torch, lambda: partition_blocks(pb_arrays, pb_bb, N_BUCKETS, BLOCK), reps=5),
            cuda_ms(torch, lambda: torch.sort(pb_keys, stable=True), reps=3))
        timed[f"s3-sort ({N_BIG} float32 with payload): s3_sort"] = (
            cuda_ms(torch, lambda: s3_sort(s3_x, s3_v), reps=5),
            cuda_ms(torch, lambda: torch.sort(s3_x, stable=True), reps=5))
        int64_two = wide_input("int64 TwoDup", N_BIG, seed=53)
        big64 = wide_input("float64", N_HUGE, seed=42)
        huge_cfg = ips4o.SortConfig(kmax=HUGE_KMAX, slack=HUGE_SLACK)
        for name, x, cfg_ in ((f"double ({N_BIG})", double1, cfg),
                              (f"int64 TwoDup ({N_BIG})", int64_two, cfg),
                              (f"double ({N_HUGE}, kmax={HUGE_KMAX}, slack={HUGE_SLACK})", big64,
                               huge_cfg)):
            timed[f"{name}: ops.sort"] = (
                cuda_ms(torch, lambda x=x, c=cfg_: ops.sort(x, cfg=c), reps=5),
                cuda_ms(torch, lambda x=x: torch.sort(x, stable=True), reps=5))
        del big64, int64_two
        timed[f"s3-sort ({N_BIG} float32): ops.sort, the in-place IPS4o path"] = (
            cuda_ms(torch, lambda: ops.sort(s3_x), reps=5),
            cuda_ms(torch, lambda: torch.sort(s3_x, stable=True), reps=5))
        # this slice's entry points, each beside its yardstick (CUDA events,
        # median of 5): records against the LSD cascade of torch.sort, the
        # learned classifier against the tree, the planned merge tile against
        # K5's default in the stream (whole external sort, and one merge of
        # two chunks)
        slice_times = [
            (f"records SkySurvey {tuple(sky_words.shape)}: argsort_records",
             cuda_ms(torch, lambda: ops.argsort_records(sky_words), reps=5),
             "the torch.sort cascade", cuda_ms(torch, lambda: lsd_order(sky_words), reps=5)),
            (f"ops.sort {N_BIG} float32 Uniform, learned",
             cuda_ms(torch, lambda: ops.sort(x_l, classifier="learned"), reps=5),
             "tree", cuda_ms(torch, lambda: ops.sort(x_l), reps=5)),
            (f"ops.sort {N_BIG} float32 Zipf, learned (the fallback)",
             cuda_ms(torch, lambda: ops.sort(learned_inputs["Zipf"], classifier="learned"),
                     reps=5),
             "tree", cuda_ms(torch, lambda: ops.sort(learned_inputs["Zipf"]), reps=5)),
        ]
        no_stream_plan = PlanCache(str(Path(plan_dir.name) / "no_stream_plan.json"))
        no_stream_plan._plans.update({key: v for key, v in pc._plans.items()
                                      if not key.startswith("stream:")})
        slice_times.append((
            f"external_sort {N_PLAN_STREAM} float32 in chunks of {N_PLAN}, planned tile "
            f"{plan_tile}", cuda_ms(torch, lambda: stream.external_sort(
                stream_plan_x, chunk_size=N_PLAN, cache=pc), warmup=1, reps=5),
            f"K5's default tile {mp.TILE}", cuda_ms(torch, lambda: stream.external_sort(
                stream_plan_x, chunk_size=N_PLAN, cache=no_stream_plan), warmup=1, reps=5)))
        run_a, run_b = (torch.sort(x_plan[i::2]).values for i in (0, 1))
        slice_times.append((
            f"stream.merge of two {N_PLAN // 2}-key runs, planned tile {plan_tile}",
            cuda_ms(torch, lambda: stream.merge([run_a, run_b], tile=plan_tile), reps=5),
            f"K5's default tile {mp.TILE}",
            cuda_ms(torch, lambda: stream.merge([run_a, run_b]), reps=5)))
        plan_dir.cleanup()
        # where the new paths' time goes: device time, launches and idle share
        profile(torch, f"ops.sort learned n={N_BIG}", lambda: ops.sort(x_l, classifier="learned"),
                show=DEVICE_FUNCTIONS["level_fused"] + DEVICE_FUNCTIONS["rank_hist"])
        profile(torch, f"ops.argsort_records SkySurvey {tuple(sky_words.shape)}",
                lambda: ops.argsort_records(sky_words),
                show=DEVICE_FUNCTIONS["level_fused"] + DEVICE_FUNCTIONS["rank_hist"])
        del sky_words, learned_inputs, x_l, run_a, run_b, stream_plan_x
        del pb_arrays, pb_keys, body
        torch.cuda.empty_cache()
        level_kernels = DEVICE_FUNCTIONS["level_fused"] + DEVICE_FUNCTIONS["rank_hist"]
        profile(torch, f"stream.external_sort {N_STREAM} keys, chunks of {CHUNK}",
                lambda: stream.external_sort(stream_x, chunk_size=CHUNK), top=10,
                show=level_kernels + DEVICE_FUNCTIONS["merge_path"])
        chunks, runs_ = N_STREAM // CHUNK, N_STREAM // CHUNK
        rounds = 0
        while runs_ > 1:
            runs_, rounds = -(-runs_ // 2), rounds + 1
        print(f"copies external_sort by the shapes: H2D {4 * N_STREAM * rounds} B (the chunks, "
              f"then the spilled runs of rounds 2-{rounds}), D2H {4 * N_STREAM * rounds} B "
              f"({rounds} spills of {4 * N_STREAM} B; {chunks} chunks, {rounds} rounds)",
              flush=True)
        # the main path's profile, every kernel listed; it must run no
        # searchsorted (G2 and G3 took their place), no index_put and no
        # nonzero (G4 took the scatters', G7 the fallback's), copy nothing from
        # the host, and make at most MAIN_PATH_MAX_LAUNCHES kernel launches
        # (counted over ten calls in the active window of ``device_events``: a
        # single trace can drop a call's first launches)
        x_main = paths["1-D tree"][1][0][1]
        profile(torch, f"ops.sort n={N_BIG}", lambda: ops.sort(x_main), top=80)
        _, off_m, nb_m, pad_m = ips4o.partition_passes({"k": ops.keyspace.encode(x_main)}, N_BIG,
                                                       cfg, levels)
        engaged = bool(ips4o.bucket_violations(off_m, nb_m, cfg.base_case, pad_m))
        main_events = device_events(torch, lambda: ops.sort(x_main), reps=10)
        main_kernels = [e for e in main_events if not e.key.startswith(("Memcpy", "Memset"))]
        main_launches = sum(e.count for e in main_kernels) / 10
        banned = {op: sum(e.count for e in main_kernels if op in e.key)
                  for op in ("searchsorted", "index_put", "nonzero")}
        banned["Memcpy HtoD"] = sum(e.count for e in main_events if "Memcpy HtoD" in e.key)
        print(f"profile ops.sort n={N_BIG}: {main_launches:g} kernel launches a call over 10 "
              f"calls (at most {MAIN_PATH_MAX_LAUNCHES}), {banned} (the fallback engaged: "
              f"{engaged})", flush=True)
        for e in sorted(main_kernels, key=device_us, reverse=True):
            print(f"  {device_us(e) / 1e3 / 10:9.4f} ms a call x{e.count / 10:g} {e.key[:100]}")
        if any(banned.values()):
            fail(f"ops.sort n={N_BIG} still runs {banned}")
        if main_launches > MAIN_PATH_MAX_LAUNCHES:
            fail(f"ops.sort n={N_BIG} makes {main_launches:g} kernel launches, more than "
                 f"{MAIN_PATH_MAX_LAUNCHES}")
        profile(torch, f"ops.sort radix int32 n={N_BIG}",
                lambda: ops.sort(radix_int, classifier=radix), show=level_kernels)
        profile(torch, f"ops.sort double n={N_BIG}", lambda: ops.sort(double1),
                show=level_kernels + DEVICE_FUNCTIONS["sort_windows64"])
        profile(torch, f"ops.batched_sort ({B_BULK}, {N_ROW})", lambda: ops.batched_sort(bulk),
                show=level_kernels)
        for name, r in rows.items():
            print(f"time {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), entry "
                  f"point {r.get('wrapper_ms', r['ms']):.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                  f"{r['library_ms']}", flush=True)
        print(f"time level_fused_batched radix ({B_BULK}, {N_ROW}): kernel {radix_k4_ms:.4f} ms",
              flush=True)
        for what, ms_ in glue_more.items():
            print(f"time {what}: {ms_:.4f} ms (CUDA events around the wrapper)", flush=True)
        for what, (ms_, bound_) in g4_device.items():
            print(f"time {what}: device {ms_:.4f} ms, bound {bound_:.4f} ms "
                  f"({bound_ / ms_:.1%} of the bound's rate)", flush=True)
        print(f"time level_fused_batched64 radix ({B_BULK}, {N_ROW}): kernel "
              f"{radix_k4_64_ms:.4f} ms", flush=True)
        for what, ms_ in k3_64_more.items():
            print(f"time sort_windows64 {what}: kernel {ms_:.4f} ms", flush=True)
        print(f"time dispatch_ranks skewed (half on one expert): kernel {skew_ms:.4f} ms "
              f"(device {skew_device_ms:.4f} ms)", flush=True)
        for name, ms_ in k7_more.items():
            print(f"time {name}: kernel {ms_:.4f} ms", flush=True)
        print(f"time permute_blocks_inplace half the blocks in one bucket: kernel "
              f"{k9_skew_ms:.4f} ms", flush=True)
        for tag, (ms_, lib_ms) in k8_more.items():
            print(f"time permute_blocks_by_dest {tag}: kernel {ms_:.4f} ms, index_select "
                  f"{lib_ms:.4f} ms", flush=True)
        for name, (ms, library_ms) in timed.items():
            print(f"time whole {name}: {ms:.3f} ms, torch {library_ms:.3f} ms", flush=True)
        for label, ms, yard, yard_ms in slice_times:
            print(f"time {label}: {ms:.3f} ms, {yard} {yard_ms:.3f} ms", flush=True)

    sort_phases()
    torch.cuda.empty_cache()
    dtype_phases(torch, dev, rows)
    torch.cuda.empty_cache()
    rows.update(attention_phases(torch, dev))
    torch.cuda.empty_cache()
    scheduler_phases(torch, dev, rows)
    family_phases(torch, dev, rows)
    torch.cuda.empty_cache()
    train_phases(torch, dev, rows)
    torch.cuda.empty_cache()
    # last: its process groups (NCCL here, gloo in four spawned ranks) come
    # after every profile of a kernel's launches above
    dist_phases(torch, dev, rows)
    torch.cuda.empty_cache()
    launch_phases(torch, dev, rows)

    # ---- 5. the kernels line and the result ----------------------------------
    meta = {
        "level_fused": ("src/repro_torch/csrc/level_fused.cu",
                        "src/repro/kernels/level_fused.py:160"),
        "rank_hist": ("src/repro_torch/csrc/level_fused.cu",
                      "src/repro/kernels/level_fused.py:311"),
        "sort_windows": ("src/repro_torch/csrc/bitonic.cu",
                         "src/repro/kernels/bitonic.py:72"),
        "level_fused_radix": ("src/repro_torch/csrc/level_fused.cu",
                              "src/repro/kernels/level_fused.py:160"),
        "level_fused_batched": ("src/repro_torch/csrc/level_fused.cu",
                                "src/repro/kernels/level_fused.py:240"),
        "rank_hist_batched": ("src/repro_torch/csrc/level_fused.cu",
                              "src/repro/kernels/level_fused.py:364"),
        "merge_path": ("src/repro_torch/csrc/merge_path.cu",
                       "src/repro/kernels/merge_path.py:157"),
        "dispatch_ranks": ("src/repro_torch/csrc/dispatch_rank.cu",
                           "src/repro/kernels/dispatch_rank.py:87"),
        "partition_ranks": ("src/repro_torch/csrc/dispatch_rank.cu",
                            "src/repro/kernels/dispatch_rank.py:154"),
        "partition_ranks_batched": ("src/repro_torch/csrc/dispatch_rank.cu",
                                    "src/repro/kernels/dispatch_rank.py:224"),
        "classify_histogram": ("src/repro_torch/csrc/classify.cu",
                               "src/repro/kernels/classify.py:100"),
        "classify_histogram_batched": ("src/repro_torch/csrc/classify.cu",
                                       "src/repro/kernels/classify.py:153"),
        "radix_histogram": ("src/repro_torch/csrc/classify.cu",
                            "src/repro/kernels/classify.py:222"),
        "permute_blocks_by_dest": ("src/repro_torch/csrc/block_permute.cu",
                                   "src/repro/kernels/block_permute.py:145"),
        "permute_blocks_inplace": ("src/repro_torch/csrc/permute_inplace.cu",
                                   "src/repro/kernels/permute_inplace.py:148"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:70"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:102"),
        "flash_attention_f32": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:102"),
        "level_fused64": ("src/repro_torch/csrc/level_fused.cu",
                          "src/repro/kernels/level_fused.py:160"),
        "level_fused_radix64": ("src/repro_torch/csrc/level_fused.cu",
                                "src/repro/kernels/level_fused.py:160"),
        "level_fused_batched64": ("src/repro_torch/csrc/level_fused.cu",
                                  "src/repro/kernels/level_fused.py:240"),
        "sort_windows64": ("src/repro_torch/csrc/bitonic.cu",
                           "src/repro/kernels/bitonic.py:72"),
        "merge_path64": ("src/repro_torch/csrc/merge_path.cu",
                         "src/repro/kernels/merge_path.py:157"),
        "classify_histogram8": ("src/repro_torch/csrc/classify.cu",
                                "src/repro/kernels/classify.py:100"),
        "classify_histogram16": ("src/repro_torch/csrc/classify.cu",
                                 "src/repro/kernels/classify.py:100"),
        "classify_histogram64": ("src/repro_torch/csrc/classify.cu",
                                 "src/repro/kernels/classify.py:100"),
        "classify_histogram_batched64": ("src/repro_torch/csrc/classify.cu",
                                         "src/repro/kernels/classify.py:153"),
        "radix_histogram64": ("src/repro_torch/csrc/classify.cu",
                              "src/repro/kernels/classify.py:222"),
        # G1-G4 replace no Pallas kernel: the XLA code of the reference they
        # stand for
        "close_placement": ("src/repro_torch/csrc/glue.cu",
                            "src/repro/kernels/level_fused.py:136"),
        "segment_ids": ("src/repro_torch/csrc/glue.cu", "src/repro/core/ips4o.py:229"),
        "composite_ids": ("src/repro_torch/csrc/glue.cu", "src/repro/classify/tree.py:83"),
        "composite_ids64": ("src/repro_torch/csrc/glue.cu", "src/repro/classify/tree.py:83"),
        "scatter_rows": ("src/repro_torch/csrc/glue.cu", "src/repro/core/ips4o.py:376"),
        "gather_windows": ("src/repro_torch/csrc/glue.cu", "src/repro/core/ips4o.py:246"),
        # G5-G7 replace no Pallas kernel either: the keyspace codec with the
        # pad, the levels' samples, the fallback's verdict and its sort
        "codec_encode": ("src/repro_torch/csrc/codec.cu", "src/repro/ops/keyspace.py:94"),
        "codec_decode": ("src/repro_torch/csrc/codec.cu", "src/repro/ops/keyspace.py:118"),
        "sample_splitters": ("src/repro_torch/csrc/glue.cu", "src/repro/core/ips4o.py:442"),
        "fallback_list": ("src/repro_torch/csrc/fallback.cu", "src/repro/core/ips4o.py:499"),
        "fallback_sort": ("src/repro_torch/csrc/fallback.cu", "src/repro/core/ips4o.py:540"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"launches_by_kind": r["kinds"]} if "kinds" in r else {}),
        })
    print(f"total {time.time() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        compare_with_parent(Path(sys.argv[2]).resolve())
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--parent DIR]")
    else:
        main()
