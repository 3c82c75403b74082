// G1-G4 and G6: the one-device sort's glue between its kernels, by hand for
// Hopper (sm_90a).
//
// These replace no Pallas TPU kernel.  The reference runs this work as XLA
// around its Pallas kernels, and XLA fuses it on the TPU; the port ran it
// as chains of eager torch ops over n-sized int64 index tensors, most of
// the main path's device time (PERF.md).  Each kernel here stands for one
// such chain; the torch chain stays as its plain twin (kernels/glue.py).
//
//   G1 close placement   -- K1/K1r/K4's epilogue (the reference's
//      `_close_placement`, src/repro/kernels/level_fused.py:139): from each
//      row's (tiles, nb) tile histogram, offsets (nb+1) and dest[i] =
//      offsets[b] + sum_{t' < t} hist[t', b] + rank[i] for b = bucket[i],
//      t = i / tile.  Three launches a call: the per-run column sums, the
//      scan down the runs, the place.
//   G2 segment ids       -- `segment_ids` (src/repro/core/ips4o.py:229):
//      id[p] = the last j with offsets[j] <= p, -1 if none (the right
//      searchsorted, less one), over (rows, nb+1) offsets with empty
//      buckets (repeated offsets) and any nb.
//   G3 composite ids     -- level 2's classification (the reference's
//      `classify_segmented`, src/repro/classify/tree.py:83, or its radix
//      bits): seg * 2k + local, with seg as in G2 over the level-1 offsets
//      and local = 2j + (key == upper[j]), j the count of the segment's k-1
//      sorted splitters below the key (tree) or the next log2(k) bits of
//      the reference's code (radix); int32 and int64 keys.
//   G4 move              -- the scatter of the level passes
//      (src/repro/core/ips4o.py:376, `.at[dest].set`) and the base case's
//      window gathers (`_apply_window_perm`, :246): rows of any byte width
//      moved by int32 row-local positions.
//   G6 samples           -- the level passes' samples (src/repro/core/ips4o.py
//      :356-360 and :442-449, `sampling.sample_indices` and
//      `select_splitters`): from the drawn positions (level 1) or uniforms
//      (level 2, mapped into each segment in float32 as torch maps them) to
//      the sorted splitters of each (row, segment), and level 1's upper form
//      with its sentinel.  One CTA a (row, segment) gathers its m keys into
//      shared memory (padded to a power of two with the max), sorts them by
//      a bitonic network and writes the picks.  Latency, not bytes, bounds
//      it: a few hundred bytes a segment against a network of log^2 m steps.
//
// Bound: bytes, every one of them.  G1 reads bucket and rank and writes
// dest, 12 B a key (~60 us at 2^24 and 3.35 TB/s; the histogram, 4 MB at
// 2^24, twice more).  G2 writes 4 B a key (~20 us).  G3 reads the key and
// writes the id: 8 B (int32) or 12 B (int64) a key.  G4 reads the position
// and the row and writes the row: 12 B a 4-byte key.  The arithmetic (a
// short search a position, a log2(k)-step descent a key) is far below the
// integer rate.
//
// Design.
// - G1: the tile histograms (4096 x 257 ints at 2^24) are small, but the
//   scan down the tiles is long and serial per bucket.  Runs of 16 tiles
//   cut it: one CTA a run sums its block of the histogram (contiguous, read
//   flat with a shared atomic a bucket); one CTA a (row, 32 buckets) scans
//   the runs per bucket, 32 threads a bucket each taking a stretch of the
//   runs, and writes each bucket's total; the place kernel, one CTA a tile,
//   scans the totals into the offsets, builds its tile's base row in shared
//   memory from them, its run's prefix and at most 15 earlier tiles of its
//   run (read from the L2), then writes dest with coalesced loads and
//   stores, 16 of each in flight a thread.
// - G2 and G3: one CTA a span of 4096 positions of a row.  A row of up to
//   2048 offsets (level 1's 258) is staged whole in shared memory; else
//   two warps find the span's first and last segment together by 32
//   probes a step over the row's offsets in device memory (4 dependent
//   steps at 65,793 offsets), and the offsets between them, the only ones
//   a position of the span can see, go to shared memory (up to 2048;
//   beyond, the positions search them in device memory).  Each thread then takes 16 positions 256 apart
//   (coalesced) and finds its segment by a binary search of that slice: a
//   step or none where segments are long, and correct where many are empty
//   or short (segmented_sort's).  G3 stages the splitters of the span's
//   segments too (16 KB; beyond, they are read from device memory), and
//   each key descends its segment's k-1 sorted splitters by the
//   branchless count (j += step while spl[j + step - 1] < key).
// - G4: one row is `w` units of U bytes (U the largest power of two up to
//   16 that divides the row and both pointers).  Both kernels move every
//   tensor of the arrays in one launch: a table of up to kMaxMove
//   (pointers, unit, units a row, units staged at once) rides in the
//   kernel's parameters, the launch reads `dest` or `perm` and makes its
//   plan once a span or window, then moves each tensor through the same
//   stage (one launch more each further kMaxMove).  Persistent CTAs of 512
//   threads walk items (span or window, tensor, chunk of units); an item's
//   rows come into a stage of at most 64 KB as they lie, by 16-byte
//   cp.async where aligned, and of two stages the next item's rows are in
//   flight while the current one is written out.
//   The scatter (a level pass's placement, with its offsets): a span's
//   plan finds each row's group (its bucket among the span's) by a lookup
//   table over the span's destinations and its place in the group by one
//   shared atomic, scans the counts, and gives each slot a row and its
//   destination; items are written out slot by slot, a group's rows
//   together, so a warp's stores fall in one or two runs of a bucket's
//   destinations.  Each row carries its own destination, so no order of
//   the atomics and no shape of the placement changes the result; a span
//   whose destinations leave [0, n) or that spans kScatterGroups buckets
//   or more (and a scatter with no offsets) moves row by row, and so does
//   a span of a row of more than kScatterGroups buckets whose destinations
//   lie within kRowWindowBytes of the widest tensor's rows: such stores
//   fall in a stretch of at most 128 KB, which the L2 (50 MB; 264 CTAs'
//   stretches 34 MB) gathers into whole sectors before they reach memory,
//   and the plan costs more than it saves.  The segmented sort's level
//   pass (4096 ragged segments over 2^24 keys, 2k = 8: ~11 buckets of
//   ~500 rows a span) took 0.2033 ms planned against 0.1273 row by row
//   (device time on the H100),
//   0.1385 with the rule at 128 KB (0.1422 at 64 KB); the batched sort's
//   level 2 (rows of 2^18) moves row by row too; level 1 (0.1468 planned,
//   0.3164 row by row) and the 1-D level 2 (0.1868, 0.2858; windows of
//   60K rows and more) are planned (PERF.md §6).  A scratch kernel
//   that moved rows without offsets straight from registers, no stage,
//   was slower at every one of these placements.
//   The span (4096 rows) and the stages (two) were chosen by measurement
//   (PERF.md §6; NVIDIA H100 80GB HBM3, device ms at 2^24 4-byte
//   keys, 1 / 2 stages): level 1 4096 rows 0.1536 / 0.1484, 8192 0.1586 /
//   0.1923, 16,384 0.1946; level 2 0.1927 / 0.1887, 0.1886 / 0.2398,
//   0.2370; keys and an int32 index 0.2230 / 0.2136, 0.2422 / 0.2640,
//   0.2657.  Longer spans hold fewer CTAs an SM (one at 16,384 rows) and
//   lose more than their longer runs of stores gain.
//   Tried on the card and slower: a binary search of all the span's
//   offsets a row (the kernel bound by its instructions), three 32-bit
//   atomics a row for an exact check that each group's destinations are a
//   run, with each slot's destination found again from its group's least
//   by a search of the scanned counts (no destination a slot: the scatter
//   0.2349 ms a launch in ops.sort against 0.1760, PERF.md §6), one
//   64-bit count-and-sum atomic a row, the span's
//   destinations staged a span ahead, the row's offsets sampled in shared
//   memory for level 2's warp searches, and CTAs capped at 40 registers
//   (three an SM).
//   The window gather: an item is a window's rows (or a chunk of units of
//   each, when W rows do not fit the stage; the unit shrinks first, see
//   kernels/glue.py `gather_plan`), written out by the window's
//   permutation, rows of one unit four at a time (perm read 16 bytes a
//   thread, four outputs stored as one access).  Every read of a window
//   precedes every write of it (its stage is complete, behind a barrier,
//   before it is written out), items are disjoint, and windows never
//   straddle rows or pass `limit` (the caller's windows end there), so
//   pass two gathers in place: no second tensor, no copy of the untouched
//   edges.  Two stages: pass two took 0.0695 ms with one and 0.0684 with
//   two (2^24 4-byte keys, the H100; PERF.md §6).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

#include "sort_device.cuh"  // the scans and KeyBits, shared with csrc/level_fused.cu

constexpr int kThreads = 256;          // a CTA of G1's sums and place, G2 and G3
constexpr int kPerThread = 16;         // positions a thread of G1's place, G2 and G3
constexpr int kSpan = kThreads * kPerThread;
constexpr int kMoveThreads = 512;      // a CTA of G4's scatter and gather
constexpr int kMoveRows = 8;           // G4's scatter: source rows a thread of a span
constexpr int kScatterSpan = kMoveRows * kMoveThreads;  // 4096 source rows a span
constexpr int kMaxMove = 64;           // G4: tensors a launch moves
constexpr int kStageBytes = 65536;     // G4: a stage, at most (kernels/glue.py STAGE_BYTES)
constexpr int kStageOffsets = 2048;    // G2/G3: a span's offsets in shared memory
constexpr int kStageSplitBytes = 16384;  // G3: a span's splitters in shared memory
constexpr int kRunTiles = 16;          // G1: tiles a run
constexpr int kScanThreads = 1024;     // G1's scan CTA
constexpr int kScatterGroups = 1024;   // G4's scatter: buckets a staged span, at most
constexpr int kRowWindowBytes = 131072;  // G4's scatter: a span whose destinations lie this close
                                       // moves row by row (rows of the widest tensor)
constexpr int kTableLog = 11;          // G4's scatter: a span's lookup table, 2^11 cells
constexpr int kTableCells = 1 << kTableLog;
constexpr int kSampleThreads = 512;    // G6's CTA, at most

// ---- G1: the placement close of K1, K1r and K4 ----

// 1. One CTA a (row, run of kRunTiles tiles): part[row, run, b] = the run's
// count of bucket b.  The run's histogram rows are one contiguous block.
__global__ void __launch_bounds__(kThreads)
    close_sums_kernel(const int* __restrict__ hist, int tiles, int nb, int runs,
                      int* __restrict__ part) {
  extern __shared__ int s_sum[];
  const int row = blockIdx.x / runs;
  const int run = blockIdx.x - row * runs;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) s_sum[b] = 0;
  __syncthreads();
  const int t0 = run * kRunTiles;
  const int len = (min(t0 + kRunTiles, tiles) - t0) * nb;
  const int* h = hist + ((long long)row * tiles + t0) * nb;
#pragma unroll 4
  for (int f = threadIdx.x; f < len; f += blockDim.x) atomicAdd(&s_sum[f % nb], __ldg(h + f));
  __syncthreads();
  int* out = part + (long long)blockIdx.x * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) out[b] = s_sum[b];
}

// 2. One CTA a (row, group of 32 buckets), 32 x 32 threads: thread (lane,
// y) takes bucket 32 g + lane and the y-th of 32 stretches of the runs.
// part becomes, per bucket, the exclusive prefix over the runs, and
// totals[row, b] the bucket's count.  Every load is coalesced over the
// lanes, and a thread walks at most ceil(runs / 32) runs, twice.
__global__ void __launch_bounds__(kScanThreads)
    close_scan_kernel(int* __restrict__ part, int runs, int nb, int groups,
                      int* __restrict__ totals) {
  __shared__ int s_part[32][33];
  const int row = blockIdx.x / groups;
  const int lane = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  const int b = (blockIdx.x - row * groups) * 32 + lane;
  int* p = part + (long long)row * runs * nb + b;
  const int per = (runs + 31) / 32;
  const int r0 = min(y * per, runs);
  const int r1 = min(r0 + per, runs);
  int acc = 0;
  if (b < nb) {
    for (int r = r0; r < r1; r += 8) {  // 8 loads in flight
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = r + j < r1 ? p[(long long)(r + j) * nb] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += v[j];
    }
  }
  s_part[y][lane] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {  // each lane's exclusive scan down its stretches
    int run = 0;
    for (int yy = 0; yy < 32; ++yy) {
      const int v = s_part[yy][lane];
      s_part[yy][lane] = run;
      run += v;
    }
    if (b < nb) totals[(long long)row * nb + b] = run;
  }
  __syncthreads();
  if (b < nb) {
    int run = s_part[y][lane];
    for (int r = r0; r < r1; r += 8) {  // 8 loads in flight, then their stores
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = r + j < r1 ? p[(long long)(r + j) * nb] : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (r + j < r1) p[(long long)(r + j) * nb] = run;
        run += v[j];
      }
    }
  }
}

// 3. One CTA a (row, tile): the row's offsets by a scan of the bucket
// totals (the tile-0 CTA writes them out), the tile's base row in shared
// memory (offset + the runs before + the earlier tiles of its run), then
// dest = base[bucket] + rank over the tile's positions, 16 loads of each in
// flight a thread.  A bucket outside [0, nb) (never from K1) gets dest -1.
__global__ void __launch_bounds__(kThreads)
    close_place_kernel(const int* __restrict__ bucket, const int* __restrict__ rank,
                       const int* __restrict__ hist, const int* __restrict__ part,
                       const int* __restrict__ totals, int n, int tile, int tiles, int nb,
                       int runs, int* __restrict__ offsets, int* __restrict__ dest) {
  extern __shared__ int s_base[];
  __shared__ int warp_sums[33];
  const int row = blockIdx.x / tiles;
  const int t = blockIdx.x - row * tiles;
  const int run = t / kRunTiles;
  const int* h = hist + (long long)row * tiles * nb;
  const int* pr = part + ((long long)row * runs + run) * nb;
  const int* tot = totals + (long long)row * nb;
  int* off = offsets + (long long)row * (nb + 1);
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {  // the same trips for the whole CTA
    const int b = b0 + threadIdx.x;
    int total;
    const int excl = block_exclusive_scan(b < nb ? tot[b] : 0, warp_sums, &total);
    if (b < nb) {
      int v = carry + excl;
      if (t == 0) off[b] = v;
      v += pr[b];
      for (int u = run * kRunTiles; u < t; ++u) v += h[(long long)u * nb + b];
      s_base[b] = v;
    }
    carry += total;
  }
  if (t == 0 && threadIdx.x == 0) off[nb] = carry;
  __syncthreads();
  const long long start = (long long)row * n + (long long)t * tile;
  const int len = min(tile, n - t * tile);
  for (int i0 = 0; i0 < len; i0 += kThreads * kPerThread) {
    int bk[kPerThread], rk[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      bk[j] = i < len ? __ldg(bucket + start + i) : 0;
      rk[j] = i < len ? __ldg(rank + start + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      if (i < len) dest[start + i] = (unsigned)bk[j] < (unsigned)nb ? s_base[bk[j]] + rk[j] : -1;
    }
  }
}

// ---- G2 and G3: a position's segment ----

// The count of off[0..m) that are <= p (off nondecreasing), by the whole
// warp: 32 probes a step, the gap between the last true and the first false
// probe kept.  Every lane returns it.
__device__ int warp_count_le(const int* off, int m, int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = m;  // the count is in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, idx < hi && off[idx] <= p));
    if (c == 0) return lo;
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = next_lo;
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(kFull, idx < hi && off[idx] <= p));
}

// Each of a thread's PER positions p0 + j * kThreads + threadIdx.x gets
// c[j] = the count of slice[0..len) that are <= it (slice nondecreasing), by
// the branchless binary search from the largest power of two <= len down,
// every position's step in flight together.
template <int PER>
__device__ __forceinline__ void span_counts(const int* slice, int len, int p0, int (&c)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) c[j] = 0;
  for (int step = len == 0 ? 0 : 1 << (31 - __clz(len)); step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int q = c[j] + step;
      if (q <= len && slice[q - 1] <= p0 + j * kThreads + (int)threadIdx.x) c[j] = q;
    }
  }
}

// The count of a[0..len) that are <= p (a nondecreasing), by one thread.
__device__ int count_le(const int* a, int len, int p) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A span's view of its row's offsets: c_lo = the count <= the span's first
// position, and the slice off[c_lo, c_hi) that its later positions can see,
// in s_off when it fits.  A row of at most kStageOffsets offsets is staged
// whole at once (no search in device memory); else warps 0 and 1 find c_lo
// and c_hi together.  Every thread of the CTA calls it.
struct SpanOffsets {
  const int* slice;
  int c_lo, len;
};

__device__ SpanOffsets span_offsets(const int* off, int m, int p0, int p1, int* s_off,
                                    int* s_c) {
  if (m <= kStageOffsets) {  // the same for the whole CTA
    for (int i = threadIdx.x; i < m; i += blockDim.x) s_off[i] = off[i];
    __syncthreads();
    if (threadIdx.x == 0) s_c[0] = count_le(s_off, m, p0);
    if (threadIdx.x == 32) s_c[1] = count_le(s_off, m, p1 - 1);
    __syncthreads();
    return SpanOffsets{s_off + s_c[0], s_c[0], s_c[1] - s_c[0]};
  }
  if (threadIdx.x < 64) {
    const int c = warp_count_le(off, m, threadIdx.x < 32 ? p0 : p1 - 1);
    if ((threadIdx.x & 31) == 0) s_c[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  SpanOffsets s{off + s_c[0], s_c[0], s_c[1] - s_c[0]};
  if (s.len <= kStageOffsets) {  // the same for the whole CTA
    for (int i = threadIdx.x; i < s.len; i += blockDim.x) s_off[i] = s.slice[i];
    __syncthreads();
    s.slice = s_off;
  }
  return s;
}

// G2: one CTA a span of kSpan positions of a row; out (rows, n).
__global__ void __launch_bounds__(kThreads)
    segment_ids_kernel(const int* __restrict__ offsets, int m, int n, int spans,
                       int* __restrict__ out) {
  __shared__ int s_off[kStageOffsets];
  __shared__ int s_c[2];
  const int row = blockIdx.x / spans;
  const int p0 = (blockIdx.x - row * spans) * kSpan;
  const int p1 = min(p0 + kSpan, n);
  const SpanOffsets s = span_offsets(offsets + (long long)row * m, m, p0, p1, s_off, s_c);
  int c[kPerThread];
  span_counts(s.slice, s.len, p0, c);
  int* o = out + (long long)row * n;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = p0 + j * kThreads + threadIdx.x;
    if (p < p1) o[p] = s.c_lo + c[j] - 1;
  }
}

// G3's keys a thread: 16 of 32 bits, 8 of 64 (the same registers).
template <typename Key>
struct KeysPerThread {
  static constexpr int value = sizeof(Key) == 8 ? kPerThread / 2 : kPerThread;
};

// G3: one CTA a span of kThreads * kPer positions of a row (kPer keys a
// thread: 16 of 32 bits, 8 of 64, the same registers).  keys (rows, n); seg_off
// (rows, num_seg + 1); tree mode: splitters (rows, num_seg, k-1) sorted per
// segment; radix mode: none, the bits at `shift`.  out (rows, n) int32.
template <typename Key, bool kRadix>
__global__ void __launch_bounds__(kThreads)
    composite_ids_kernel(const Key* __restrict__ keys, const int* __restrict__ seg_off,
                         const Key* __restrict__ splitters, int num_seg, int n, int k, int shift,
                         int spans, int* __restrict__ out) {
  constexpr int kPer = KeysPerThread<Key>::value;
  constexpr int kKeySpan = kThreads * kPer;
  __shared__ int s_off[kStageOffsets];
  __shared__ int s_c[2];
  __shared__ Key s_spl[kStageSplitBytes / sizeof(Key)];
  const int row = blockIdx.x / spans;
  const int p0 = (blockIdx.x - row * spans) * kKeySpan;
  const int p1 = min(p0 + kKeySpan, n);
  const int m = num_seg + 1;
  const SpanOffsets s = span_offsets(seg_off + (long long)row * m, m, p0, p1, s_off, s_c);
  const int per = k - 1;  // splitters a segment
  // the span's segments [g_lo, g_hi] (clamped: a position outside every
  // segment breaks the caller's contract, and reads no splitter out of range)
  const int g_lo = min(max(s.c_lo - 1, 0), num_seg - 1);
  const int g_hi = min(max(s.c_lo + s.len - 1, 0), num_seg - 1);
  const Key* spl = nullptr;
  int g_base = 0;
  if (!kRadix) {
    spl = splitters + ((long long)row * num_seg) * per;
    const long long staged = (long long)(g_hi - g_lo + 1) * per;
    if (staged * (long long)sizeof(Key) <= kStageSplitBytes) {  // the same for the whole CTA
      const Key* from = spl + (long long)g_lo * per;
      for (int i = threadIdx.x; i < staged; i += blockDim.x) s_spl[i] = from[i];
      __syncthreads();
      spl = s_spl;
      g_base = g_lo;
    }
  }
  const Key* row_keys = keys + (long long)row * n;
  Key key[kPer];  // every key load in flight before the searches
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * kThreads + threadIdx.x;
    key[j] = p < p1 ? __ldg(row_keys + p) : Key(0);
  }
  int c[kPer];
  span_counts(s.slice, s.len, p0, c);
  int local[kPer];
  if (kRadix) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      local[j] = 2 * (int)(KeyBits<Key>::digits(key[j], shift) & (unsigned)(k - 1)) +
                 (key[j] == KeyBits<Key>::kMax ? 1 : 0);
    }
  } else {
    int at[kPer];  // the segment's first splitter in spl
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      at[j] = (min(max(s.c_lo + c[j] - 1, 0), num_seg - 1) - g_base) * per;
      local[j] = 0;
    }
    for (int step = k >> 1; step > 0; step >>= 1) {  // the descents interleaved
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        local[j] += spl[at[j] + local[j] + step - 1] < key[j] ? step : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const Key up = local[j] < per ? spl[at[j] + local[j]] : KeyBits<Key>::kMax;
      local[j] = 2 * local[j] + (key[j] == up ? 1 : 0);
    }
  }
  int* o = out + (long long)row * n;
  const int width = 2 * k;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j * kThreads + threadIdx.x;
    if (p < p1) o[p] = (s.c_lo + c[j] - 1) * width + local[j];
  }
}

// ---- G4: the move kernel ----

// The units of a row as the kernels move them.
template <int kBytes>
struct Unit;
template <>
struct Unit<1> { using T = unsigned char; };
template <>
struct Unit<2> { using T = unsigned short; };
template <>
struct Unit<4> { using T = unsigned; };
template <>
struct Unit<8> { using T = uint2; };
template <>
struct Unit<16> { using T = uint4; };

// Four consecutive units in registers, stored as one access of 4 or 8 bytes
// or as 16-byte pieces.
template <int kBytes>
struct Vec;
template <>
struct Vec<4> { using T = unsigned; };
template <>
struct Vec<8> { using T = uint2; };
template <>
struct Vec<16> { using T = uint4; };

template <typename U>
struct Quad {
  static constexpr int kBytes = 4 * (int)sizeof(U);
  static constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  static constexpr int kPieces = kBytes / kPiece;
  using V = typename Vec<kPiece>::T;
  union {
    U u[4];
    V p[kPieces];
  };
};

template <typename U>
__device__ __forceinline__ void store_quad(U* at, const Quad<U>& q) {
  auto* v = reinterpret_cast<typename Quad<U>::V*>(at);
#pragma unroll
  for (int i = 0; i < Quad<U>::kPieces; ++i) v[i] = q.p[i];
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ void cp_async16(void* to_shared, const void* from) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(from) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tensors one G4 launch moves (kernels/glue.py `_table`): each row of a
// tensor is w units of `unit` bytes, and a stage holds `chunk` units of
// every row of a span or window at once.
struct MoveTable {
  const void* src[kMaxMove];
  void* dst[kMaxMove];
  int unit[kMaxMove];   // 1, 2, 4, 8 or 16
  int w[kMaxMove];      // units a row
  int chunk[kMaxMove];  // units of a row a stage holds, 1..w
  int count;
};

// ---- G4's items ----
//
// A launch's work is a list of items, (span or window q, tensor a, chunk
// c0): the rows of q, units [c0, c0 + chunk) of tensor a.  A CTA's items:
// its spans or windows q = blockIdx.x + i gridDim.x, every tensor and chunk
// of each in turn.
struct Item {
  int q, a, c0;
};

__device__ __forceinline__ Item next_item(const MoveTable& t, Item it) {
  it.c0 += t.chunk[it.a];
  if (it.c0 >= t.w[it.a]) {
    it.c0 = 0;
    if (++it.a == t.count) it.a = 0, it.q += gridDim.x;
  }
  return it;
}

// Bring an item's `rows` rows from `first` into a stage, row r's units at
// r * chunk: where the item is every unit of the rows (chunk == w), one
// block of bytes copied by 16-byte cp.async when it is aligned (waited for
// by the caller); else unit by unit, coalesced.
template <typename U>
__device__ __forceinline__ void stage_rows(const MoveTable& t, const Item& it, long long first,
                                           int rows, unsigned char* buf) {
  const int w = t.w[it.a];
  const int cw = min(t.chunk[it.a], w - it.c0);
  const U* src = static_cast<const U*>(t.src[it.a]) + first * w;
  const int bytes = rows * w * (int)sizeof(U);
  if (cw == w && aligned(src, 16) && (bytes & 15) == 0) {
    const unsigned char* from = reinterpret_cast<const unsigned char*>(src);
    for (int i = threadIdx.x; i < bytes / 16; i += kMoveThreads)
      cp_async16(buf + 16 * i, from + 16 * i);
    cp_async_commit();
    return;
  }
  U* st = reinterpret_cast<U*>(buf);
  const int units = rows * cw;
#pragma unroll 4
  for (int f = threadIdx.x; f < units; f += kMoveThreads) {
    const int j = cw == 1 ? f : f / cw;
    st[f] = src[(long long)j * w + it.c0 + (f - j * cw)];
  }
}

// ---- G4's scatter ----
//
// Thread t of a CTA of kMoveThreads reads the span's destinations in quads
// of 4 consecutive rows, quad j at row 4 (j kMoveThreads + t): one 16-byte
// load where the span and the pointer allow (rows past the span: -1).  A
// span's destinations are read from device memory once; the later passes
// over them hit the L2.
__device__ __forceinline__ int4 span_quad(const int* ds, int j, int rows_here, bool vec) {
  const int r = 4 * (j * kMoveThreads + (int)threadIdx.x);
  if (vec && r + 4 <= rows_here) return __ldg(reinterpret_cast<const int4*>(ds + r));
  int4 x;
  x.x = r < rows_here ? __ldg(ds + r) : -1;
  x.y = r + 1 < rows_here ? __ldg(ds + r + 1) : -1;
  x.z = r + 2 < rows_here ? __ldg(ds + r + 2) : -1;
  x.w = r + 3 < rows_here ? __ldg(ds + r + 3) : -1;
  return x;
}

// A span of the scatter: kScatterSpan source rows of a row of n.
struct Span {
  int row, rows_here;
  long long row0, first;  // the row's first position, the span's
  const int* ds;          // the span's destinations
  bool vec;               // they load 16 bytes at a time
};

__device__ __forceinline__ Span span_of(int sp, int spans, int n, const int* dest) {
  Span s;
  s.row = sp / spans;
  const int p0 = (sp - s.row * spans) * kScatterSpan;
  s.rows_here = min(kScatterSpan, n - p0);
  s.row0 = (long long)s.row * n;
  s.first = s.row0 + p0;
  s.ds = dest + s.first;
  s.vec = (s.first & 3) == 0 && aligned(s.ds, 16);
  return s;
}

// The shared memory of a scatter CTA besides its stages.
struct ScatterShared {
  int* off;               // kScatterGroups: the span's offsets
  int* cnt;               // kScatterGroups: a group's count, then its first slot
  unsigned short* row;    // kScatterSpan: a slot's row
  int* to;                // kScatterSpan: a slot's destination
  int* tab;               // kTableCells + 2: the lookup table of the span's groups
  int* c;                 // 4: the warp searches' counts, the span's least and greatest
  int* warp_sums;         // 33
};

// The span's plan: with the row's offsets (m = nb + 1 of them) each row's
// group (its bucket among the span's: the row's offsets whole up to
// kScatterGroups, else those between the span's least and greatest
// destination, by a warp search each) by a lookup table over the span's
// destinations (kTableCells cells of a power of two positions, each cell's
// count of offsets below it; a row searches only the offsets in its cell,
// at most one at the main path's bucket sizes: a binary search of all the
// span's offsets made the kernel bound by its instructions), and its
// place in the group by one shared atomic (a count: the order among a
// group's rows is the atomics' own); one scan of the counts,
// each group's first slot; each row's slot, first + place, gets the row
// and its destination.  A group's slots thus hold its rows, and of a
// stable placement's span, whose rows of a bucket land on consecutive
// destinations, its run of destinations: written out slot by slot, a
// warp's stores fall in a few runs.  Each row still goes to its own
// destination, so the result does not depend on the atomics' order, nor
// on the destinations being runs.  Returns false (for the whole CTA) where
// the span moves row by row: no offsets, a destination outside [0, n),
// kScatterGroups buckets or more, or (where the row has more offsets than
// kScatterGroups, so that the span's least and greatest destination are
// found anyway) destinations within `window` positions of each other: their
// stores, row by row, fall in a stretch the L2 gathers into whole sectors,
// and the plan would cost more than it saves (see the header).
__device__ __forceinline__ bool plan_span(const Span& s, const int* offsets, int m, int n,
                                          int window, const ScatterShared& sh) {
  constexpr int Q = kMoveRows / 4;
  const int tid = threadIdx.x;
  if (offsets == nullptr) return false;
  const int* off = offsets + (long long)s.row * m;
  int c_lo = 0, len = m - 1;  // the span's groups: counts of off[c_lo, c_lo + len) <= d
  if (m > kScatterGroups) {
    // the span's least and greatest destination, then the offsets <= each
    int lo = INT_MAX, hi = -1;
    bool ok = true;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      const int4 x = span_quad(s.ds, j, s.rows_here, s.vec);
      const int d[4] = {x.x, x.y, x.z, x.w};
      const int r = 4 * (j * kMoveThreads + tid);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (r + e >= s.rows_here) continue;
        if ((unsigned)d[e] >= (unsigned)n) ok = false;
        lo = min(lo, d[e]), hi = max(hi, d[e]);
      }
    }
    if (!__syncthreads_and(ok)) return false;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if ((tid & 31) == 0) sh.warp_sums[tid >> 5] = lo, sh.warp_sums[16 + (tid >> 5)] = hi;
    __syncthreads();
    if (tid < 64) {
      const int w = tid & 15;
      lo = w < kMoveThreads / 32 ? sh.warp_sums[w] : INT_MAX;
      hi = w < kMoveThreads / 32 ? sh.warp_sums[16 + w] : -1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(kFull, lo, o));
        hi = max(hi, __shfl_xor_sync(kFull, hi, o));
      }
      const int x = tid < 32 ? lo : hi;
      // a window of destinations this short moves row by row: no search
      const int c = hi - lo < window ? 0 : warp_count_le(off, m, x);
      if ((tid & 31) == 0) sh.c[tid >> 5] = c, sh.c[2 + (tid >> 5)] = x;  // counts, lo, hi
    }
    __syncthreads();
    if (sh.c[3] - sh.c[2] < window) return false;
    c_lo = sh.c[0];
    len = sh.c[1] - c_lo;
  }
  if (len >= kScatterGroups) return false;
  // the lookup table over the span's destinations [lo, hi]: cells of 2^shift
  // positions, tab[c] = the offsets below cell c's first position
  const int lo = m > kScatterGroups ? sh.c[2] : 0;
  const int cells = m > kScatterGroups ? sh.c[3] - lo + 1 : n;
  const int shift = cells > kTableCells ? 32 - __clz(cells - 1) - kTableLog : 0;
  for (int i = tid; i <= kTableCells + 1; i += kMoveThreads) sh.tab[i] = 0;
  __syncthreads();
  for (int i = tid; i <= len; i += kMoveThreads) {
    if (i < len) {
      const int v = off[c_lo + i];
      sh.off[i] = v;
      atomicAdd(&sh.tab[v < lo ? 0 : min(((v - lo) >> shift) + 1, kTableCells + 1)], 1);
    }
    sh.cnt[i] = 0;
  }
  __syncthreads();
  {  // the inclusive scan of tab[0, kTableCells], kTableCells / kMoveThreads a thread
    constexpr int kPer = kTableCells / kMoveThreads;
    int v[kPer], sum = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) sum += (v[e] = sh.tab[kPer * tid + e]);
    const int last = sh.tab[kTableCells];
    int all;
    int run = block_exclusive_scan(sum, sh.warp_sums, &all);
#pragma unroll
    for (int e = 0; e < kPer; ++e) sh.tab[kPer * tid + e] = (run += v[e]);
    if (tid == 0) sh.tab[kTableCells] = all + last;
  }
  __syncthreads();
  bool ok = true;
  int place[kMoveRows];  // a row's group << 16 | its place in the group
#pragma unroll
  for (int j = 0; j < Q; ++j) {  // a quad's four lookups in flight together
    const int4 x = span_quad(s.ds, j, s.rows_here, s.vec);
    const int d[4] = {x.x, x.y, x.z, x.w};
    const int r = 4 * (j * kMoveThreads + tid);
    int g[4], more[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = min(max((d[e] - lo) >> shift, 0), kTableCells - 1);
      g[e] = sh.tab[c];
      more[e] = sh.tab[c + 1] - g[e];  // the offsets in the cell: the count of them <= d
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int k = 0;
      for (int step = more[e] == 0 ? 0 : 1 << (31 - __clz(more[e])); step > 0; step >>= 1) {
        if (k + step <= more[e] && sh.off[g[e] + k + step - 1] <= d[e]) k += step;
      }
      g[e] += k;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      place[4 * j + e] = 0;
      if (r + e >= s.rows_here) continue;
      if ((unsigned)d[e] >= (unsigned)n) {
        ok = false;
        continue;
      }
      place[4 * j + e] = (g[e] << 16) | atomicAdd(&sh.cnt[g[e]], 1);
    }
  }
  if (!__syncthreads_and(ok)) return false;
  int carry = 0;
  for (int i0 = 0; i0 <= len; i0 += kMoveThreads) {  // the same trips for the whole CTA
    const int i = i0 + tid;
    int all;
    const int excl = block_exclusive_scan(i <= len ? sh.cnt[i] : 0, sh.warp_sums, &all);
    if (i <= len) sh.cnt[i] = carry + excl;
    carry += all;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int4 x = span_quad(s.ds, j, s.rows_here, s.vec);
    const int d[4] = {x.x, x.y, x.z, x.w};
    const int r = 4 * (j * kMoveThreads + tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (r + e >= s.rows_here) continue;
      const int slot = sh.cnt[place[4 * j + e] >> 16] + (place[4 * j + e] & 0xffff);
      sh.row[slot] = (unsigned short)(r + e);
      sh.to[slot] = d[e];
    }
  }
  __syncthreads();
  return true;
}

// Write an item out of its stage.  Planned: slot by slot, the slot's row
// (its units [c0, c0 + cw)) to the slot's destination, a group's rows
// together.  Row by row otherwise: each row whose destination lies in [0,
// n).
template <typename U>
__device__ __forceinline__ void scatter_out(const MoveTable& t, const Item& it, const Span& s,
                                            int n, bool planned, const unsigned char* buf,
                                            const ScatterShared& sh) {
  const int w = t.w[it.a];
  const int cw = min(t.chunk[it.a], w - it.c0);
  U* dst = static_cast<U*>(t.dst[it.a]) + s.row0 * w + it.c0;
  const U* st = reinterpret_cast<const U*>(buf);
  if (planned && w == 1) {
#pragma unroll 4
    for (int q = threadIdx.x; q < s.rows_here; q += kMoveThreads) dst[sh.to[q]] = st[sh.row[q]];
    return;
  }
  if (planned) {
    const int units = s.rows_here * cw;
#pragma unroll 4
    for (int f = threadIdx.x; f < units; f += kMoveThreads) {
      const int q = cw == 1 ? f : f / cw;
      const int u = f - q * cw;
      dst[(long long)sh.to[q] * w + u] = st[sh.row[q] * cw + u];
    }
    return;
  }
#pragma unroll 2
  for (int j = 0; j < kMoveRows / 4; ++j) {
    const int4 x = span_quad(s.ds, j, s.rows_here, s.vec);
    const int d[4] = {x.x, x.y, x.z, x.w};
    const int r = 4 * (j * kMoveThreads + (int)threadIdx.x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((unsigned)d[e] >= (unsigned)n) continue;
      for (int u = 0; u < cw; ++u) dst[(long long)d[e] * w + u] = st[(r + e) * cw + u];
    }
  }
}

__device__ __forceinline__ void scatter_item_in(const MoveTable& t, const Item& it,
                                                const Span& s, unsigned char* buf) {
  switch (t.unit[it.a]) {
#define IN(B) \
  case B: stage_rows<Unit<B>::T>(t, it, s.first, s.rows_here, buf); break;
    IN(1) IN(2) IN(4) IN(8) IN(16)
#undef IN
  }
}

__device__ __forceinline__ void scatter_item_out(const MoveTable& t, const Item& it,
                                                 const Span& s, int n, bool planned,
                                                 const unsigned char* buf,
                                                 const ScatterShared& sh) {
  switch (t.unit[it.a]) {
#define OUT(B) \
  case B: scatter_out<Unit<B>::T>(t, it, s, n, planned, buf, sh); break;
    OUT(1) OUT(2) OUT(4) OUT(8) OUT(16)
#undef OUT
  }
}

// The scatter of every tensor of the table by one placement: persistent
// CTAs walk their items (span, tensor, chunk) of spans of kScatterSpan
// source rows.  An item's rows come into a stage by cp.async (a block of
// bytes) as they are; the span's plan (plan_span) gives each slot a row and
// its destination, and the item is written out slot by slot from the stage.
// Of the two stages, the next item's rows are in flight while the current
// one is written out, and the next span's first rows while its plan is
// made.  (Bringing each span's destinations into shared memory a span ahead
// as well was slower, on the H100.)
__global__ void __launch_bounds__(kMoveThreads, 2)
    scatter_kernel(const __grid_constant__ MoveTable t, const int* __restrict__ dest,
                   const int* __restrict__ offsets, int m, int n, int spans, int total,
                   int stage_bytes, int window) {
  static_assert(kMoveRows % 4 == 0 && kScatterSpan <= 65536, "a span's rows in 16 bits");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_c[4];
  __shared__ int warp_sums[33];
  ScatterShared sh;
  sh.to = reinterpret_cast<int*>(smem + 2 * stage_bytes);
  sh.off = sh.to + kScatterSpan;
  sh.cnt = sh.off + kScatterGroups;
  sh.tab = sh.cnt + kScatterGroups;
  sh.row = reinterpret_cast<unsigned short*>(sh.tab + kTableCells + 2);
  sh.c = s_c;
  sh.warp_sums = warp_sums;
  Item it{(int)blockIdx.x, 0, 0};
  if (it.q >= total) return;
  Span s = span_of(it.q, spans, n, dest);
  scatter_item_in(t, it, s, smem);
  bool planned = plan_span(s, offsets, m, n, window, sh);
  for (int i = 0;; ++i) {
    const Item nx = next_item(t, it);
    const bool more = nx.q < total;
    const Span ns = nx.q == it.q ? s : span_of(nx.q, spans, n, dest);
    cp_async_wait_all();
    __syncthreads();  // the item staged; the other stage's last reader done
    if (more) scatter_item_in(t, nx, ns, smem + ((i + 1) & 1) * stage_bytes);
    scatter_item_out(t, it, s, n, planned, smem + (i & 1) * stage_bytes, sh);
    if (!more) break;
    __syncthreads();  // the stage and the span's plan read
    if (nx.q != it.q) planned = plan_span(ns, offsets, m, n, window, sh);
    it = nx;
    s = ns;
  }
}

int scatter_smem(int stage_bytes) {
  return 2 * stage_bytes + 2 * kScatterGroups * 4 + (kTableCells + 2) * 4 + 6 * kScatterSpan;
}

// ---- G4's window gather ----

// Write an item out of the stage by the window's permutation: rows of one
// unit four at a time (perm read 16 bytes a thread, four outputs stored as
// one access); else unit by unit.
template <typename U>
__device__ __forceinline__ void gather_store(const MoveTable& t, const Item& it, long long first,
                                             int W, const int* pw, const unsigned char* buf) {
  const int w = t.w[it.a];
  const int cw = min(t.chunk[it.a], w - it.c0);
  U* dst = static_cast<U*>(t.dst[it.a]) + first * w;
  const U* st = reinterpret_cast<const U*>(buf);
  if (w == 1 && (W & 3) == 0 && aligned(dst, 4 * sizeof(U)) && aligned(pw, 16)) {
#pragma unroll 2
    for (int e = threadIdx.x; e < W / 4; e += kMoveThreads) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(pw) + e);
      Quad<U> o;
      o.u[0] = st[p.x], o.u[1] = st[p.y], o.u[2] = st[p.z], o.u[3] = st[p.w];
      store_quad(dst + 4 * e, o);
    }
    return;
  }
  const int units = W * cw;
#pragma unroll 4
  for (int f = threadIdx.x; f < units; f += kMoveThreads) {
    const int j = cw == 1 ? f : f / cw;
    const int u = f - j * cw;
    dst[(long long)j * w + it.c0 + u] = st[__ldg(pw + j) * cw + u];
  }
}

template <bool kLoad>
__device__ __forceinline__ void gather_item(const MoveTable& t, const Item& it, const int* perm,
                                            int per_row, int n, int W, int lo,
                                            unsigned char* buf) {
  const int row = it.q / per_row;
  const long long first = (long long)row * n + lo + (long long)(it.q - row * per_row) * W;
  const int* pw = perm + (long long)it.q * W;
  switch (t.unit[it.a]) {
#define ITEM(B)                                               \
  case B:                                                     \
    if (kLoad) stage_rows<Unit<B>::T>(t, it, first, W, buf);  \
    else gather_store<Unit<B>::T>(t, it, first, W, pw, buf);  \
    break;
    ITEM(1) ITEM(2) ITEM(4) ITEM(8) ITEM(16)
#undef ITEM
  }
}

// The window gather of every tensor of the table: window q of row q /
// per_row covers positions [lo + (q % per_row) W, + W) of its row of n;
// perm (windows, W) window-local.  Persistent CTAs walk their items with two
// stages: the next item's loads are in flight while the current one is
// written.  Every read of an item precedes every write of it (the stage is
// complete, behind a barrier, before it is written out), and items are
// disjoint, so src may be dst (pass two, in place).
__global__ void __launch_bounds__(kMoveThreads)
    gather_windows_kernel(const __grid_constant__ MoveTable t, const int* __restrict__ perm,
                          int windows, int per_row, int n, int W, int lo, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  Item it{(int)blockIdx.x, 0, 0};
  if (it.q >= windows) return;
  gather_item<true>(t, it, perm, per_row, n, W, lo, smem);
  for (int i = 0;; ++i) {
    const Item nx = next_item(t, it);
    const bool more = nx.q < windows;
    cp_async_wait_all();
    __syncthreads();  // the item staged; the other stage's last reader done
    if (more)
      gather_item<true>(t, nx, perm, per_row, n, W, lo, smem + ((i + 1) & 1) * stage_bytes);
    gather_item<false>(t, it, perm, per_row, n, W, lo, smem + (i & 1) * stage_bytes);
    if (!more) break;
    it = nx;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Persistent CTAs: as many as fit on the card at once, at most `work`.
cudaError_t persistent_ctas(const void* fn, int smem, int work, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kMoveThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = min(work, per_sm * sm_count());
  return cudaSuccess;
}

cudaError_t fill_table(MoveTable* t, int count, void* const* srcs, void* const* dsts,
                       const int* units, const int* ws, const int* chunks) {
  if (count < 1 || count > kMaxMove) return cudaErrorInvalidValue;
  t->count = count;
  for (int i = 0; i < count; ++i) {
    const int u = units[i];
    if ((u != 1 && u != 2 && u != 4 && u != 8 && u != 16) || ws[i] < 1 || chunks[i] < 1 ||
        chunks[i] > ws[i])
      return cudaErrorInvalidValue;
    t->src[i] = srcs[i];
    t->dst[i] = dsts[i];
    t->unit[i] = u;
    t->w[i] = ws[i];
    t->chunk[i] = chunks[i];
  }
  return cudaSuccess;
}

cudaError_t launch_scatter(const MoveTable& t, const int* dest, const int* offsets, int m,
                           int rows, int n, int stage_bytes, cudaStream_t s) {
  for (int i = 0; i < t.count; ++i) {
    if ((long long)kScatterSpan * t.chunk[i] * t.unit[i] > stage_bytes)
      return cudaErrorInvalidValue;
  }
  const int spans = (n + kScatterSpan - 1) / kScatterSpan;
  if ((long long)rows * spans > INT_MAX) return cudaErrorInvalidConfiguration;
  const int total = rows * spans;
  if (total == 0) return cudaSuccess;
  const int smem = scatter_smem(stage_bytes);
  int widest = 1;
  for (int i = 0; i < t.count; ++i) widest = max(widest, t.unit[i] * t.w[i]);
  int ctas;
  cudaError_t err = persistent_ctas((const void*)&scatter_kernel, smem, total, &ctas);
  if (err != cudaSuccess) return err;
  scatter_kernel<<<ctas, kMoveThreads, smem, s>>>(t, dest, offsets, m, n, spans, total,
                                                  stage_bytes, max(1, kRowWindowBytes / widest));
  return cudaGetLastError();
}

// ---- G6: the level passes' samples ----

// One CTA a (row, segment): the segment's m sample positions (level 1: the
// drawn int64 positions; level 2: from the drawn float32 uniforms, as
// `sampling.positions_from_uniform` maps them), the keys there gathered into
// shared memory, padded to P (a power of two) with the key dtype's max,
// sorted by a bitonic network, and the k-1 splitters at clip(j m // k, 0,
// m-1) written out; with `upper`, also the (k,) upper form, the sentinel
// last.  Equal keys are the same bits, so any sort of the values gives the
// plain twin's sorted sample.
template <typename Key, bool kUniform>
__global__ void __launch_bounds__(kSampleThreads)
    sample_splitters_kernel(const Key* __restrict__ keys, int n, const long long* __restrict__ pos,
                            const float* __restrict__ uni, const int* __restrict__ seg_off,
                            int num_seg, int m, int P, int k, Key* __restrict__ spl,
                            Key* __restrict__ upper) {
  extern __shared__ __align__(16) unsigned char sample_smem[];
  Key* s = reinterpret_cast<Key*>(sample_smem);
  const int rs = blockIdx.x;  // row * num_seg + segment
  const int row = rs / num_seg;
  const Key* rk = keys + (long long)row * n;
  long long lo = 0, hi = 0;
  float fsize = 0.f;
  if (kUniform) {
    const int* so = seg_off + (long long)row * (num_seg + 1) + (rs - row * num_seg);
    lo = so[0];
    hi = so[1];
    fsize = __ll2float_rn(max(hi - lo, 1ll));  // int64 -> float32, to nearest, as torch's mul
  }
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    Key v = KeyBits<Key>::kMax;
    if (j < m) {
      long long p;
      if (kUniform) {
        const float f = __fmul_rn(__ldg(uni + (long long)rs * m + j), fsize);
        p = lo + (long long)floorf(f);
        p = min(max(p, lo), max(hi - 1, lo));
        p = min(p, (long long)n - 1);  // an empty last segment: its lo is n
      } else {
        p = __ldg(pos + (long long)row * m + j);
      }
      v = rk[p];
    }
    s[j] = v;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Key a = s[i], b = s[j];
        if ((a > b) == ((i & size) == 0)) s[i] = b, s[j] = a;
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k - 1; j += blockDim.x) {
    const long long at = min((long long)(j + 1) * m / k, (long long)m - 1);
    const Key v = s[at];
    spl[(long long)rs * (k - 1) + j] = v;
    if (upper != nullptr) upper[(long long)rs * k + j] = v;
  }
  if (upper != nullptr && threadIdx.x == 0) upper[(long long)rs * k + k - 1] = KeyBits<Key>::kMax;
}

template <typename Key>
cudaError_t launch_samples(const void* keys, int n, const void* pos, const void* uni,
                           const int* seg_off, int rows, int num_seg, int m, int k, void* spl,
                           void* upper, cudaStream_t s) {
  int P = 1;
  while (P < m) P <<= 1;
  const int smem = P * (int)sizeof(Key);
  const int threads = P / 2 > kSampleThreads ? kSampleThreads : (P / 2 < 32 ? 32 : P / 2);
  const bool uniform = uni != nullptr;
  const void* fn = uniform ? (const void*)&sample_splitters_kernel<Key, true>
                           : (const void*)&sample_splitters_kernel<Key, false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)(rows * num_seg);
  if (uniform) {
    sample_splitters_kernel<Key, true><<<ctas, threads, smem, s>>>(
        (const Key*)keys, n, nullptr, (const float*)uni, seg_off, num_seg, m, P, k, (Key*)spl,
        (Key*)upper);
  } else {
    sample_splitters_kernel<Key, false><<<ctas, threads, smem, s>>>(
        (const Key*)keys, n, (const long long*)pos, nullptr, nullptr, num_seg, m, P, k,
        (Key*)spl, (Key*)upper);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* glue_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// G1 over `rows` rows of n positions in tiles of `tile`: bucket, rank (rows,
// n), hist (rows, tiles, nb); scratch: part, rows * ceil(tiles / 16) * nb
// ints, and totals, rows * nb ints; writes offsets (rows, nb + 1) and dest
// (rows, n).  Three launches.
int glue_close_placement(const void* bucket, const void* rank, const void* hist, int rows, int n,
                         int tile, int nb, void* part, void* totals, void* offsets, void* dest,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return cudaSuccess;
  const int tiles = (n + tile - 1) / tile;
  const int runs = (tiles + kRunTiles - 1) / kRunTiles;
  const int groups = (nb + 31) / 32;
  if ((long long)rows * tiles > INT_MAX || (long long)rows * groups > INT_MAX || nb < 1)
    return cudaErrorInvalidConfiguration;
  if (tiles == 0) return cudaSuccess;  // no position: the caller's offsets are all 0
  const int smem = nb * (int)sizeof(int);
  close_sums_kernel<<<rows * runs, kThreads, smem, s>>>((const int*)hist, tiles, nb, runs,
                                                        (int*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  close_scan_kernel<<<rows * groups, kScanThreads, 0, s>>>((int*)part, runs, nb, groups,
                                                           (int*)totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  close_place_kernel<<<rows * tiles, kThreads, smem, s>>>(
      (const int*)bucket, (const int*)rank, (const int*)hist, (const int*)part,
      (const int*)totals, n, tile, tiles, nb, runs, (int*)offsets, (int*)dest);
  return cudaGetLastError();
}

// G2: out (rows, n) int32 from offsets (rows, m) int32 (m = nb + 1), each
// row nondecreasing.  One launch.
int glue_segment_ids(const void* offsets, int rows, int m, int n, void* out, void* stream) {
  const int spans = (n + kSpan - 1) / kSpan;
  if ((long long)rows * spans > INT_MAX || m < 1) return cudaErrorInvalidConfiguration;
  if (rows == 0 || spans == 0) return cudaSuccess;
  segment_ids_kernel<<<rows * spans, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, m, n, spans, (int*)out);
  return cudaGetLastError();
}

// G3: out (rows, n) int32 = seg * 2k + local for keys (rows, n) int32
// (key_bits 32) or int64 (64); splitters null: radix mode at `shift`.  One
// launch.
int glue_composite_ids(const void* keys, int key_bits, const void* seg_off, const void* splitters,
                       int rows, int num_seg, int n, int k, int shift, void* out, void* stream) {
  const int span =
      kThreads * (key_bits == 64 ? KeysPerThread<long long>::value : KeysPerThread<int>::value);
  const int spans = (n + span - 1) / span;
  if ((long long)rows * spans > INT_MAX || num_seg < 1 || k < 2 || (k & (k - 1)))
    return cudaErrorInvalidConfiguration;
  if (rows == 0 || spans == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned ctas = (unsigned)(rows * spans);
  const bool radix = splitters == nullptr;
#define COMPOSITE(Key, R)                                                                      \
  composite_ids_kernel<Key, R><<<ctas, kThreads, 0, s>>>((const Key*)keys, (const int*)seg_off, \
                                                         (const Key*)splitters, num_seg, n, k,  \
                                                         shift, spans, (int*)out)
  if (key_bits == 64) {
    if (radix) COMPOSITE(long long, true); else COMPOSITE(long long, false);
  } else {
    if (radix) COMPOSITE(int, true); else COMPOSITE(int, false);
  }
#undef COMPOSITE
  return cudaGetLastError();
}

// G4, the scatter: `count` tensors (at most kMaxMove) of rows x n rows, row
// i of each moved within its row of n to dest[i]; each tensor's rows are
// ws[i] units of units[i] bytes, staged chunks[i] units at a time.  With
// offsets (rows, m), m = nb + 1, of the stable placement dest is, spans of
// kScatterSpan rows are written out by bucket; without (null), row by row;
// either way through two stages of stage_bytes (at most 64 KB).  One
// launch.
int glue_scatter(int count, void* const* srcs, void* const* dsts, const int* units,
                 const int* ws, const int* chunks, const void* dest, const void* offsets, int m,
                 int rows, int n, int stage_bytes, void* stream) {
  MoveTable t{};
  cudaError_t err = fill_table(&t, count, srcs, dsts, units, ws, chunks);
  if (err != cudaSuccess) return err;
  if ((offsets != nullptr && m < 1) || stage_bytes > kStageBytes || (stage_bytes & 15))
    return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  return launch_scatter(t, (const int*)dest, (const int*)offsets, m, rows, n, stage_bytes,
                        (cudaStream_t)stream);
}

// G4, the window gather: `count` tensors (at most kMaxMove), each moved by
// `windows` windows of W (per_row a row of n, from position lo of each
// row) of perm (windows, W); rows of ws[i] units of units[i] bytes, chunks[i]
// units of every row of a window staged at a time, in two stages of
// stage_bytes (at most 64 KB).  srcs[i] may be dsts[i].  One launch.
int glue_gather_windows(int count, void* const* srcs, void* const* dsts, const int* units,
                        const int* ws, const int* chunks, const void* perm, int windows,
                        int per_row, int n, int W, int lo, int stage_bytes, void* stream) {
  MoveTable t{};
  cudaError_t err = fill_table(&t, count, srcs, dsts, units, ws, chunks);
  if (err != cudaSuccess) return err;
  if (per_row < 1 || W < 1 || stage_bytes > kStageBytes || (stage_bytes & 15))
    return cudaErrorInvalidValue;
  for (int i = 0; i < t.count; ++i) {
    if ((long long)W * t.chunk[i] * t.unit[i] > stage_bytes) return cudaErrorInvalidValue;
  }
  if (windows == 0) return cudaSuccess;
  int ctas;
  err = persistent_ctas((const void*)&gather_windows_kernel, 2 * stage_bytes, windows, &ctas);
  if (err != cudaSuccess) return err;
  gather_windows_kernel<<<ctas, kMoveThreads, 2 * stage_bytes, (cudaStream_t)stream>>>(
      t, (const int*)perm, windows, per_row, n, W, lo, stage_bytes);
  return cudaGetLastError();
}

// G6: the splitters (rows, num_seg, k-1) of keys (rows, n) int32 (key_bits
// 32) or int64 (64) from m samples a (row, segment): level 1 (num_seg 1)
// gathers at the drawn int64 positions pos (rows, m); level 2 maps the drawn
// float32 uniforms uni (rows, num_seg, m) into each segment of seg_off
// (rows, num_seg + 1) first.  upper (rows, num_seg, k) or null: the upper
// form, the sentinel last.  One launch.
int glue_sample_splitters(const void* keys, int key_bits, int n, const void* pos, const void* uni,
                          const void* seg_off, int rows, int num_seg, int m, int k, void* spl,
                          void* upper, void* stream) {
  if (m < 1 || m > 16384 || k < 2 || num_seg < 1 || n < 1 || (pos == nullptr) == (uni == nullptr))
    return cudaErrorInvalidValue;
  if ((long long)rows * num_seg > INT_MAX) return cudaErrorInvalidConfiguration;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (key_bits == 64)
    return launch_samples<long long>(keys, n, pos, uni, (const int*)seg_off, rows, num_seg, m, k,
                                     spl, upper, s);
  return launch_samples<int>(keys, n, pos, uni, (const int*)seg_off, rows, num_seg, m, k, spl,
                             upper, s);
}

}  // extern "C"
