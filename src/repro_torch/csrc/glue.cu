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
//   16 that divides the row and both pointers).  The scatter by a level
//   pass's placement, rows of one unit, is staged: one CTA a span of 4096
//   source rows finds each row's bucket from the placement's offsets (the
//   row's offsets staged whole up to 1024 of them; else the span's least
//   and greatest destination pick its buckets by two warp searches), counts
//   the buckets and their least destinations by shared atomics, checks that
//   each bucket's destinations are a run (the placement is stable), and
//   writes the span in destination order out of a stage in shared memory:
//   runs of ~16 consecutive rows at the main path's 257 and 65,792 buckets,
//   where a row-by-row scatter makes a 32-byte sector write a row.  That
//   took 0.29 ms at 2^24, the staged one 0.18 (a span of 8192, or fewer
//   registers and more CTAs an SM, was slower; NVIDIA H100 80GB HBM3,
//   700 W).  Other rows (wider, or no offsets, or a span that fails the
//   check) take the row-by-row scatter: a unit a thread, four in flight.
//   The window gather takes one CTA a window.  Pass one of the base case
//   writes a new tensor: each unit reads its source through the L1/L2 (the
//   window is 32 KB of 4-byte keys).  Pass two gathers within windows of
//   the tensor it writes, so the CTA first stages its whole window (or a
//   slice of the units of every row of it: at most 64 KB) in shared
//   memory, waits, then writes: every read of a window precedes every
//   write, and windows never straddle rows or pass `limit` (the caller's
//   windows end there).  Staging in place was chosen over ping-ponging two
//   buffers: it needs no second tensor and no copy of the untouched edges.
#include <climits>

#include <cuda_runtime.h>

namespace {

#include "sort_device.cuh"  // the scans and KeyBits, shared with csrc/level_fused.cu

constexpr int kThreads = 256;          // a CTA of G1's sums and place, G2 and G3
constexpr int kPerThread = 16;         // positions a thread of G1's place, G2 and G3
constexpr int kSpan = kThreads * kPerThread;
constexpr int kMoveThreads = 512;      // a CTA of G4's staged scatter
constexpr int kMovePer = 8;            // its rows a thread
constexpr int kMoveSpan = kMoveThreads * kMovePer;
constexpr int kStageOffsets = 2048;    // G2/G3: a span's offsets in shared memory
constexpr int kStageSplitBytes = 16384;  // G3: a span's splitters in shared memory
constexpr int kRunTiles = 16;          // G1: tiles a run
constexpr int kScanThreads = 1024;     // G1's scan CTA
constexpr int kMoveUnroll = 4;         // G4: units in flight a thread
constexpr int kGatherThreads = 512;
constexpr int kScatterGroups = 1024;   // G4's staged scatter: buckets a span, at most
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

// The scatter: rows of w units, count = rows * n of them, each moved within
// its row of n to dest (row-local); a dest outside [0, n) moves nothing.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const U* __restrict__ src, U* __restrict__ dst, const int* __restrict__ dest,
                   int count, int n, int w) {
  const long long total = (long long)count * w;
  const long long first = (long long)blockIdx.x * kThreads * kMoveUnroll + threadIdx.x;
  U v[kMoveUnroll];
  long long to[kMoveUnroll];
#pragma unroll
  for (int j = 0; j < kMoveUnroll; ++j) {
    const long long f = first + (long long)j * kThreads;
    to[j] = -1;
    if (f < total) {
      const int i = w == 1 ? (int)f : (int)(f / w);
      const int d = __ldg(dest + i);
      v[j] = src[f];
      if ((unsigned)d < (unsigned)n) {
        const int row = i / n;
        to[j] = ((long long)row * n + d) * w + (f - (long long)i * w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMoveUnroll; ++j) {
    if (to[j] >= 0) dst[to[j]] = v[j];
  }
}

// The staged scatter, for a stable placement (a bucket's rows keep their
// order and land on consecutive positions, as K1's, K4's and K2's do) and
// rows of one unit: one CTA a span of kMoveSpan source rows of a row of n.  The
// span's destinations fall into the buckets between its least and its
// greatest; with the row's offsets (m = nb + 1 of them) each row finds its
// bucket, and a bucket's rows of the span, whose destinations are
// consecutive, take consecutive slots of a stage in shared memory from the
// bucket's least destination on.  The stage is then written out in slot
// order: runs of consecutive destinations, not a store a row.  A row of at
// most kScatterGroups offsets is staged whole (every bucket a group, no
// search in device memory); else the span's least and greatest destination
// pick the slice of buckets by a warp search each.  A span of more than
// kScatterGroups buckets, or whose destinations are not such runs (the
// check is exact: every row's offset from its bucket's least is below the
// bucket's count), is scattered row by row.
template <typename U>
__global__ void __launch_bounds__(kMoveThreads, 3)
    scatter_staged_kernel(const U* __restrict__ src, U* __restrict__ dst,
                          const int* __restrict__ dest, const int* __restrict__ offsets, int m,
                          int n, int spans) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* s_val = reinterpret_cast<U*>(smem);                    // kMoveSpan
  int* s_dest = reinterpret_cast<int*>(s_val + kMoveSpan);  // kMoveSpan
  int* s_off = s_dest + kMoveSpan;                          // kScatterGroups
  int* s_cnt = s_off + kScatterGroups;                      // kScatterGroups
  int* s_min = s_cnt + kScatterGroups;                      // kScatterGroups
  __shared__ int s_c[2];
  __shared__ int warp_sums[33];
  const int row = blockIdx.x / spans;
  const int p0 = (blockIdx.x - row * spans) * kMoveSpan;
  const int p1 = min(p0 + kMoveSpan, n);
  const long long base = (long long)row * n;
  const int* off = offsets + (long long)row * m;
  int d[kMovePer];
  U v[kMovePer];
#pragma unroll
  for (int j = 0; j < kMovePer; ++j) {
    const int p = p0 + j * kMoveThreads + threadIdx.x;
    d[j] = p < p1 ? __ldg(dest + base + p) : -1;
    if (p < p1) v[j] = src[base + p];
  }
  bool fits = true;  // every destination in [0, n): the same for the whole CTA below
#pragma unroll
  for (int j = 0; j < kMovePer; ++j) {
    if (p0 + j * kMoveThreads + (int)threadIdx.x < p1 && (unsigned)d[j] >= (unsigned)n) fits = false;
  }
  int c_lo = 0, len = m - 1;  // the span's buckets: g offsets of off[c_lo, c_lo + len) <= d
  if (m > kScatterGroups) {
    // the span's least and greatest destination, then the offsets <= each
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int j = 0; j < kMovePer; ++j) {
      if (d[j] >= 0) lo = min(lo, d[j]), hi = max(hi, d[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = lo, warp_sums[16 + (threadIdx.x >> 5)] = hi;
    __syncthreads();
    if (threadIdx.x < 64) {
      const bool is_lo = threadIdx.x < 32;
      const int w = threadIdx.x & 15;
      int x = w < (int)(blockDim.x >> 5) ? warp_sums[(is_lo ? 0 : 16) + w] : (is_lo ? INT_MAX : -1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const int y = __shfl_xor_sync(kFull, x, o);
        x = is_lo ? min(x, y) : max(x, y);
      }
      const int c = warp_count_le(off, m, max(x, 0));
      if ((threadIdx.x & 31) == 0) s_c[threadIdx.x >> 5] = c;
    }
    __syncthreads();
    c_lo = s_c[0];
    len = s_c[1] - c_lo;
  }
  const bool staged = __syncthreads_and(fits) && len < kScatterGroups;  // the whole CTA alike
  bool runs = staged;
  int g[kMovePer];
  if (staged) {
    for (int i = threadIdx.x; i <= len; i += blockDim.x) {
      if (i < len) s_off[i] = off[c_lo + i];
      s_cnt[i] = 0, s_min[i] = INT_MAX;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMovePer; ++j) g[j] = 0;
    for (int step = len == 0 ? 0 : 1 << (31 - __clz(len)); step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kMovePer; ++j) {
        const int q = g[j] + step;
        if (q <= len && s_off[q - 1] <= d[j]) g[j] = q;
      }
    }
#pragma unroll
    for (int j = 0; j < kMovePer; ++j) {
      if (d[j] >= 0) atomicAdd(&s_cnt[g[j]], 1), atomicMin(&s_min[g[j]], d[j]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMovePer; ++j) {
      if (d[j] >= 0 && d[j] - s_min[g[j]] >= s_cnt[g[j]]) runs = false;
    }
  }
  if (!__syncthreads_or(!runs)) {
    // each bucket's first slot: the exclusive scan of the counts
    int carry = 0;
    for (int i0 = 0; i0 <= len; i0 += blockDim.x) {  // the same trips for the whole CTA
      const int i = i0 + threadIdx.x;
      int total;
      const int excl = block_exclusive_scan(i <= len ? s_cnt[i] : 0, warp_sums, &total);
      if (i <= len) s_cnt[i] = carry + excl - s_min[i];  // slot = this + destination
      carry += total;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMovePer; ++j) {
      if (d[j] >= 0) {
        const int slot = s_cnt[g[j]] + d[j];
        s_dest[slot] = d[j];
        s_val[slot] = v[j];
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < p1 - p0; f += blockDim.x) dst[base + s_dest[f]] = s_val[f];
    return;
  }
#pragma unroll
  for (int j = 0; j < kMovePer; ++j) {  // row by row
    if ((unsigned)d[j] < (unsigned)n) dst[base + d[j]] = v[j];
  }
}

// The window gather, one CTA a window: window q of row q / per_row covers
// positions [lo + (q % per_row) W, + W) of its row of n; perm (windows, W)
// window-local.  Direct (src is not dst): each unit reads its source.
// Staged (in place): `chunk` units of every row of the window go through
// shared memory, all read before any is written.
template <typename U, bool kStaged>
__global__ void __launch_bounds__(kGatherThreads)
    gather_windows_kernel(const U* src, U* dst, const int* __restrict__ perm, int per_row, int n,
                          int W, int lo, int w, int chunk) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  U* stage = reinterpret_cast<U*>(stage_bytes);
  const int q = blockIdx.x;
  const int row = q / per_row;
  const long long first = (long long)row * n + lo + (long long)(q - row * per_row) * W;
  const int* pw = perm + (long long)q * W;
  if (!kStaged) {
    const int units = W * w;
#pragma unroll 4
    for (int f = threadIdx.x; f < units; f += blockDim.x) {
      const int j = w == 1 ? f : f / w;
      const int u = f - j * w;
      dst[(first + j) * w + u] = src[(first + __ldg(pw + j)) * w + u];
    }
    return;
  }
  for (int c0 = 0; c0 < w; c0 += chunk) {
    const int cw = min(chunk, w - c0);
    const int units = W * cw;
#pragma unroll 4
    for (int f = threadIdx.x; f < units; f += blockDim.x) {
      const int j = cw == 1 ? f : f / cw;
      stage[f] = src[(first + j) * w + c0 + (f - j * cw)];
    }
    __syncthreads();  // the whole slice read before any of it is written
#pragma unroll 4
    for (int f = threadIdx.x; f < units; f += blockDim.x) {
      const int j = cw == 1 ? f : f / cw;
      const int u = f - j * cw;
      dst[(first + j) * w + c0 + u] = stage[__ldg(pw + j) * cw + u];
    }
    __syncthreads();
  }
}

template <typename U>
cudaError_t launch_scatter(const void* src, void* dst, const int* dest, int count, int n, int w,
                           cudaStream_t s) {
  const long long total = (long long)count * w;
  const long long ctas = (total + kThreads * kMoveUnroll - 1) / (kThreads * kMoveUnroll);
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  scatter_kernel<U><<<(unsigned)ctas, kThreads, 0, s>>>((const U*)src, (U*)dst, dest, count, n,
                                                        w);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_scatter_staged(const void* src, void* dst, const int* dest, const int* offsets,
                                  int m, int rows, int n, cudaStream_t s) {
  const int spans = (n + kMoveSpan - 1) / kMoveSpan;
  if ((long long)rows * spans > INT_MAX) return cudaErrorInvalidConfiguration;
  if (rows == 0 || spans == 0) return cudaSuccess;
  const int smem = kMoveSpan * ((int)sizeof(U) + 4) + 3 * kScatterGroups * 4;
  cudaError_t err = cudaFuncSetAttribute((const void*)&scatter_staged_kernel<U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scatter_staged_kernel<U><<<rows * spans, kMoveThreads, smem, s>>>((const U*)src, (U*)dst,
                                                                     dest, offsets, m, n, spans);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_gather(const void* src, void* dst, const int* perm, int windows, int per_row,
                          int n, int W, int lo, int w, int chunk, bool staged, cudaStream_t s) {
  if (windows == 0) return cudaSuccess;
  if (!staged) {
    gather_windows_kernel<U, false><<<windows, kGatherThreads, 0, s>>>(
        (const U*)src, (U*)dst, perm, per_row, n, W, lo, w, chunk);
    return cudaGetLastError();
  }
  const int smem = W * chunk * (int)sizeof(U);
  cudaError_t err = cudaFuncSetAttribute((const void*)&gather_windows_kernel<U, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_windows_kernel<U, true><<<windows, kGatherThreads, smem, s>>>(
      (const U*)src, (U*)dst, perm, per_row, n, W, lo, w, chunk);
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

// G4, the scatter: count = rows * n rows of w units of `unit` bytes (1, 2,
// 4, 8 or 16), row i of src to dst row (i / n) * n + dest[i].  One launch.
int glue_scatter(const void* src, void* dst, const void* dest, int count, int n, int unit, int w,
                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* d = (const int*)dest;
  switch (unit) {
    case 1: return launch_scatter<Unit<1>::T>(src, dst, d, count, n, w, s);
    case 2: return launch_scatter<Unit<2>::T>(src, dst, d, count, n, w, s);
    case 4: return launch_scatter<Unit<4>::T>(src, dst, d, count, n, w, s);
    case 8: return launch_scatter<Unit<8>::T>(src, dst, d, count, n, w, s);
    case 16: return launch_scatter<Unit<16>::T>(src, dst, d, count, n, w, s);
  }
  return cudaErrorInvalidValue;
}

// G4, the staged scatter: rows x n rows of one unit of `unit` bytes (1, 2,
// 4, 8 or 16) moved by dest, a stable placement whose (rows, m) offsets
// (m = nb + 1) are given.  One launch.
int glue_scatter_staged(const void* src, void* dst, const void* dest, const void* offsets, int m,
                        int rows, int n, int unit, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* d = (const int*)dest;
  const int* o = (const int*)offsets;
  if (m < 1) return cudaErrorInvalidConfiguration;
  switch (unit) {
    case 1: return launch_scatter_staged<Unit<1>::T>(src, dst, d, o, m, rows, n, s);
    case 2: return launch_scatter_staged<Unit<2>::T>(src, dst, d, o, m, rows, n, s);
    case 4: return launch_scatter_staged<Unit<4>::T>(src, dst, d, o, m, rows, n, s);
    case 8: return launch_scatter_staged<Unit<8>::T>(src, dst, d, o, m, rows, n, s);
    case 16: return launch_scatter_staged<Unit<16>::T>(src, dst, d, o, m, rows, n, s);
  }
  return cudaErrorInvalidValue;
}

// G4, the window gather: `windows` windows of W, per_row a row of n, from
// position lo of each row; rows of w units of `unit` bytes; staged (src may
// be dst) with `chunk` units a row a pass through W * chunk * unit bytes of
// shared memory.  One launch.
int glue_gather_windows(const void* src, void* dst, const void* perm, int windows, int per_row,
                        int n, int W, int lo, int unit, int w, int chunk, int staged,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)perm;
  if (per_row < 1 || chunk < 1) return cudaErrorInvalidConfiguration;
  switch (unit) {
    case 1: return launch_gather<Unit<1>::T>(src, dst, p, windows, per_row, n, W, lo, w, chunk,
                                             staged != 0, s);
    case 2: return launch_gather<Unit<2>::T>(src, dst, p, windows, per_row, n, W, lo, w, chunk,
                                             staged != 0, s);
    case 4: return launch_gather<Unit<4>::T>(src, dst, p, windows, per_row, n, W, lo, w, chunk,
                                             staged != 0, s);
    case 8: return launch_gather<Unit<8>::T>(src, dst, p, windows, per_row, n, W, lo, w, chunk,
                                             staged != 0, s);
    case 16: return launch_gather<Unit<16>::T>(src, dst, p, windows, per_row, n, W, lo, w, chunk,
                                               staged != 0, s);
  }
  return cudaErrorInvalidValue;
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
