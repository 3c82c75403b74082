// G7: the one-device sort's robustness fallback on the card, with no host
// read, by hand for Hopper (sm_90a).
//
// This replaces no Pallas TPU kernel.  The reference decides its fallback
// on the device (`bucket_violations`, src/repro/core/ips4o.py:499, and the
// `lax.cond` at :540, batched :836) and then sorts the whole array with XLA.
// The port sorts only the buckets that need it: every non-trivial bucket
// (even id, not the pad bucket, starting below `limit`) that holds more
// than W/2 keys is sorted stably by key in place, and nothing else moves;
// the base case's window passes then finish every other bucket.  Its torch
// chain (a host read of the verdict, a gather of the bucket mask by int64
// ids, `nonzero`, an int64 sort, `flat[pos] = flat[src]`) stays as the
// plain twin (kernels/fallback.py `sort_oversized_plain`).
//
//   list -- one kernel over the level passes' offsets (rows, nb + 1): each
//      row's list of oversized buckets (start, size, its first chunk), its
//      count, and over all rows the chunk prefix, the total count, the
//      largest size and the verdict (count > 0).
//   sort -- one persistent cooperative kernel: every listed bucket cut into
//      chunks of kChunk keys, each sorted in shared memory by (key,
//      position), then runs merged pairwise by merge path, ties to the left
//      run, with a grid-wide barrier between rounds; the rounds come from
//      the largest size, read on the device; with an empty list it returns
//      at once.  Then every array (keys and payload leaves of any row width)
//      moves by the resulting order through a scratch of 4 B a position,
//      each position's row a slice of up to 4 bytes at a time.  When the
//      keys are the only array (a sort with no payload), equal keys are equal
//      bits: the keys themselves are sorted and merged (coalesced, no
//      position rides along), ping-ponging between the keys and a scratch of
//      one key a position.
//
// Two launches a call, whatever the buckets hold, for up to 128 arrays (the
// arrays' table rides in the kernel's parameters, 2 KB of the 4 KB they may
// hold); each further 128 arrays add one launch that moves only.  The host sizes everything from n and nb, never from a
// count: two int32 buffers of rows * n positions (the merge's ping-pong; the
// one that does not end with the order is the move's scratch), 8 B a key,
// what the plain twin's first gather alone (an int64 copy of the bucket
// ids) takes, or with the keys alone one key a position (4 or 8 B); and the
// list, at most n / (W/2 + 1) + 1 buckets a row.
//
// Bound: bytes.  With an empty list the list kernel reads the offsets (4
// B a bucket) and the sort kernel reads 16 B.  Over the listed keys, each
// is read once and each array's row is read and written once (4 + 4 B a
// 32-bit key and its order), plus the merge rounds' order traffic, which
// the bound leaves out as work the function need not do.
//
// Design.
// - list: a CTA a (row, part of 4096 buckets), grid-stride: each part's
//   counts by block reductions; a grid barrier; each part's entries by block
//   scans of the flags and the chunk counts, in bucket order, from its row's
//   prefix of the earlier parts (one warp sums them); a grid barrier; CTA 0
//   scans the rows' chunk counts and reduces the maxima.  Level 2's 65,792
//   buckets of one row are 17 CTAs (one CTA a row took 77 us there).
// - sort: the chunks of all rows are one numbered sequence (the row by a
//   search of the row prefix, the bucket by a search of the row's list); a
//   CTA takes chunks by grid stride.  A chunk: its keys and positions into
//   shared memory, padded with (key max, INT_MAX), a bitonic network on
//   (key, position) -- a total order, so the result is the stable order --
//   and the positions out.  A merge round: each chunk's range of outputs
//   lies in one pair of runs of width w (runs start at multiples of w from
//   the bucket's start, w a multiple of kChunk); warps 0 and 1 find the
//   range's two cuts by a search of 32 probes a step over device memory
//   (each probe gathers the keys of two positions), the range's inputs go
//   to shared memory, and each thread merges its 8 outputs after a short
//   search there.  The merge compares (key, position): a left run holds
//   only positions below the right run's, so this is the stable merge.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

#include "sort_device.cuh"  // the block scan and KeyBits

constexpr int kChunk = 2048;      // C: keys a chunk, outputs a merge tile
constexpr int kThreads = 256;     // the sort kernel's CTA
constexpr int kPer = kChunk / kThreads;
constexpr int kListThreads = 1024;
constexpr int kListPer = 4;        // buckets a thread of the list kernel
constexpr int kListSpan = kListThreads * kListPer;  // buckets a part of a row
constexpr int kMaxArrays = 128;   // arrays a sort launch moves

// The list's layout in one int32 buffer (kernels/fallback.py `meta_words`).
struct MetaView {
  int* summary;  // verdict, count, largest size, chunks
  int* prefix;   // (rows + 1) chunk prefix over the rows
  int* count;    // (rows) listed buckets a row
  int* rmax;     // (rows) a row's largest listed size
  int* start;    // (rows, cap) a listed bucket's first position
  int* size;     // (rows, cap) its size
  int* chunk;    // (rows, cap) its first chunk within the row
};

__host__ __device__ MetaView meta_view(int* meta, int rows, int cap) {
  MetaView v;
  v.summary = meta;
  v.prefix = meta + 4;
  v.count = v.prefix + rows + 1;
  v.rmax = v.count + rows;
  v.start = v.rmax + rows;
  v.size = v.start + (long long)rows * cap;
  v.chunk = v.size + (long long)rows * cap;
  return v;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// ---- the list ----

// A bucket's verdict and its chunks (0 when not listed).
struct Bucket {
  int start, size;
  bool big;
};

__device__ __forceinline__ Bucket bucket_at(const int* off, int b, int nb, int half_w,
                                            int pad_bucket, int limit) {
  Bucket k{0, 0, false};
  if (b < nb) {
    k.start = off[b];
    k.size = off[b + 1] - k.start;
    k.big = (b & 1) == 0 && b != pad_bucket && k.size > half_w && k.start < limit;
  }
  return k;
}

// One CTA a (row, part of kListSpan buckets), grid-stride over them, in
// three phases between grid barriers: (1) each part's count of listed
// buckets, their chunks and the largest; (2) each part's entries, at its
// row's prefix of the earlier parts' counts and chunks, in bucket order (the
// row's last part writes the row's totals); (3) CTA 0 scans the rows.
// part: (rows * parts, 3) scratch ints.
__global__ void __launch_bounds__(kListThreads)
    list_kernel(const int* __restrict__ offsets, int rows, int nb, int half_w, int pad_bucket,
                int limit, int cap, int parts, int* __restrict__ part, int* meta) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int warp_sums[33];
  __shared__ int s_max, s_base[2];
  const MetaView v = meta_view(meta, rows, cap);
  const int items = rows * parts;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / parts;
    const int b0 = (it - row * parts) * kListSpan;
    const int* off = offsets + (long long)row * (nb + 1);
    if (threadIdx.x == 0) s_max = 0;
    int cnt = 0, chunks = 0, mx = 0;
#pragma unroll
    for (int j = 0; j < kListPer; ++j) {
      const Bucket k = bucket_at(off, b0 + j * kListThreads + threadIdx.x, nb, half_w,
                                 pad_bucket, limit);
      if (k.big) cnt += 1, chunks += (k.size + kChunk - 1) / kChunk, mx = max(mx, k.size);
    }
    int total_cnt, total_chunks;
    block_exclusive_scan(cnt, warp_sums, &total_cnt);
    block_exclusive_scan(chunks, warp_sums, &total_chunks);
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0) atomicMax(&s_max, mx);
    __syncthreads();
    if (threadIdx.x == 0) {
      part[3 * it] = total_cnt;
      part[3 * it + 1] = total_chunks;
      part[3 * it + 2] = s_max;
    }
    __syncthreads();
  }
  grid.sync();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / parts;
    const int p = it - row * parts;
    const int b0 = p * kListSpan;
    const int* off = offsets + (long long)row * (nb + 1);
    if (threadIdx.x < 32) {  // the row's earlier parts: their counts and chunks
      int c = 0, k = 0;
      for (int q = threadIdx.x; q < p; q += 32) c += part[3 * (row * parts + q)],
                                                k += part[3 * (row * parts + q) + 1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        c += __shfl_xor_sync(kFull, c, o);
        k += __shfl_xor_sync(kFull, k, o);
      }
      if (threadIdx.x == 0) s_base[0] = c, s_base[1] = k;
    }
    __syncthreads();
    int slot0 = s_base[0], chunk0 = s_base[1];
    for (int j = 0; j < kListPer; ++j) {  // in bucket order: j-th stretch of the part
      const Bucket k = bucket_at(off, b0 + j * kListThreads + threadIdx.x, nb, half_w,
                                 pad_bucket, limit);
      int total, ctotal;
      const int slot = slot0 + block_exclusive_scan(k.big ? 1 : 0, warp_sums, &total);
      const int nck = k.big ? (k.size + kChunk - 1) / kChunk : 0;
      const int first = chunk0 + block_exclusive_scan(nck, warp_sums, &ctotal);
      if (k.big && slot < cap) {
        const long long at = (long long)row * cap + slot;
        v.start[at] = k.start;
        v.size[at] = k.size;
        v.chunk[at] = first;
      }
      slot0 += total;
      chunk0 += ctotal;
    }
    if (p == parts - 1 && threadIdx.x == 0) {  // the row's totals
      int mx = 0;
      for (int q = 0; q < parts; ++q) mx = max(mx, part[3 * (row * parts + q) + 2]);
      v.count[row] = min(slot0, cap);
      v.prefix[row + 1] = chunk0;  // the row's chunks, scanned below
      v.rmax[row] = mx;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x != 0) return;
  int carry = 0, total_count = 0, largest = 0;
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {  // the same trips for the whole CTA
    const int r = r0 + threadIdx.x;
    const int c = r < rows ? v.prefix[r + 1] : 0;
    int total;
    const int excl = block_exclusive_scan(c, warp_sums, &total);
    if (r < rows) {
      v.prefix[r + 1] = carry + excl + c;
      total_count += v.count[r];
      largest = max(largest, v.rmax[r]);
    }
    carry += total;
  }
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  int cnt_sum;
  block_exclusive_scan(total_count, warp_sums, &cnt_sum);
  largest = warp_max(largest);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_max, largest);
  __syncthreads();
  if (threadIdx.x == 0) {
    v.prefix[0] = 0;
    v.summary[0] = cnt_sum > 0 ? 1 : 0;
    v.summary[1] = cnt_sum;
    v.summary[2] = s_max;
    v.summary[3] = carry;
  }
}

// ---- the sort and the move ----

struct MoveArrays {
  void* ptr[kMaxArrays];
  int w[kMaxArrays];     // units a row
  int unit[kMaxArrays];  // bytes a unit: 1, 2 or 4
  int count;
};

struct Chunk {
  int row, start, size, q;  // a listed bucket of a row, and the chunk's index in it
};

// Chunk c of the numbered sequence over all rows' lists (one thread).
__device__ Chunk locate(const MetaView& v, int rows, int cap, int c) {
  int a = 0, b = rows + 1;  // the first row prefix above c, less one, is the row
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (v.prefix[mid] <= c) a = mid + 1; else b = mid;
  }
  const int row = a - 1;
  const int lc = c - v.prefix[row];
  const long long base = (long long)row * cap;
  a = 0;
  b = v.count[row];
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (v.chunk[base + mid] <= lc) a = mid + 1; else b = mid;
  }
  const long long at = base + a - 1;
  return Chunk{row, v.start[at], v.size[at], lc - v.chunk[at]};
}

template <typename Key>
__device__ __forceinline__ bool before(Key ka, int ia, Key kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The count of the left run's first i outputs among the first d of the
// merge of A = src[0, na) and B = src[na, na + nb) (positions, compared by
// (key, position)): the merge-path cut, by the whole warp, 32 probes a step.
template <typename Key>
__device__ int warp_cut(const Key* rk, const int* src, int na, int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  auto pred = [&](int i) {
    const int ia = src[i], ib = src[na + d - 1 - i];
    return before(rk[ia], ia, rk[ib], ib);
  };
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, idx < hi && pred(idx)));
    if (c == 0) return lo;
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = next_lo;
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(kFull, idx < hi && pred(idx)));
}

template <typename Key>
struct Stage {
  Key key[kChunk];
  int pos[kChunk];
  Chunk ch;
  int cut[2];
};

template <typename Key>
__device__ void sort_chunk(const Key* keys, int n, Stage<Key>& st, int* out) {
  const Chunk ch = st.ch;
  const long long rb = (long long)ch.row * n;
  const int p0 = ch.start + ch.q * kChunk;
  const int len = min(kChunk, ch.size - ch.q * kChunk);
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const bool real = i < len;
    st.key[i] = real ? keys[rb + p0 + i] : KeyBits<Key>::kMax;
    st.pos[i] = real ? p0 + i : INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < kChunk / 2 / kThreads; ++r) {
        const int t = r * kThreads + threadIdx.x;
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Key ka = st.key[i], kb = st.key[j];
        const int ia = st.pos[i], ib = st.pos[j];
        if (before(kb, ib, ka, ia) == ((i & size) == 0)) {
          st.key[i] = kb, st.key[j] = ka;
          st.pos[i] = ib, st.pos[j] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) out[rb + p0 + i] = st.pos[i];
}

// One merge tile: the chunk's outputs of the round of width w.
template <typename Key>
__device__ void merge_tile(const Key* keys, int n, long long w, Stage<Key>& st, const int* cur,
                           int* nxt) {
  const Chunk ch = st.ch;
  const long long rb = (long long)ch.row * n;
  const Key* rk = keys + rb;
  const int o0 = ch.q * kChunk;
  const int o1 = min(o0 + kChunk, ch.size);
  const int ps = (int)((o0 / (2 * w)) * (2 * w));
  const int na = (int)min(w, (long long)(ch.size - ps));
  const int nb = (int)min(2 * w, (long long)(ch.size - ps)) - na;
  const int* src = cur + rb + ch.start + ps;
  int* dst = nxt + rb + ch.start + ps;
  const int d0 = o0 - ps, d1 = o1 - ps;
  if (nb == 0) {  // a lone left run: copied as it is
    for (int i = d0 + threadIdx.x; i < d1; i += blockDim.x) dst[i] = src[i];
    return;
  }
  if (threadIdx.x < 64) {
    const int c = warp_cut(rk, src, na, nb, threadIdx.x < 32 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) st.cut[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  const int a0 = st.cut[0], a1 = st.cut[1];
  const int la = a1 - a0, lb = (d1 - a1) - (d0 - a0);
  const int b0 = d0 - a0;
  for (int i = threadIdx.x; i < la + lb; i += blockDim.x) {
    const int p = i < la ? src[a0 + i] : src[na + b0 + i - la];
    st.pos[i] = p;
    st.key[i] = rk[p];
  }
  __syncthreads();
  const int dd = threadIdx.x * kPer;
  if (dd < la + lb) {
    int lo = max(0, dd - lb), hi = min(dd, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int j = la + dd - 1 - mid;
      if (before(st.key[mid], st.pos[mid], st.key[j], st.pos[j])) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = dd - lo;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (dd + r < la + lb) {
        const bool take_a = j >= lb || (i < la && before(st.key[i], st.pos[i], st.key[la + j],
                                                          st.pos[la + j]));
        dst[d0 + dd + r] = take_a ? st.pos[i++] : st.pos[la + j++];
      }
    }
  }
}

// The move of one array's slice of units [u0, u0 + cu) of every listed
// position: gather into the scratch (the order's source rows), or write the
// scratch back.
template <typename U>
__device__ void move_slice(U* a, int w, int u0, int cu, int n, const int* order, U* scratch,
                           const Chunk& ch, bool gather) {
  constexpr int g = 4 / sizeof(U);
  const long long rb = (long long)ch.row * n;
  const int p0 = ch.start + ch.q * kChunk;
  const int len = min(kChunk, ch.size - ch.q * kChunk);
  for (int i = threadIdx.x; i < len * cu; i += blockDim.x) {
    const int e = cu == 1 ? i : i / cu;
    const int u = i - e * cu;
    const long long p = rb + p0 + e;
    if (gather) {
      scratch[p * g + u] = a[(rb + order[p]) * w + u0 + u];
    } else {
      a[p * w + u0 + u] = scratch[p * g + u];
    }
  }
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
    sort_kernel(const Key* keys, int n, int rows, int cap, int* meta, int* buf0, int* buf1,
                const __grid_constant__ MoveArrays arrays, int do_sort) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage<Key> st;
  const MetaView v = meta_view(meta, rows, cap);
  const int chunks = v.summary[3];
  const int largest = v.summary[2];
  if (chunks == 0) return;  // the same for the whole grid
  int rounds = 0;
  for (long long w = kChunk; w < largest; w <<= 1) ++rounds;
  auto each_chunk = [&](auto&& body) {
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      if (threadIdx.x == 0) st.ch = locate(v, rows, cap, c);
      __syncthreads();
      body();
      __syncthreads();
    }
  };
  if (do_sort) {
    each_chunk([&] { sort_chunk(keys, n, st, buf0); });
    grid.sync();
    int* cur = buf0;
    int* nxt = buf1;
    for (long long w = kChunk; w < largest; w <<= 1) {
      each_chunk([&] { merge_tile(keys, n, w, st, cur, nxt); });
      grid.sync();
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  const int* order = rounds % 2 == 0 ? buf0 : buf1;
  int* scratch = rounds % 2 == 0 ? buf1 : buf0;
  for (int a = 0; a < arrays.count; ++a) {
    const int unit = arrays.unit[a], w = arrays.w[a];
    const int g = 4 / unit;
    for (int u0 = 0; u0 < w; u0 += g) {
      const int cu = min(g, w - u0);
      for (int phase = 0; phase < 2; ++phase) {
        const bool gather = phase == 0;
        each_chunk([&] {
          const Chunk ch = st.ch;
          if (unit == 1) {
            move_slice((unsigned char*)arrays.ptr[a], w, u0, cu, n, order,
                       (unsigned char*)scratch, ch, gather);
          } else if (unit == 2) {
            move_slice((unsigned short*)arrays.ptr[a], w, u0, cu, n, order,
                       (unsigned short*)scratch, ch, gather);
          } else {
            move_slice((unsigned*)arrays.ptr[a], w, u0, cu, n, order, (unsigned*)scratch, ch,
                       gather);
          }
        });
        grid.sync();
      }
    }
  }
}

// ---- keys alone (no payload): the keys themselves merged ----

// The merge-path cut of the keys' runs A = src[0, na) and B = src[na, na +
// nb), ties to A (A[i] <= B[j] takes A), by the whole warp.
template <typename Key>
__device__ int warp_cut_keys(const Key* src, int na, int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  auto pred = [&](int i) { return src[i] <= src[na + d - 1 - i]; };
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, idx < hi && pred(idx)));
    if (c == 0) return lo;
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = next_lo;
  }
  const int idx = lo + lane;
  return lo + __popc(__ballot_sync(kFull, idx < hi && pred(idx)));
}

// A chunk's keys sorted in shared memory and written back in place.
template <typename Key>
__device__ void sort_chunk_keys(Key* keys, int n, Stage<Key>& st) {
  const Chunk ch = st.ch;
  Key* k = keys + (long long)ch.row * n + ch.start + ch.q * kChunk;
  const int len = min(kChunk, ch.size - ch.q * kChunk);
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) st.key[i] = i < len ? k[i] : KeyBits<Key>::kMax;
  __syncthreads();
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < kChunk / 2 / kThreads; ++r) {
        const int t = r * kThreads + threadIdx.x;
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Key a = st.key[i], b = st.key[j];
        if ((a > b) == ((i & size) == 0)) st.key[i] = b, st.key[j] = a;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) k[i] = st.key[i];
}

// One merge tile of keys: the chunk's outputs of the round of width w, from
// cur to nxt (both rows * n keys).
template <typename Key>
__device__ void merge_tile_keys(const Key* cur, Key* nxt, int n, long long w, Stage<Key>& st) {
  const Chunk ch = st.ch;
  const long long base = (long long)ch.row * n + ch.start;
  const int o0 = ch.q * kChunk;
  const int o1 = min(o0 + kChunk, ch.size);
  const int ps = (int)((o0 / (2 * w)) * (2 * w));
  const int na = (int)min(w, (long long)(ch.size - ps));
  const int nb = (int)min(2 * w, (long long)(ch.size - ps)) - na;
  const Key* src = cur + base + ps;
  Key* dst = nxt + base + ps;
  const int d0 = o0 - ps, d1 = o1 - ps;
  if (nb == 0) {  // a lone left run: copied as it is
    for (int i = d0 + threadIdx.x; i < d1; i += blockDim.x) dst[i] = src[i];
    return;
  }
  if (threadIdx.x < 64) {
    const int c = warp_cut_keys(src, na, nb, threadIdx.x < 32 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) st.cut[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  const int a0 = st.cut[0], a1 = st.cut[1];
  const int la = a1 - a0, lb = (d1 - a1) - (d0 - a0);
  const int b0 = d0 - a0;
  for (int i = threadIdx.x; i < la + lb; i += blockDim.x)
    st.key[i] = i < la ? src[a0 + i] : src[na + b0 + i - la];
  __syncthreads();
  const int dd = threadIdx.x * kPer;
  if (dd < la + lb) {
    int lo = max(0, dd - lb), hi = min(dd, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st.key[mid] <= st.key[la + dd - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = dd - lo;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (dd + r < la + lb) {
        const bool take_a = j >= lb || (i < la && st.key[i] <= st.key[la + j]);
        dst[d0 + dd + r] = take_a ? st.key[i++] : st.key[la + j++];
      }
    }
  }
}

// The sort of the listed buckets when the keys are the only array: equal
// keys are equal bits, so no position rides along.  Chunks sorted in place,
// then the rounds ping-pong between the keys and `scratch` (rows * n keys);
// after an odd number of rounds the listed keys are copied back.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    sort_keys_kernel(Key* keys, int n, int rows, int cap, int* meta, Key* scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage<Key> st;
  const MetaView v = meta_view(meta, rows, cap);
  const int chunks = v.summary[3];
  const int largest = v.summary[2];
  if (chunks == 0) return;  // the same for the whole grid
  auto each_chunk = [&](auto&& body) {
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      if (threadIdx.x == 0) st.ch = locate(v, rows, cap, c);
      __syncthreads();
      body();
      __syncthreads();
    }
  };
  each_chunk([&] { sort_chunk_keys(keys, n, st); });
  Key* cur = keys;
  Key* nxt = scratch;
  for (long long w = kChunk; w < largest; w <<= 1) {
    grid.sync();
    each_chunk([&] { merge_tile_keys(cur, nxt, n, w, st); });
    Key* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != keys) {  // each chunk's own positions: no barrier needed before
    grid.sync();
    each_chunk([&] {
      const Chunk ch = st.ch;
      const long long p0 = (long long)ch.row * n + ch.start + ch.q * kChunk;
      const int len = min(kChunk, ch.size - ch.q * kChunk);
      for (int i = threadIdx.x; i < len; i += blockDim.x) keys[p0 + i] = cur[p0 + i];
    });
  }
}

// The cooperative grid: every CTA the card holds at once.
cudaError_t resident_ctas(const void* fn, int threads, int* out) {
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0)) !=
      cudaSuccess)
    return err;
  *out = sms * per_sm;
  return *out > 0 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

const char* fallback_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The int32 words of the list for `rows` rows of at most `cap` buckets.
long long fallback_meta_words(int rows, int cap) {
  return 4 + (long long)(rows + 1) + 2LL * rows + 3LL * rows * cap;
}

// The list kernel's parts of a row of nb buckets.
int fallback_list_parts(int nb) { return (nb + kListSpan - 1) / kListSpan; }

// G7's list: offsets (rows, nb + 1) int32; a bucket is listed when its id
// is even, not pad_bucket (-1: none), it holds more than half_w keys and
// starts below limit.  Writes meta (fallback_meta_words(rows, cap)); part:
// scratch of fallback_list_parts(nb) * rows * 3 ints.  One launch.
int fallback_list(const void* offsets, int rows, int nb, int half_w, int pad_bucket, int limit,
                  int cap, void* part, void* meta, void* stream) {
  if (rows < 1 || nb < 1 || cap < 1) return cudaErrorInvalidValue;
  int parts = fallback_list_parts(nb);
  if ((long long)rows * parts > INT_MAX) return cudaErrorInvalidConfiguration;
  int ctas;
  cudaError_t err = resident_ctas((const void*)&list_kernel, kListThreads, &ctas);
  if (err != cudaSuccess) return err;
  if (ctas > rows * parts) ctas = rows * parts;
  void* args[] = {(void*)&offsets, &rows, &nb, &half_w, &pad_bucket, &limit, &cap, &parts,
                  &part, &meta};
  err = cudaLaunchCooperativeKernel((const void*)&list_kernel, dim3(ctas), dim3(kListThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// G7's sort and move: keys (rows, n) int32 (key_bits 32) or int64 (64) by
// the list in meta; buf0, buf1: rows * n int32 each; `count` (<= 128) arrays
// of rows * n rows of units[i] units of unit_bytes[i] (1, 2 or 4) bytes
// moved by the order; do_sort 0 moves only (the order already in the
// buffers, from an earlier launch on the same list).  One launch.
int fallback_sort(const void* keys, int key_bits, int n, int rows, int cap, void* meta,
                  void* buf0, void* buf1, int count, void* const* ptrs, const int* units,
                  const int* unit_bytes, int do_sort, void* stream) {
  if (rows < 1 || n < 1 || cap < 1 || count < 0 || count > kMaxArrays)
    return cudaErrorInvalidValue;
  MoveArrays arrays{};
  arrays.count = count;
  for (int i = 0; i < count; ++i) {
    if (unit_bytes[i] != 1 && unit_bytes[i] != 2 && unit_bytes[i] != 4) return cudaErrorInvalidValue;
    arrays.ptr[i] = ptrs[i];
    arrays.w[i] = units[i];
    arrays.unit[i] = unit_bytes[i];
  }
  const void* fn = key_bits == 64 ? (const void*)&sort_kernel<long long>
                                  : (const void*)&sort_kernel<int>;
  int ctas;
  cudaError_t err = resident_ctas(fn, kThreads, &ctas);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&keys, &n, &rows, &cap, &meta, &buf0, &buf1, &arrays, &do_sort};
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// G7's sort when the keys are the only array: keys (rows, n) int32 or int64
// sorted in place over the list in meta; scratch: rows * n keys.  One
// launch.
int fallback_sort_keys(void* keys, int key_bits, int n, int rows, int cap, void* meta,
                       void* scratch, void* stream) {
  if (rows < 1 || n < 1 || cap < 1) return cudaErrorInvalidValue;
  const void* fn = key_bits == 64 ? (const void*)&sort_keys_kernel<long long>
                                  : (const void*)&sort_keys_kernel<int>;
  int ctas;
  cudaError_t err = resident_ctas(fn, kThreads, &ctas);
  if (err != cudaSuccess) return err;
  void* args[] = {&keys, &n, &rows, &cap, &meta, &scratch};
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The sort kernel's launch for 32- or 64-bit keys: registers, static shared
// memory, threads, CTAs an SM holds, local bytes (spills), the grid.
int fallback_info(int key_bits, int* out) {
  const void* fn = key_bits == 64 ? (const void*)&sort_kernel<long long>
                                  : (const void*)&sort_kernel<int>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int ctas;
  if ((err = resident_ctas(fn, kThreads, &ctas)) != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = kThreads;
  out[4] = (int)attr.localSizeBytes;
  out[5] = ctas;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  out[3] = ctas / sms;
  return cudaSuccess;
}

}  // extern "C"
