// K1 level_fused (tree and radix modes), K2 rank_hist and their batched
// forms K4: the fused level pass of the sort, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/level_fused.py:
//   K1 `level_fused`, tree mode   -- classify each key against the k-1
//      splitters, route positions >= n_real to the pad bucket 2k, and emit
//      each key's bucket, its stable rank among the same-bucket keys of its
//      tile, and the (tiles, 2k+1) histogram;
//   K1r `level_fused`, radix mode -- the same, with the bucket taken from
//      the next log2(k) key bits: 2 * ((code >> shift) & (k-1)) + (key ==
//      sentinel), where code = key ^ 0x80000000 is the reference's unsigned
//      code of the port's signed key;
//   K4 `level_fused_batched`      -- K1/K1r over (B, n) rows: one CTA per
//      (row, tile), each row with its own splitters (tree) or the shared
//      shift (radix), pads routed within the row, one histogram slab per
//      row;
//   K2 `rank_hist`                -- the stable counting placement over ids
//      given by the caller, dest[i] = offsets[b] + #{j < i : id[j] == b}
//      for b = id[i], and the nb + 1 offsets; its batched form K4
//      `rank_hist_batched` places each row of (B, n) ids, dest and offsets
//      row-local.
// K1's global placement dest = offsets[b] + tile_off[t, b] + rank is closed
// by the G1 kernels of csrc/glue.cu, where the reference closes it in XLA.
// K2 closes its own on the device (four launches, below).
//
// Bound: bytes.  K1 reads 4 B of key and writes 4 B of bucket and 4 B of
// rank per element: 12 B, ~60 us for 2^24 elements at 3.35 TB/s.  K2 must
// read 4 B of id and write 4 B of dest: 8 B, ~40 us; it reads the ids twice
// (count, then rank), so it moves 12 B.  The arithmetic (a log2(k)-level
// descent in shared memory, a peer mask and two popcounts per element) is
// far below the integer rate.
//
// The rank must follow position order -- a rank taken from shared-memory
// atomics would not be stable -- and the CTAs run in any order, so nothing
// carries between them: each CTA owns its tile's counters.  Each warp walks
// its own contiguous span of the tile in 32-wide chunks: the lanes holding
// the same id form a group, popc of the lower lanes of the group is the
// rank in the chunk, and a per-warp counter per id (in shared memory,
// bumped by the group's lowest lane) carries the count across the warp's
// chunks.  An exclusive scan of those counters over the warps then gives
// each warp's start per id, and the scan's total is the tile histogram.
// A group is found by an atomicOr of each lane's bit into a per-warp mask
// per id (as CUB's radix rank does), which the group's lowest lane clears
// with its counter update.
//
// K1, K1r and K4 level_fused_batched (`level_fused_kernel`).  What held the
// first design back (0.183 ms of device time at n = 2^24, k = 128 on an H100,
// 34% of the bound): each warp walked its 16 chunks in series, and each
// chunk's 4-byte load was issued only when the chunk before was ranked;
// each key then ran a 7-step binary search in shared memory whose steps
// wait on each other, and the ids and ranks were staged in 32 KB of shared
// memory (five CTAs an SM) and read back with a division p / span.  Few
// loads in flight and chains of dependent shared-memory accesses, not
// bandwidth, set its time.  This design:
//   - each warp owns at most 16 chunks (512 positions): the CTA has
//     ceil(tile / 512) warps, 8 at the default tile of 4096, up to 32 at
//     16384.  A lane issues the loads of all its chunks at once, into
//     registers, before it ranks anything;
//   - tree mode classifies a lane's 16 keys together by the paper's
//     branchless descent of the implicit splitter tree (IPS4o §4.1):
//     j = 2j + (key > tree[j]) over log2(k) levels, the k-1 splitters in
//     Eytzinger order in shared memory, so one key's dependent load
//     overlaps fifteen others'.  j - k is the number of splitters below the
//     key, which the sorted-array search gave, duplicate splitters and the
//     sentinel included; eq = (key == upper[j - k]);
//   - the groups of a chunk come from one shared-memory atomicOr per lane:
//     __match_any_sync costs more the more distinct ids a warp holds (with
//     it, the radix path's random ids ran slower than the first design),
//     and one ballot per bit of the ids (9 at k = 128) took more issue
//     slots than the rest of the rank;
//   - each chunk's rank stays in the lane's registers; after the scan over
//     the warps each lane writes its own positions' bucket and rank: a
//     chunk is 32 consecutive positions, so the stores coalesce without
//     staging.  Shared memory is the tree, the uppers and each warp's
//     masks (4 B) and counters (2 B) per id, ~13 KB at k = 128.
// K1r replaces the descent by a shift and a mask (no splitters); the
// batched form numbers its CTAs row-major over (row, tile), so a tile
// never straddles a row, pads are routed by the position within the row,
// and each row's histogram slab is contiguous for the per-row epilogue.
//
// 64-bit keys (int64 codes of the 64-bit key dtypes) take the same kernel,
// templated on the key type (`level_fused_kernel<long long, 8, ...>`; the
// 32-bit form is `<int, 16, ...>`, unchanged).  A key is two registers, so
// a lane holds 8 chunks in flight, not 16: the same 64 bytes of loads in
// flight a lane and the same registers for keys, and a warp takes 256
// positions, so a CTA of 1024 threads takes tiles up to 8192 (MAX_TILE64).
// The splitters and uppers are 8 bytes each in shared memory (2 KB at k =
// 128); the descent compares 64-bit keys (two instructions a compare);
// radix mode shifts the reference's 64-bit code (shift in [0, 64)) and
// sends the sentinel LLONG_MAX to the equality bucket.  Bound: 16 B an
// element (8 B of key, the bucket and the rank), ~80 us at 2^24.
//
// K2 `rank_hist` and K4 `rank_hist_batched` (`segment_*_kernel`, four
// launches: items, count, scan, rank).  K2 at level 2 of the sort takes
// composite ids seg * W2 + local with up to 257 * 256 = 65,792 distinct
// values: too many counters for one CTA.  But segments are contiguous
// position ranges and the composite id rises with the segment, so the
// stable placement by composite id is, per segment, the stable placement
// by the local id (W2 = seg_width <= 2048 counters) offset by the
// segment's start.  Work items of at most `tile` positions never straddle
// a segment; each row numbers its items in position order within `slots`
// = n / tile + num_seg, the static bound, so nothing is read back to the
// host, and the slots past a row's live items are empty.  The first design
// ranked the items here and left the placement to a torch epilogue of ~45
// launches (1.31 ms by events at 2^24 on an H100, against 0.17 ms for the
// kernel).  This one is K6's count, scan and place, made segment-aware:
//   1. segment_items_kernel, one CTA per row: items per segment, their
//      scan, and each slot's (row * n + position, length, id base) found by
//      a binary search over the threads' first items;
//   2. the count of each slot's local ids into hist[slot, W2];
//   3. segment_scan_kernel, one team per (row, segment): a warp when the
//      segment's items are few and W2 small (eight teams a CTA), else a
//      CTA.  Thread (x, y) takes local id x (of each pass of up to 1024
//      ids) and run y of the segment's items; one exclusive scan over the
//      team in thread order, which is the id-major order over (id, run),
//      gives each run's start; the run's walk turns hist into base[slot,
//      id] in place, and run 0 of id b writes offsets[seg * W2 + b]
//      (row-local).  The items kernel writes each row's last offset, n;
//   4. the rank of each slot's local ids, dest = base[slot, id] + rank.
// Above W2 = 32 (K2 at level 2: W2 = 256) the count and the rank take a
// CTA of up to 8 warps per slot (empty slots exit at once).  The count
// adds one shared-memory atomicAdd per id, all of a lane's loads in flight
// (few lanes of a warp share an id).  The rank (segment_rank_kernel) is
// K1's: every load of a lane in flight before it ranks, peer masks by one
// atomicOr a lane, 16-bit per-warp counters, ranks in registers, the scan
// over the warps, coalesced stores, the slot's base row in shared memory;
// chunks are ranked in pairs with a mask buffer each, so their atomicOrs
// overlap.  A warp takes at most 512 positions (16 chunks) at once; at
// tiles above 8 x 512 it walks its span twice, counting batch by batch,
// then, after the scan, ranking again from its start and storing.  Shared
// memory: W2 * (4 + 10 * warps) B, 21 KB at W2 = 256, 168 KB at W2 =
// MAX_NB = 2048.
// Up to W2 = 32 (K4 rank_hist_batched at level 2: W2 = 4, items of ~2,000
// positions and many of one) a CTA per slot spent its time starting CTAs:
// the count and the rank take one warp per slot, eight a CTA, and keep
// their counters in registers: lane b holds id b's count, or its next
// destination, base + the count so far (segment_small_kernel).  Per chunk
// log2(W2) + 1 ballots give each lane the lanes holding its id and those
// holding id `lane`; a lane's destination is lane v's register (one
// shuffle) plus the group's lower lanes.  Up to W2 = 4 the count needs no
// ballot: each lane adds its ids into four 8-bit fields of one register a
// batch (segment_tiny_count_kernel).  Each batch of 16 chunks is loaded
// while the one before is counted or ranked.
// An id outside [0, W2) after its segment's base breaks the caller's
// contract: it is left out of the counts and gets dest -1.
#include <climits>

#include <cuda_runtime.h>

namespace {

#include "sort_device.cuh"  // the scans and KeyBits, shared with csrc/glue.cu

constexpr int kChunks32 = 16;           // 32-position chunks a warp of K1 holds (int keys)
constexpr int kChunks64 = 8;            // the same for 64-bit keys
constexpr int kLevelMaxThreads = 1024;  // 16384 positions a CTA (8192 with 64-bit keys)

// K1, K1r and K4: one CTA per (row, tile) over `rows` rows of n keys; the
// CTAs are numbered row-major, so hist is (rows, tiles_per_row, 2k+1).
// Tree mode: upper holds each row's k-1 sorted splitters and the sentinel
// (row stride k); the bucket index j is the number of splitters below the
// key, eq = (key == upper[j]).  Radix mode: no splitters, j = the bits of
// the reference's code at `shift`, eq = (key == the sentinel, the key
// type's max).  kChunks: the 32-position chunks a warp holds.
template <typename Key, int kChunks, bool kRadix>
__global__ void __launch_bounds__(kLevelMaxThreads)
    level_fused_kernel(const Key* __restrict__ keys, const Key* __restrict__ upper,
                       int n, int n_real, int k, int shift, int tile,
                       int tiles_per_row, int* __restrict__ bucket,
                       int* __restrict__ rank, int* __restrict__ hist) {
  extern __shared__ int smem[];
  const int nb = 2 * k + 1;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / tiles_per_row;
  const int col = (blockIdx.x - row * tiles_per_row) * tile;
  const long long start = (long long)row * n + col;
  const int len = min(tile, n - col);
  const int span = (((len + warps - 1) / warps) + 31) & ~31;  // <= 32 * kChunks
  const int lo = warp * span;
  const int hi = min(lo + span, len);

  // every load of the warp's span in flight before anything waits on one
  Key key[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = lo + 32 * c + lane;
    key[c] = p < hi ? __ldg(keys + start + p) : 0;
  }

  Key* s_tree = reinterpret_cast<Key*>(smem);  // tree mode: [1, k) the splitters, Eytzinger order
  Key* s_upper = s_tree + k;                    // tree mode: the k uppers
  // per warp and id: the lanes holding the id in the current chunk, and the
  // count so far (16 bits: at most 16384 positions a tile)
  unsigned* masks = reinterpret_cast<unsigned*>(s_tree + (kRadix ? 0 : 2 * k));
  unsigned short* cnt = reinterpret_cast<unsigned short*>(masks + warps * nb);
  for (int i = threadIdx.x; i < warps * nb; i += blockDim.x) masks[i] = 0u, cnt[i] = 0;
  if (!kRadix) {
    const Key* row_upper = upper + (long long)row * k;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      s_upper[i] = row_upper[i];
      if (i > 0) {  // node i at depth h, p-th of its depth: sorted index (2p+1) k/2^(h+1) - 1
        const int h = 31 - __clz(i);
        s_tree[i] = row_upper[(2 * (i - (1 << h)) + 1) * (k >> (h + 1)) - 1];
      }
    }
  }
  __syncthreads();

  int id[kChunks];
  if (kRadix) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const unsigned bits = KeyBits<Key>::digits(key[c], shift);
      id[c] = 2 * (int)(bits & (unsigned)(k - 1)) + (key[c] == KeyBits<Key>::kMax ? 1 : 0);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) id[c] = 1;
    for (int level = k; level > 1; level >>= 1) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) id[c] = 2 * id[c] + (key[c] > s_tree[id[c]] ? 1 : 0);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = id[c] - k;
      id[c] = 2 * j + (key[c] == s_upper[j] ? 1 : 0);
    }
  }

  // ranks in the warp's span, in position order, kept in registers
  unsigned short* wcnt = cnt + warp * nb;
  unsigned* wsame = masks + warp * nb;
  const unsigned below = (1u << lane) - 1u;
  int r[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = lo + 32 * c + lane;
    if (col + p >= n_real) id[c] = 2 * k;  // a pad of this row
    r[c] = 0;
    if (lo + 32 * c >= hi) continue;  // the same for the whole warp
    const bool mine = p < hi;
    if (mine) atomicOr(wsame + id[c], 1u << lane);  // the lanes holding this id
    __syncwarp();
    const unsigned same = mine ? wsame[id[c]] : 0u;
    const int old = mine ? wcnt[id[c]] : 0;
    r[c] = old + __popc(same & below);
    __syncwarp();
    if (mine && (same & below) == 0) {  // the group's lowest lane
      wcnt[id[c]] = (unsigned short)(old + __popc(same));
      wsame[id[c]] = 0u;
    }
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan over the warps, per id; the total is the histogram
  int* hist_row = hist + (long long)blockIdx.x * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = cnt[w * nb + b];
      cnt[w * nb + b] = (unsigned short)run;
      run += c;
    }
    hist_row[b] = run;
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = lo + 32 * c + lane;
    if (p < hi) {
      bucket[start + p] = id[c];
      rank[start + p] = r[c] + wcnt[id[c]];
    }
  }
}

// K1's CTA: one warp per 32 * kChunks positions of the tile, at least one.
template <typename Key>
int level_threads(int tile) {
  const int span = 32 * (sizeof(Key) == 8 ? kChunks64 : kChunks32);
  const int warps = (tile + span - 1) / span;
  return 32 * (warps < 1 ? 1 : warps);
}

template <typename Key>
int level_smem_bytes(int k, bool radix, int tile) {
  const int ids = level_threads<Key>(tile) / 32 * (2 * k + 1);  // masks (4 B), counts (2 B)
  return (radix ? 0 : 2 * k) * (int)sizeof(Key) + ids * 6;
}

template <typename Key>
cudaError_t level_setup(int k, bool radix, int tile, const void** kernel, int* smem) {
  constexpr int chunks = sizeof(Key) == 8 ? kChunks64 : kChunks32;
  *kernel = radix ? (const void*)&level_fused_kernel<Key, chunks, true>
                  : (const void*)&level_fused_kernel<Key, chunks, false>;
  *smem = level_smem_bytes<Key>(k, radix, tile);
  if (level_threads<Key>(tile) > kLevelMaxThreads) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <typename Key>
int launch_level(const void* keys, const void* upper, int rows, int n,
                 int n_real, int k, bool radix, int shift, int tile,
                 void* bucket, void* rank, void* hist, void* stream) {
  constexpr int chunks = sizeof(Key) == 8 ? kChunks64 : kChunks32;
  const void* kernel;
  int smem;
  cudaError_t err = level_setup<Key>(k, radix, tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = (n + tile - 1) / tile;
  const long long ctas = (long long)rows * tiles_per_row;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  const auto launch = radix ? level_fused_kernel<Key, chunks, true>
                            : level_fused_kernel<Key, chunks, false>;
  launch<<<(unsigned)ctas, level_threads<Key>(tile), smem, (cudaStream_t)stream>>>(
      (const Key*)keys, (const Key*)upper, n, n_real, k, shift, tile,
      tiles_per_row, (int*)bucket, (int*)rank, (int*)hist);
  return cudaGetLastError();
}

// K1's launch at (k, tile, mode), from the CUDA runtime (see level_fused_info).
template <typename Key>
int level_info(int k, int radix, int tile, int* out) {
  const void* kernel;
  int smem;
  cudaError_t err = level_setup<Key>(k, radix != 0, tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[4], kernel, level_threads<Key>(tile), smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = level_threads<Key>(tile);
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

// ---- K2 and K4 rank_hist_batched: the segment-aware counting placement ----

constexpr int kRankChunks = 16;      // 32-position chunks a lane holds at once
constexpr int kRankMaxWarps = 8;     // warps of a count or rank CTA
constexpr int kItemsThreads = 1024;  // threads of the items kernel (one row)
constexpr int kItemsCache = 96 * 1024;  // its segments in shared memory up to this

// A call's segments and scratch, as its kernels share them: rows of n ids,
// num_seg segments a row (seg_off (rows, num_seg + 1), or null: one segment
// [0, n)) of `width` local ids, `slots` item slots a row; first (rows,
// num_seg + 1): a segment's first slot in its row; hist (rows * slots,
// width): the counts, then base, the row-local destination of each slot's
// first id; offsets (rows, num_seg * width + 1), row-local.
struct Segments {
  const int* seg_off;
  int* first;
  int* hist;
  int* offsets;
  int n, num_seg, width, slots;
};

// 1. One CTA per row.  Segment s of the row is [off[s], off[s+1]), the last
// one ending at n; it holds ceil(len / tile) items.  Writes first[row, s]
// (first[row, num_seg] = the live items), each slot's (row * n + position,
// length, s * width; length 0 past the live items) and the row's last
// offset, n.  With `cache`, the slots' search reads the first slots and the
// segments' starts from shared memory (2 * (num_seg + 1) ints).
__global__ void __launch_bounds__(kItemsThreads)
    segment_items_kernel(Segments g, int tile, int cache, int4* __restrict__ items) {
  extern __shared__ int s_seg[];           // cache: first (num_seg + 1), then lo (num_seg + 1)
  __shared__ int part[kItemsThreads + 1];  // each thread's first slot, then the total
  __shared__ int warp_sums[33];
  const int row = blockIdx.x;
  const int num_seg = g.num_seg, n = g.n;
  const int* off = g.seg_off == nullptr ? nullptr : g.seg_off + (long long)row * (num_seg + 1);
  int* first_out = g.first + (long long)row * (num_seg + 1);
  int* row_off = g.offsets + (long long)row * ((long long)num_seg * g.width + 1);
  auto seg_lo = [&](int s) { return s == num_seg ? n : (off == nullptr ? 0 : off[s]); };
  auto seg_items = [&](int s) {
    const int len = seg_lo(s + 1) - seg_lo(s);
    return len > 0 ? len / tile + (len % tile != 0) : 0;
  };
  const int per = (num_seg + blockDim.x - 1) / blockDim.x;  // segments a thread
  const int s0 = min((int)threadIdx.x * per, num_seg);
  const int s1 = min(s0 + per, num_seg);
  int mine = 0;
  for (int s = s0; s < s1; ++s) mine += seg_items(s);
  int live;
  int run = block_exclusive_scan(mine, warp_sums, &live);
  part[threadIdx.x] = run;
  for (int s = s0; s < s1; ++s) {
    first_out[s] = run;
    if (cache) s_seg[s] = run, s_seg[num_seg + 1 + s] = seg_lo(s);
    run += seg_items(s);
  }
  if (threadIdx.x == 0) {
    part[blockDim.x] = live;
    first_out[num_seg] = live;
    if (cache) s_seg[num_seg] = live, s_seg[2 * num_seg + 1] = n;
    row_off[(long long)num_seg * g.width] = n;
  }
  __syncthreads();  // part, the cache and first (device memory) seen by the whole CTA
  const int* first = cache ? s_seg : first_out;
  auto lo = [&](int s) { return cache ? s_seg[num_seg + 1 + s] : seg_lo(s); };
  int4* row_items = items + (long long)row * g.slots;
  for (int i = threadIdx.x; i < g.slots; i += blockDim.x) {
    if (i >= live) {
      row_items[i] = make_int4(0, 0, 0, 0);
      continue;
    }
    int a = 0, b = blockDim.x;  // part[a] <= i < part[b]: thread a's segments hold slot i
    while (b - a > 1) {
      const int m = (a + b) >> 1;
      if (part[m] <= i) a = m; else b = m;
    }
    int s = a * per;
    while (first[s + 1] <= i) ++s;
    const int start = lo(s) + (i - first[s]) * tile;
    row_items[i] = make_int4(row * n + start, min(tile, lo(s + 1) - start), s * g.width, 0);
  }
}

// 2. One CTA per slot (W2 > 32): the item's local ids (id - id base)
// counted into hist[slot, width], one shared-memory atomicAdd per id.
__global__ void __launch_bounds__(kRankMaxWarps * 32)
    segment_count_kernel(const int* __restrict__ ids, const int4* __restrict__ items,
                         Segments g) {
  extern __shared__ int cnt[];
  const int4 it = items[blockIdx.x];
  if (it.y == 0) return;  // an empty slot: the whole CTA
  const int width = g.width;
  const int step = blockDim.x * kRankChunks;
  int id[kRankChunks];
  auto load = [&](int from) {  // every load of the batch in flight
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int p = from + c * blockDim.x + threadIdx.x;
      id[c] = p < it.y ? __ldg(ids + it.x + p) - it.z : -1;
    }
  };
  load(0);
  for (int b = threadIdx.x; b < width; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  for (int from = 0; from < it.y; from += step) {
    if (from != 0) load(from);
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      if ((unsigned)id[c] < (unsigned)width) atomicAdd(&cnt[id[c]], 1);
    }
  }
  __syncthreads();
  int* out = g.hist + (long long)blockIdx.x * width;
  for (int b = threadIdx.x; b < width; b += blockDim.x) out[b] = cnt[b];
}

// 3. One team per (row, segment): a warp (kWarpTeam, eight to a CTA) or the
// CTA.  Thread t of the team is (x = t / runs, y = t % runs): local id b0 +
// x of each pass of `ids_per_pass` ids, and run y of the segment's items.
// One exclusive scan over the team, in thread order, is the id-major scan
// over (id, run): each run's start within the segment.  Each run's walk
// turns the counts into base in place; run 0 of id b writes the offset.
template <bool kWarpTeam>
__global__ void __launch_bounds__(1024)
    segment_scan_kernel(Segments g, int rows, int ids_per_pass, int runs) {
  __shared__ int warp_sums[33];
  const int team = kWarpTeam ? blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)
                             : blockIdx.x;
  if (team >= rows * g.num_seg) return;  // a whole team: no barrier is left waiting
  const int t = kWarpTeam ? (threadIdx.x & 31) : threadIdx.x;
  const int width = g.width;
  const int row = team / g.num_seg;
  const int s = team - row * g.num_seg;
  const long long seg_at = (long long)row * (g.num_seg + 1) + s;
  const int f = g.first[seg_at];
  const int c = g.first[seg_at + 1] - f;
  int carry = g.seg_off == nullptr ? 0 : g.seg_off[seg_at];
  int* h = g.hist + ((long long)row * g.slots + f) * width;
  int* out = g.offsets + (long long)row * ((long long)g.num_seg * width + 1) +
             (long long)s * width;
  const int x = t / runs;
  const int y = t - x * runs;
  const int per = (c + runs - 1) / runs;
  const int i0 = min(y * per, c);
  const int i1 = min(i0 + per, c);
  for (int b0 = 0; b0 < width; b0 += ids_per_pass) {
    const int b = b0 + x;
    const bool act = x < ids_per_pass && b < width;
    int v = 0;
    if (act) {
#pragma unroll 8
      for (int i = i0; i < i1; ++i) v += h[(long long)i * width + b];
    }
    int total;
    const int excl = kWarpTeam ? warp_exclusive_scan(v, &total)
                               : block_exclusive_scan(v, warp_sums, &total);
    if (act) {
      int run = carry + excl;
      if (y == 0) out[b] = run;
      for (int i = i0; i < i1; i += 8) {  // 8 loads in flight, then their stores
        int n_i[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) n_i[j] = i + j < i1 ? h[(long long)(i + j) * width + b] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (i + j < i1) h[(long long)(i + j) * width + b] = run;
          run += n_i[j];
        }
      }
    }
    carry += total;
  }
}

// 4. One CTA per slot: K1's stable rank over the item's local ids, then
// dest = base[slot, id] + rank.  Each warp owns a contiguous span of the
// item (at most 512 positions unless kMulti).  kMulti: spans longer than
// one batch of 16 chunks are walked twice, counting, then (after the scan)
// ranking from the warp's start and storing.
template <bool kMulti>
__global__ void __launch_bounds__(kRankMaxWarps * 32)
    segment_rank_kernel(const int* __restrict__ ids, const int4* __restrict__ items,
                        const int* __restrict__ base, int width, int* __restrict__ dest) {
  extern __shared__ int smem[];
  const int4 it = items[blockIdx.x];
  const int len = it.y;
  if (len == 0) return;  // an empty slot: the whole CTA
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int span = (((len + warps - 1) / warps) + 31) & ~31;
  const int lo = warp * span;
  const int hi = min(lo + span, len);
  const int* src = ids + it.x;
  int id[kRankChunks];
  auto load = [&](int from) {  // a batch: every load in flight, local ids, -1 past hi
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int p = from + 32 * c + lane;
      id[c] = p < hi ? __ldg(src + p) - it.z : -1;
    }
  };
  load(lo);

  int* s_base = smem;  // the slot's base row
  // per warp and id: the lanes holding the id in the current chunk (two
  // buffers: a pair of chunks) and the count so far (16 bits: at most 16384
  // positions an item)
  unsigned* masks = reinterpret_cast<unsigned*>(smem + width);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(masks + 2 * warps * width);
  for (int i = threadIdx.x; i < warps * width; i += blockDim.x) {
    masks[i] = 0u, masks[warps * width + i] = 0u, cnt[i] = 0;
  }
  const int* base_row = base + (long long)blockIdx.x * width;
  for (int b = threadIdx.x; b < width; b += blockDim.x) s_base[b] = base_row[b];
  __syncthreads();

  unsigned short* wcnt = cnt + warp * width;
  unsigned* wsame = masks + warp * width;
  unsigned* wsame2 = masks + (warps + warp) * width;
  const unsigned below = (1u << lane) - 1u;
  // one chunk's ranks after the warp's counter, in position order (the
  // whole warp calls it; a lane with v outside [0, width) takes no part)
  auto rank_chunk = [&](int v) -> int {
    const bool mine = (unsigned)v < (unsigned)width;
    if (mine) atomicOr(wsame + v, 1u << lane);  // the lanes holding this id
    __syncwarp();
    const unsigned same = mine ? wsame[v] : 0u;
    const int old = mine ? wcnt[v] : 0;
    __syncwarp();
    if (mine && (same & below) == 0) {  // the group's lowest lane
      wcnt[v] = (unsigned short)(old + __popc(same));
      wsame[v] = 0u;
    }
    __syncwarp();
    return old + __popc(same & below);
  };
  // two chunks at once, each with its own masks: their atomicOrs overlap,
  // and the second reads the counter after the first's leaders wrote it
  auto rank_pair = [&](int v0, int v1, int* r0, int* r1) {
    const bool m0 = (unsigned)v0 < (unsigned)width;
    const bool m1 = (unsigned)v1 < (unsigned)width;
    if (m0) atomicOr(wsame + v0, 1u << lane);
    if (m1) atomicOr(wsame2 + v1, 1u << lane);
    __syncwarp();
    const unsigned s0 = m0 ? wsame[v0] : 0u;
    const unsigned s1 = m1 ? wsame2[v1] : 0u;
    const int o0 = m0 ? wcnt[v0] : 0;
    __syncwarp();
    if (m0 && (s0 & below) == 0) {
      wcnt[v0] = (unsigned short)(o0 + __popc(s0));
      wsame[v0] = 0u;
    }
    __syncwarp();
    const int o1 = m1 ? wcnt[v1] : 0;
    __syncwarp();
    if (m1 && (s1 & below) == 0) {
      wcnt[v1] = (unsigned short)(o1 + __popc(s1));
      wsame2[v1] = 0u;
    }
    __syncwarp();
    *r0 = o0 + __popc(s0 & below);
    *r1 = o1 + __popc(s1 & below);
  };
  // exclusive scan over the warps, per id (every load before the stores)
  auto scan_warps = [&]() {
    __syncthreads();
    for (int b = threadIdx.x; b < width; b += blockDim.x) {
      int c[kRankMaxWarps];
#pragma unroll
      for (int w = 0; w < kRankMaxWarps; ++w) c[w] = w < warps ? cnt[w * width + b] : 0;
      int run = 0;
#pragma unroll
      for (int w = 0; w < kRankMaxWarps; ++w) {
        if (w < warps) cnt[w * width + b] = (unsigned short)run;
        run += c[w];
      }
    }
    __syncthreads();
  };

  if (!kMulti) {  // the span is one batch: ranks kept in registers
    int r[kRankChunks];
#pragma unroll
    for (int c = 0; c < kRankChunks; c += 2) {
      r[c] = r[c + 1] = 0;
      if (lo + 32 * c >= hi) continue;  // the same for the whole warp
      rank_pair(id[c], id[c + 1], &r[c], &r[c + 1]);  // past hi, chunk c + 1's ids are -1
    }
    scan_warps();
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int p = lo + 32 * c + lane;
      if (p < hi) {
        const int v = id[c];
        dest[it.x + p] = (unsigned)v < (unsigned)width ? s_base[v] + wcnt[v] + r[c] : -1;
      }
    }
    return;
  }
  for (int from = lo; from < hi; from += 32 * kRankChunks) {  // count
    if (from != lo) load(from);
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      if (from + 32 * c < hi) rank_chunk(id[c]);
    }
  }
  scan_warps();
  for (int from = lo; from < hi; from += 32 * kRankChunks) {  // rank from the start, store
    load(from);
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      if (from + 32 * c >= hi) continue;
      const int r = rank_chunk(id[c]);
      const int p = from + 32 * c + lane;
      if (p < hi) {
        const int v = id[c];
        dest[it.x + p] = (unsigned)v < (unsigned)width ? s_base[v] + r : -1;
      }
    }
  }
}

// 2 and 4 for W2 <= 32, one warp per slot (8 slots a CTA; a warp whose slot
// is empty exits at once), in registers alone: lane b keeps id b's count
// (the count) or its next destination, base[slot, b] + the count so far
// (the rank).  Per chunk, id_bits + 1 ballots give each lane the lanes
// holding its id and the lanes holding id `lane`; a lane's destination is
// lane v's register (one shuffle) + the group's lower lanes.  No shared
// memory, no barrier; each batch of 16 chunks is loaded while the batch
// before is counted or ranked.  (A warp per slot with its counters and
// masks in shared memory, and a CTA per slot, were slower at K4's shape;
// so was a ballot loop of runtime length with an early exit from the
// chunks, which kept the chunks' ballots from overlapping.)
template <int kBits>
__device__ __forceinline__ void small_groups(int v, bool valid, unsigned* peers,
                                             unsigned* of_lane) {
  const int lane = threadIdx.x & 31;
  const unsigned vm = __ballot_sync(kFull, valid);
  *peers = vm;
  *of_lane = vm;
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit) {
    const unsigned m = __ballot_sync(kFull, (v >> bit) & 1);
    *peers &= ((v >> bit) & 1) ? m : ~m;
    *of_lane &= ((lane >> bit) & 1) ? m : ~m;
  }
}

// kBits = ceil(log2(width)), a template argument: the ballots unrolled.
// Every chunk of a batch runs (past the item its lanes are all invalid and
// change nothing): a branch between chunks would keep their ballots from
// overlapping.
template <bool kRank, int kBits>
__global__ void __launch_bounds__(kRankMaxWarps * 32)
    segment_small_kernel(const int* __restrict__ ids, const int4* __restrict__ items, Segments g,
                         int cells, int* __restrict__ dest) {
  const int width = g.width;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (slot >= cells) return;
  const int4 it = items[slot];
  if (it.y == 0) return;  // an empty slot: the whole warp
  const int* src = ids + it.x;
  const unsigned below = (1u << lane) - 1u;
  int id[kRankChunks], next[kRankChunks];
  auto load = [&](int* to, int from) {
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int p = from + 32 * c + lane;
      to[c] = p < it.y ? __ldg(src + p) - it.z : -1;
    }
  };
  load(id, 0);
  int run = kRank && lane < width ? g.hist[(long long)slot * width + lane] : 0;
  for (int from = 0; from < it.y; from += 32 * kRankChunks) {
    if (from + 32 * kRankChunks < it.y) load(next, from + 32 * kRankChunks);
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int v = id[c];
      const bool valid = (unsigned)v < (unsigned)width;
      unsigned peers, of_lane;
      small_groups<kBits>(v, valid, &peers, &of_lane);
      if (kRank) {
        const int old = __shfl_sync(kFull, run, v & 31);
        const int p = from + 32 * c + lane;
        if (p < it.y) dest[it.x + p] = valid ? old + __popc(peers & below) : -1;
      }
      run += __popc(of_lane);
    }
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) id[c] = next[c];
  }
  if (!kRank && lane < width) g.hist[(long long)slot * width + lane] = run;
}

// The count for W2 <= 4, without ballots: each lane counts its own ids as
// four 8-bit fields of one register (at most 16 a batch), added into four
// counters after each batch; one warp sum per id at the end (faster than
// the ballots at K4's shape; at W2 = 32 the 32 counters a lane were far
// slower).
__global__ void __launch_bounds__(kRankMaxWarps * 32)
    segment_tiny_count_kernel(const int* __restrict__ ids, const int4* __restrict__ items,
                              Segments g, int cells) {
  const int width = g.width;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (slot >= cells) return;
  const int4 it = items[slot];
  if (it.y == 0) return;  // an empty slot: the whole warp
  const int* src = ids + it.x;
  int id[kRankChunks], next[kRankChunks];
  auto load = [&](int* to, int from) {
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      const int p = from + 32 * c + lane;
      to[c] = p < it.y ? __ldg(src + p) - it.z : -1;
    }
  };
  load(id, 0);
  int cnt[4] = {0, 0, 0, 0};
  for (int from = 0; from < it.y; from += 32 * kRankChunks) {
    if (from + 32 * kRankChunks < it.y) load(next, from + 32 * kRankChunks);
    unsigned packed = 0u;
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) {
      if ((unsigned)id[c] < (unsigned)width) packed += 1u << (8 * id[c]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) cnt[b] += (packed >> (8 * b)) & 255u;
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) id[c] = next[c];
  }
  int mine = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int v = cnt[b];
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    if (lane == b) mine = v;
  }
  if (lane < width) g.hist[(long long)slot * width + lane] = mine;
}

template <bool kRank>
void launch_small(int id_bits, unsigned ctas, int threads, cudaStream_t s, const int* ids,
                  const int4* items, const Segments& g, int cells, int* dest) {
  switch (id_bits) {
#define SMALL_CASE(b)                                                                   \
  case b:                                                                               \
    segment_small_kernel<kRank, b><<<ctas, threads, 0, s>>>(ids, items, g, cells, dest); \
    break;
    SMALL_CASE(0) SMALL_CASE(1) SMALL_CASE(2) SMALL_CASE(3) SMALL_CASE(4) SMALL_CASE(5)
#undef SMALL_CASE
  }
}

// K2's count and rank CTAs: one warp per 512 positions of a tile, 1 to 8.
int segment_warps(int tile) {
  const int warps = (tile + 32 * kRankChunks - 1) / (32 * kRankChunks);
  return warps < 1 ? 1 : (warps > kRankMaxWarps ? kRankMaxWarps : warps);
}

bool segment_multi(int tile) {
  const int warps = segment_warps(tile);
  return (((tile + warps - 1) / warps) + 31) / 32 > kRankChunks;
}

int segment_rank_smem(int width, int tile) {
  return width * (int)sizeof(int) + segment_warps(tile) * width * 10;  // base; masks, counts
}

cudaError_t segment_rank_setup(int width, int tile, const void** kernel, int* smem) {
  *kernel = segment_multi(tile) ? (const void*)&segment_rank_kernel<true>
                                : (const void*)&segment_rank_kernel<false>;
  *smem = segment_rank_smem(width, tile);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// ceil(log2(width)): the ballots of the W2 <= 32 kernels
int segment_id_bits(int width) {
  int bits = 0;
  while ((1 << bits) < width) ++bits;
  return bits;
}

}  // namespace

extern "C" {

const char* level_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1, tree mode, over one row of n keys (int32; the 64 form int64).
int level_fused_tree(const void* keys, const void* upper, int n, int n_real,
                     int k, int tile, void* bucket, void* rank, void* hist,
                     void* stream) {
  return launch_level<int>(keys, upper, 1, n, n_real, k, false, 0, tile, bucket,
                           rank, hist, stream);
}
int level_fused_tree64(const void* keys, const void* upper, int n, int n_real,
                       int k, int tile, void* bucket, void* rank, void* hist,
                       void* stream) {
  return launch_level<long long>(keys, upper, 1, n, n_real, k, false, 0, tile, bucket,
                                 rank, hist, stream);
}

// K1r, radix mode, over one row of n keys.
int level_fused_radix(const void* keys, int n, int n_real, int k, int shift,
                      int tile, void* bucket, void* rank, void* hist,
                      void* stream) {
  return launch_level<int>(keys, nullptr, 1, n, n_real, k, true, shift, tile,
                           bucket, rank, hist, stream);
}
int level_fused_radix64(const void* keys, int n, int n_real, int k, int shift,
                        int tile, void* bucket, void* rank, void* hist,
                        void* stream) {
  return launch_level<long long>(keys, nullptr, 1, n, n_real, k, true, shift, tile,
                                 bucket, rank, hist, stream);
}

// K4, either mode, over `rows` rows of n keys; upper is (rows, k) in tree
// mode and unused in radix mode.
int level_fused_batched(const void* keys, const void* upper, int rows, int n,
                        int n_real, int k, int radix, int shift, int tile,
                        void* bucket, void* rank, void* hist, void* stream) {
  return launch_level<int>(keys, upper, rows, n, n_real, k, radix != 0, shift, tile,
                           bucket, rank, hist, stream);
}
int level_fused_batched64(const void* keys, const void* upper, int rows, int n,
                          int n_real, int k, int radix, int shift, int tile,
                          void* bucket, void* rank, void* hist, void* stream) {
  return launch_level<long long>(keys, upper, rows, n, n_real, k, radix != 0, shift, tile,
                                 bucket, rank, hist, stream);
}

// K1's launch at (k, tile, mode), from the CUDA runtime: out[0] registers
// per thread, out[1] static and out[2] dynamic shared memory per CTA in
// bytes, out[3] threads per CTA, out[4] CTAs an SM holds at once, out[5]
// local memory per thread (spills) in bytes.
int level_fused_info(int k, int radix, int tile, int* out) {
  return level_info<int>(k, radix, tile, out);
}
int level_fused_info64(int k, int radix, int tile, int* out) {
  return level_info<long long>(k, radix, tile, out);
}

// K2 (rows = 1) and K4 rank_hist_batched over `rows` rows of n ids:
// dest (rows, n) and offsets (rows, num_seg * width + 1), row-local.
// seg_off (rows, num_seg + 1) or null (one segment a row).  Scratch:
// items (rows * slots int4), first (rows * (num_seg + 1) ints) and hist
// (rows * slots * width ints).  scan_threads: threads of a scan team (32:
// warp teams), scan_ids: the local ids it takes per pass.
int level_fused_segment_place(const void* ids, const void* seg_off, int rows, int n,
                              int num_seg, int width, int tile, int slots, int scan_threads,
                              int scan_ids, void* items, void* first, void* hist, void* dest,
                              void* offsets, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const void* rank_kernel;
  int rank_smem;
  cudaError_t err = segment_rank_setup(width, tile, &rank_kernel, &rank_smem);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  const long long cells = (long long)rows * slots;
  const long long teams = (long long)rows * num_seg;
  if (cells > INT_MAX || teams > INT_MAX || scan_ids < 1 || scan_ids > scan_threads ||
      scan_threads > 1024)
    return cudaErrorInvalidConfiguration;
  const Segments g{(const int*)seg_off, (int*)first, (int*)hist, (int*)offsets,
                   n, num_seg, width, slots};
  const bool small = width <= 32;
  const int threads = small ? 32 * kRankMaxWarps : 32 * segment_warps(tile);
  const unsigned ctas = small ? (unsigned)((cells + kRankMaxWarps - 1) / kRankMaxWarps)
                              : (unsigned)cells;
  const int cache_smem = 2 * (num_seg + 1) * (int)sizeof(int);
  const int cache = cache_smem <= kItemsCache;
  if (cache && (err = cudaFuncSetAttribute((const void*)segment_items_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           cache_smem)) != cudaSuccess)
    return err;
  segment_items_kernel<<<rows, kItemsThreads, cache ? cache_smem : 0, s>>>(g, tile, cache,
                                                                          (int4*)items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!small) {
    segment_count_kernel<<<ctas, threads, width * sizeof(int), s>>>((const int*)ids,
                                                                    (const int4*)items, g);
  } else if (width <= 4) {
    segment_tiny_count_kernel<<<ctas, threads, 0, s>>>((const int*)ids, (const int4*)items, g,
                                                       (int)cells);
  } else {
    launch_small<false>(segment_id_bits(width), ctas, threads, s, (const int*)ids,
                        (const int4*)items, g, (int)cells, nullptr);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int runs = scan_threads / scan_ids;
  if (scan_threads == 32) {
    segment_scan_kernel<true><<<(unsigned)((teams + 7) / 8), 256, 0, s>>>(g, rows, scan_ids,
                                                                           runs);
  } else {
    segment_scan_kernel<false><<<(unsigned)teams, scan_threads, 0, s>>>(g, rows, scan_ids, runs);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (small) {
    launch_small<true>(segment_id_bits(width), ctas, threads, s, (const int*)ids,
                       (const int4*)items, g, (int)cells, (int*)dest);
  } else {
    const auto launch =
        segment_multi(tile) ? segment_rank_kernel<true> : segment_rank_kernel<false>;
    launch<<<ctas, threads, rank_smem, s>>>((const int*)ids, (const int4*)items,
                                            (const int*)hist, width, (int*)dest);
  }
  return cudaGetLastError();
}

// K2's rank kernel at (width, tile) -- segment_small_kernel up to width 32,
// else segment_rank_kernel -- as level_fused_info reports K1's.
int level_fused_segment_info(int width, int tile, int* out) {
  const void* kernel;
  int smem = 0, threads = 32 * kRankMaxWarps;
  cudaError_t err = cudaSuccess;
  if (width <= 32) {
    const void* small[] = {(const void*)&segment_small_kernel<true, 0>,
                           (const void*)&segment_small_kernel<true, 1>,
                           (const void*)&segment_small_kernel<true, 2>,
                           (const void*)&segment_small_kernel<true, 3>,
                           (const void*)&segment_small_kernel<true, 4>,
                           (const void*)&segment_small_kernel<true, 5>};
    kernel = small[segment_id_bits(width)];
  } else {
    if ((err = segment_rank_setup(width, tile, &kernel, &smem)) != cudaSuccess) return err;
    threads = 32 * segment_warps(tile);
  }
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = threads;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // extern "C"
