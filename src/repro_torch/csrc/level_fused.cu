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
//   K2 `rank_hist`                -- the same rank + histogram over ids
//      given by the caller; its batched form K4 `rank_hist_batched` is this
//      kernel over work items cut from the B x num_seg row-aligned segments
//      of the flattened rows (the wrapper cuts them).
// The global placement dest = offsets[b] + tile_off[t, b] + rank is closed by
// a plain torch epilogue, as the reference closes it in XLA.
//
// Bound: bytes.  K1 reads 4 B of key and writes 4 B of bucket and 4 B of
// rank per element; K2 reads 4 B of id and writes 4 B of slot and 4 B of
// rank.  About 12 B per element, ~60 us for 2^24 elements at 3.35 TB/s.  The
// arithmetic (a log2(k)-level descent in shared memory, a warp match and
// two popcounts per element) is far below the integer rate.
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
// K2 finds a group by __match_any_sync; K1 by an atomicOr of each lane's
// bit into a per-warp mask per id (as CUB's radix rank does), which the
// group's lowest lane clears with its counter update.
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
// K2 `rank_hist` and K4 `rank_hist_batched` (`rank_hist_kernel`, one CTA of
// 8 warps per work item, through rank_hist.cuh, whose ids and ranks are
// staged in shared memory between the rank and the write).  K2 at level 2
// of the sort takes composite ids seg * W2 + local with up to 257 * 256 =
// 65,792 distinct values: too many counters for one CTA.  But segments are
// contiguous position ranges and the composite id rises with the segment,
// so the stable placement by composite id is, per segment, the stable
// placement by the local id (W2 <= 256 counters) offset by the segment's
// start.  The wrapper cuts work items that never straddle a segment; each
// CTA ranks one item over W2 counters and writes the slot item * W2 +
// local for the epilogue.  No dense (tiles x 65,792) histogram exists
// anywhere.  The batched rank_hist (K4) needs nothing more: the B rows,
// flattened, are B x num_seg segments, each item's segment id given to the
// kernel is its row-local one, and the epilogue subtracts each row's
// start.
#include <climits>

#include <cuda_runtime.h>

#include "rank_hist.cuh"

namespace {

constexpr int kChunks = 16;              // 32-position chunks a warp of K1 holds
constexpr int kLevelSpan = 32 * kChunks;  // positions a warp of K1 ranks
constexpr int kLevelMaxThreads = 1024;    // 16384 positions a CTA

// K1, K1r and K4: one CTA per (row, tile) over `rows` rows of n keys; the
// CTAs are numbered row-major, so hist is (rows, tiles_per_row, 2k+1).
// Tree mode: upper holds each row's k-1 sorted splitters and the sentinel
// (row stride k); the bucket index j is the number of splitters below the
// key, eq = (key == upper[j]).  Radix mode: no splitters, j = the bits of
// the reference's code at `shift`, eq = (key == INT_MAX, the sentinel).
template <bool kRadix>
__global__ void __launch_bounds__(kLevelMaxThreads)
    level_fused_kernel(const int* __restrict__ keys, const int* __restrict__ upper,
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
  const int span = (((len + warps - 1) / warps) + 31) & ~31;  // <= kLevelSpan
  const int lo = warp * span;
  const int hi = min(lo + span, len);

  // every load of the warp's span in flight before anything waits on one
  int key[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = lo + 32 * c + lane;
    key[c] = p < hi ? __ldg(keys + start + p) : 0;
  }

  int* s_tree = smem;      // tree mode: [1, k) the splitters in Eytzinger order
  int* s_upper = smem + k;  // tree mode: the k uppers
  // per warp and id: the lanes holding the id in the current chunk, and the
  // count so far (16 bits: at most 16384 positions a tile)
  unsigned* masks = reinterpret_cast<unsigned*>(smem + (kRadix ? 0 : 2 * k));
  unsigned short* cnt = reinterpret_cast<unsigned short*>(masks + warps * nb);
  for (int i = threadIdx.x; i < warps * nb; i += blockDim.x) masks[i] = 0u, cnt[i] = 0;
  if (!kRadix) {
    const int* row_upper = upper + (long long)row * k;
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
      const unsigned bits = ((unsigned)key[c] ^ 0x80000000u) >> shift;
      id[c] = 2 * (int)(bits & (unsigned)(k - 1)) + (key[c] == INT_MAX ? 1 : 0);
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

// K2: one CTA per work item (start, len, seg); local id = id - seg * nb.
__global__ void rank_hist_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ item_start,
                                 const int* __restrict__ item_len,
                                 const int* __restrict__ item_seg, int nb,
                                 int tile, int* __restrict__ rank,
                                 int* __restrict__ slot,
                                 int* __restrict__ hist) {
  extern __shared__ int smem[];
  int* cnt = smem;
  int* s_id = cnt + kWarps * nb;
  int* s_rank = s_id + tile;
  const int item = blockIdx.x;
  const long long start = item_start[item];
  const int len = item_len[item];
  const int base_id = item_seg[item] * nb;
  auto get_id = [&](int p) -> int { return ids[start + p] - base_id; };
  auto emit = [&](int p, int b, int r) {
    rank[start + p] = r;
    slot[start + p] = b < 0 ? -1 : item * nb + b;
  };
  rank_hist_item(len, nb, get_id, emit, hist + (long long)item * nb, cnt, s_id,
                 s_rank);
}

// K1's CTA: one warp per 512 positions of the tile, at least one.
int level_threads(int tile) {
  const int warps = (tile + kLevelSpan - 1) / kLevelSpan;
  return 32 * (warps < 1 ? 1 : warps);
}

int level_smem_bytes(int k, bool radix, int tile) {
  const int ids = level_threads(tile) / 32 * (2 * k + 1);  // masks (4 B) and counts (2 B)
  return (radix ? 0 : 2 * k) * (int)sizeof(int) + ids * 6;
}

cudaError_t level_setup(int k, bool radix, int tile, const void** kernel, int* smem) {
  *kernel = radix ? (const void*)&level_fused_kernel<true>
                  : (const void*)&level_fused_kernel<false>;
  *smem = level_smem_bytes(k, radix, tile);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

int launch_level(const void* keys, const void* upper, int rows, int n,
                 int n_real, int k, bool radix, int shift, int tile,
                 void* bucket, void* rank, void* hist, void* stream) {
  const void* kernel;
  int smem;
  cudaError_t err = level_setup(k, radix, tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = (n + tile - 1) / tile;
  const long long ctas = (long long)rows * tiles_per_row;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  const auto launch = radix ? level_fused_kernel<true> : level_fused_kernel<false>;
  launch<<<(unsigned)ctas, level_threads(tile), smem, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)upper, n, n_real, k, shift, tile,
      tiles_per_row, (int*)bucket, (int*)rank, (int*)hist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* level_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1, tree mode, over one row of n keys.
int level_fused_tree(const void* keys, const void* upper, int n, int n_real,
                     int k, int tile, void* bucket, void* rank, void* hist,
                     void* stream) {
  return launch_level(keys, upper, 1, n, n_real, k, false, 0, tile, bucket,
                      rank, hist, stream);
}

// K1r, radix mode, over one row of n keys.
int level_fused_radix(const void* keys, int n, int n_real, int k, int shift,
                      int tile, void* bucket, void* rank, void* hist,
                      void* stream) {
  return launch_level(keys, nullptr, 1, n, n_real, k, true, shift, tile,
                      bucket, rank, hist, stream);
}

// K4, either mode, over `rows` rows of n keys; upper is (rows, k) in tree
// mode and unused in radix mode.
int level_fused_batched(const void* keys, const void* upper, int rows, int n,
                        int n_real, int k, int radix, int shift, int tile,
                        void* bucket, void* rank, void* hist, void* stream) {
  return launch_level(keys, upper, rows, n, n_real, k, radix != 0, shift, tile,
                      bucket, rank, hist, stream);
}

// K1's launch at (k, tile, mode), from the CUDA runtime: out[0] registers
// per thread, out[1] static and out[2] dynamic shared memory per CTA in
// bytes, out[3] threads per CTA, out[4] CTAs an SM holds at once, out[5]
// local memory per thread (spills) in bytes.
int level_fused_info(int k, int radix, int tile, int* out) {
  const void* kernel;
  int smem;
  cudaError_t err = level_setup(k, radix != 0, tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, level_threads(tile),
                                                           smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = level_threads(tile);
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

int level_fused_rank_hist(const void* ids, const void* item_start,
                          const void* item_len, const void* item_seg,
                          int items, int nb, int tile, void* rank, void* slot,
                          void* hist, void* stream) {
  const int smem = (kWarps * nb + 2 * tile) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rank_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (items == 0) return cudaSuccess;
  rank_hist_kernel<<<items, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)item_start, (const int*)item_len,
      (const int*)item_seg, nb, tile, (int*)rank, (int*)slot, (int*)hist);
  return cudaGetLastError();
}

}  // extern "C"
