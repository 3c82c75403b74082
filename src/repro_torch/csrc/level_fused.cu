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
// arithmetic (a log2(k)-step search in shared memory, a warp match and two
// popcounts per element) is far below the integer rate.
//
// Design.  One CTA of 8 warps per tile (K1) or per work item (K2).  The TPU
// ran its grid in order on one core; here the CTAs run in any order, so
// nothing carries between them: each CTA owns its tile's counters.  The
// rank must follow position order -- a rank taken from shared-memory
// atomics would not be stable -- so each warp walks its own contiguous
// span of the tile in 32-wide chunks: __match_any_sync groups the lanes
// holding the same id, popc of the lower lanes of the group is the rank in
// the chunk, and a per-warp counter per id (in shared memory, bumped by the
// group's lowest lane) carries the count across the warp's chunks.  An
// exclusive scan of those counters over the 8 warps then gives each warp's
// start per id, and the scan's total is the tile histogram.  Ids and ranks
// are staged in shared memory between the two phases, so the final writes
// are coalesced.
//
// K1r and K4 share K1's body: the radix mode replaces the shared-memory
// search by a shift and a mask (no splitters to stage), and the batched form
// numbers its CTAs row-major over (row, tile), so a tile never straddles a
// row, pads are routed by the position within the row, and each row's
// histogram slab is contiguous for the per-row epilogue.
//
// K2 at level 2 of the sort takes composite ids seg * W2 + local with up to
// 257 * 256 = 65,792 distinct values: too many counters for one CTA.  But
// segments are contiguous position ranges and the composite id rises with
// the segment, so the stable placement by composite id is, per segment,
// the stable placement by the local id (W2 <= 256 counters) offset by the
// segment's start.  The wrapper cuts work items that never straddle a
// segment; each CTA ranks one item over W2 counters and writes the slot
// item * W2 + local for the epilogue.  No dense (tiles x 65,792) histogram
// exists anywhere.  The batched rank_hist (K4) needs nothing more: the B
// rows, flattened, are B x num_seg segments, each item's segment id given
// to the kernel is its row-local one, and the epilogue subtracts each row's
// start.
#include <climits>

#include <cuda_runtime.h>

#include "rank_hist.cuh"

namespace {

// K1, K1r and K4: one CTA per (row, tile) over `rows` rows of n keys; the
// CTAs are numbered row-major, so hist is (rows, tiles_per_row, 2k+1).
// Tree mode: upper holds each row's k-1 sorted splitters and the sentinel
// (row stride k); the bucket index j is the number of splitters below the
// key, eq = (key == upper[j]).  Radix mode: no splitters, j = the bits of
// the reference's code at `shift`, eq = (key == INT_MAX, the sentinel).
template <bool kRadix>
__global__ void level_fused_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ upper, int n,
                                   int n_real, int k, int shift, int tile,
                                   int tiles_per_row, int* __restrict__ bucket,
                                   int* __restrict__ rank,
                                   int* __restrict__ hist) {
  extern __shared__ int smem[];
  const int nb = 2 * k + 1;
  const int row = blockIdx.x / tiles_per_row;
  const int col = (blockIdx.x - row * tiles_per_row) * tile;
  int* s_upper = smem;
  int* cnt = s_upper + (kRadix ? 0 : k);
  int* s_id = cnt + kWarps * nb;
  int* s_rank = s_id + tile;
  if (!kRadix) {
    const int* row_upper = upper + (long long)row * k;
    for (int i = threadIdx.x; i < k; i += kThreads) s_upper[i] = row_upper[i];
    // (rank_hist_item's first barrier publishes s_upper)
  }

  const long long start = (long long)row * n + col;
  const int len = min(tile, n - col);
  auto get_id = [&](int p) -> int {
    if (col + p >= n_real) return 2 * k;  // a pad of this row
    const int key = keys[start + p];
    if (kRadix) {
      const unsigned bits = ((unsigned)key ^ 0x80000000u) >> shift;
      return 2 * (int)(bits & (unsigned)(k - 1)) + (key == INT_MAX ? 1 : 0);
    }
    int j = 0;
    for (int step = k >> 1; step > 0; step >>= 1)
      j += (s_upper[j + step - 1] < key) ? step : 0;
    return 2 * j + (key == s_upper[j] ? 1 : 0);
  };
  auto emit = [&](int p, int b, int r) {
    bucket[start + p] = b;
    rank[start + p] = r;
  };
  rank_hist_item(len, nb, get_id, emit, hist + (long long)blockIdx.x * nb, cnt,
                 s_id, s_rank);
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

int launch_level(const void* keys, const void* upper, int rows, int n,
                 int n_real, int k, bool radix, int shift, int tile,
                 void* bucket, void* rank, void* hist, void* stream) {
  const int nb = 2 * k + 1;
  const int smem = ((radix ? 0 : k) + kWarps * nb + 2 * tile) * (int)sizeof(int);
  const auto kernel = radix ? &level_fused_kernel<true> : &level_fused_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = (n + tile - 1) / tile;
  const long long ctas = (long long)rows * tiles_per_row;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
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
