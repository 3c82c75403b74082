// K6 stable counting placement (dispatch_ranks, partition_ranks,
// partition_ranks_batched), by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/dispatch_rank.py:
// `dispatch_ranks` (:87, MoE experts), `partition_ranks` (:154, nb buckets)
// and `partition_ranks_batched` (:224, per row).  The three share one
// contract, so here they are one kernel with a row dimension: for `rows`
// rows of n ids,
//   dest[row, i] = start[row, b] + #{j < i : id[row, j] == b},  b = id[row, i],
// for ids in [0, nb).  Other ids (the trash id nb the reference pads with)
// never touch a counter and get dest -1.
//
// Bound: bytes.  4 B of id read and 4 B of dest written per element: 8 B,
// ~30 us for 12.6M ids at 3.35 TB/s.  The work per element (a warp match,
// two popcounts, a few shared-memory reads) is far below the integer rate.
//
// Design.  The TPU kernel carried running counters across its sequential
// grid; CTAs here run in any order, so nothing can carry between them.
// Three launches, as in the port's K2 with a prefix in between:
//   1. tile_hist: one CTA per (row, tile) counts its ids into hist[row, t, :]
//      with shared-memory atomics, one per distinct id per 32 lanes
//      (__match_any_sync aggregates a warp's equal ids, so a skewed mix does
//      not serialise on one counter);
//   2. scan_tiles: the exclusive scan over the tiles of each (row, id), in
//      place.  A CTA of 32 x 32 threads takes 32 ids of one row: x runs over
//      neighbouring ids (coalesced reads), each y sums a contiguous run of
//      tiles, and a scan over y in shared memory orders the runs.  No torch
//      cumsum along the outer dim of the (tiles, nb) histogram, which cost
//      1.1 ms per call on this card;
//   3. place: one CTA per (row, tile) reruns the stable in-tile rank of
//      rank_hist.cuh (warp spans, __match_any_sync + popc, per-warp counters,
//      a scan over the warps) and writes dest = start[row, b] +
//      tile_off[row, t, b] + rank.
// The ids are read twice and the ranks never stored: 12 B per element
// against the bound's 8.  Shared memory of `place`: (9 * nb + 2 * tile)
// ints, so nb <= 4096 at tile 4096 (the wrapper checks).
#include <climits>

#include <cuda_runtime.h>

#include "rank_hist.cuh"

namespace {

__global__ void tile_hist_kernel(const int* __restrict__ ids, int n, int nb,
                                 int tile, int tiles_per_row,
                                 int* __restrict__ hist) {
  extern __shared__ int cnt[];
  const int row = blockIdx.x / tiles_per_row;
  const int col = (blockIdx.x - row * tiles_per_row) * tile;
  for (int i = threadIdx.x; i < nb; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const long long start = (long long)row * n + col;
  const int len = min(tile, n - col);
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < len; base += kThreads) {  // uniform: whole warps
    const int p = base + threadIdx.x;
    int b = -1;
    if (p < len) {
      b = ids[start + p];
      if (b < 0 || b >= nb) b = -1;
    }
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && __ffs(same) - 1 == lane) atomicAdd(&cnt[b], __popc(same));
  }
  __syncthreads();
  int* out = hist + (long long)blockIdx.x * nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) out[i] = cnt[i];
}

// grid (ceil(nb / 32), rows), block (32, 32)
__global__ void scan_tiles_kernel(int* __restrict__ hist, int nb, int tiles) {
  __shared__ int part[32][33];
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int per = (tiles + 31) / 32;
  const int t0 = min((int)threadIdx.y * per, tiles);
  const int t1 = min(t0 + per, tiles);
  int* h = hist + (long long)blockIdx.y * tiles * nb;
  int sum = 0;
  if (b < nb) {
    for (int t = t0; t < t1; ++t) sum += h[(long long)t * nb + b];
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  int run = 0;
  for (int y = 0; y < (int)threadIdx.y; ++y) run += part[y][threadIdx.x];
  if (b < nb) {
    for (int t = t0; t < t1; ++t) {
      const long long at = (long long)t * nb + b;
      const int c = h[at];
      h[at] = run;
      run += c;
    }
  }
}

__global__ void place_kernel(const int* __restrict__ ids,
                             const int* __restrict__ start,
                             const int* __restrict__ tile_off, int n, int nb,
                             int tile, int tiles_per_row,
                             int* __restrict__ dest) {
  extern __shared__ int smem[];
  int* s_base = smem;            // nb: start + tile_off of this tile
  int* cnt = s_base + nb;        // kWarps * nb
  int* s_id = cnt + kWarps * nb;  // tile
  int* s_rank = s_id + tile;     // tile
  const int row = blockIdx.x / tiles_per_row;
  const int col = (blockIdx.x - row * tiles_per_row) * tile;
  const int* row_start = start + (long long)row * nb;
  const int* off = tile_off + (long long)blockIdx.x * nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) s_base[i] = row_start[i] + off[i];
  // (rank_hist_item's first barrier publishes s_base)
  const long long at = (long long)row * n + col;
  const int len = min(tile, n - col);
  auto get_id = [&](int p) -> int { return ids[at + p]; };
  auto emit = [&](int p, int b, int r) { dest[at + p] = b < 0 ? -1 : s_base[b] + r; };
  rank_hist_item(len, nb, get_id, emit, nullptr, cnt, s_id, s_rank);
}

}  // namespace

extern "C" {

const char* dispatch_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dest (rows, n) from ids (rows, n) and start (rows, nb); hist is scratch of
// rows * ceil(n / tile) * nb ints.
int dispatch_rank_place(const void* ids, const void* start, int rows, int n,
                        int nb, int tile, void* hist, void* dest,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int place_smem = ((kWarps + 1) * nb + 2 * tile) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, place_smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = (n + tile - 1) / tile;
  const long long ctas = (long long)rows * tiles_per_row;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX || rows > 65535) return cudaErrorInvalidConfiguration;
  tile_hist_kernel<<<(unsigned)ctas, kThreads, nb * sizeof(int), s>>>(
      (const int*)ids, n, nb, tile, tiles_per_row, (int*)hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles_kernel<<<dim3((nb + 31) / 32, rows), dim3(32, 32), 0, s>>>(
      (int*)hist, nb, tiles_per_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place_kernel<<<(unsigned)ctas, kThreads, place_smem, s>>>(
      (const int*)ids, (const int*)start, (const int*)hist, n, nb, tile,
      tiles_per_row, (int*)dest);
  return cudaGetLastError();
}

}  // extern "C"
