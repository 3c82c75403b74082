// K9 permute_blocks_inplace: the paper's Fig.-3 block permutation with
// per-bucket write/read pointers, in place in the caller's buffer, by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `permute_blocks_inplace` in
// src/repro/kernels/permute_inplace.py (:148, kernel :46).  The array is N
// blocks, block i of bucket block_bucket[i]; d (k+1) are the buckets' block
// boundaries.  Bucket b keeps a write pointer w_b (from d_b) and a read
// pointer r_b (from d_{b+1}): [d_b, w_b) is done, [w_b, r_b) unprocessed,
// [r_b, d_{b+1}) emptied.  Each step writes one block:
//   - with no block held, scan the buckets cyclically from the last primary
//     bucket for one with w < r, take the block at r - 1 (r decrements);
//     none left: done;
//   - the held block of bucket b goes to w_b: if w_b < r_b the block there
//     is unprocessed, so it is taken first (exchange) and held next;
//     otherwise slot w_b was emptied and the hold ends; w_b increments.
// The permutation is not stable, so its output depends on this order; the
// kernel replays the reference's order exactly and matches it bit for bit.
//
// Bound: bytes.  Each block is read once and written once: 2 x N x
// block_bytes, 0.64 ms for 1 GiB at 3.35 TB/s.  This kernel is bound by
// latency: every step depends on the bucket of the block taken in the step
// before (a read of block_bucket, L2) and on the pointers it moved.
//
// Design: the simple right kernel, one serial replay as the TPU's
// sequential grid runs it.  Every thread moves the same 16-byte word of
// every block (the held block lives in registers, one word per thread), so
// no thread reads a word another thread writes and the data needs no
// barrier.  One warp per CTA, CTA c owning words [32c, 32c + 32) of every
// block; each CTA replays the same control with its own w/r pointers in
// shared memory (2k ints): lane 0 writes them, and __syncwarp orders the
// writes between the lanes' reads.  At most N + 1 steps, as the reference's
// grid; a slot or bucket out of range (inputs that break the contract)
// stops the replay.
#include <climits>

#include <cuda_runtime.h>

namespace {

__global__ void permute_inplace_kernel(uint4* __restrict__ a,
                                       const int* __restrict__ block_bucket,
                                       const int* __restrict__ d, int k,
                                       int nblocks, int words_per_block) {
  extern __shared__ int ptr[];
  int* w_ptr = ptr;
  int* r_ptr = ptr + k;
  const int lane = threadIdx.x;
  const int w = blockIdx.x * 32 + lane;
  const bool live = w < words_per_block;
  for (int i = lane; i < k; i += 32) {
    w_ptr[i] = d[i];
    r_ptr[i] = d[i + 1];
  }
  __syncwarp();

  bool filled = false;
  int primary = 0;
  int held_bucket = 0;
  uint4 held = make_uint4(0, 0, 0, 0);
  for (int step = 0; step <= nblocks; ++step) {
    if (!filled) {  // cyclic primary-bucket scan, then read at r - 1
      int p = primary;
      for (int cnt = 0; cnt < k && w_ptr[p] >= r_ptr[p]; ++cnt) p = (p + 1) % k;
      primary = p;
      const int src = r_ptr[p] - 1;
      if (w_ptr[p] > src) break;  // every bucket done
      if (src < 0 || src >= nblocks) return;
      __syncwarp();
      if (lane == 0) r_ptr[p] = src;
      if (live) held = a[(long long)src * words_per_block + w];
      held_bucket = block_bucket[src];
      filled = true;
      __syncwarp();
    }
    const int dest = held_bucket;
    if (dest < 0 || dest >= k) return;
    const int wd = w_ptr[dest];
    if (wd < 0 || wd >= nblocks) return;
    const bool exchange = wd < r_ptr[dest];
    const long long off = (long long)wd * words_per_block + w;
    uint4 taken = make_uint4(0, 0, 0, 0);
    int taken_bucket = 0;
    if (exchange) {
      if (live) taken = a[off];
      taken_bucket = block_bucket[wd];
    }
    if (live) a[off] = held;
    __syncwarp();
    if (lane == 0) w_ptr[dest] = wd + 1;
    __syncwarp();
    if (exchange) {
      held = taken;
      held_bucket = taken_bucket;
    } else {
      filled = false;
    }
  }
}

}  // namespace

extern "C" {

const char* permute_inplace_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: N blocks of words_per_block 16-byte words (16-byte aligned);
// block_bucket (N,) int32 in [0, k); d (k+1,) int32 block boundaries.
int permute_inplace(void* a, const void* block_bucket, const void* d, int k,
                    int nblocks, int words_per_block, void* stream) {
  const int smem = 2 * k * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      permute_inplace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  if (nblocks <= 0 || words_per_block <= 0 || k <= 0) return cudaSuccess;
  const int ctas = (words_per_block + 31) / 32;
  permute_inplace_kernel<<<ctas, 32, smem, (cudaStream_t)stream>>>(
      (uint4*)a, (const int*)block_bucket, (const int*)d, k, nblocks,
      words_per_block);
  return cudaGetLastError();
}

}  // extern "C"
