// K9 permute_blocks_inplace: the paper's parallel block permutation (§4.2,
// Fig. 3) with an atomic write/read pointer pair per bucket, in place in
// the caller's buffer, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `permute_blocks_inplace` in
// src/repro/kernels/permute_inplace.py (:148, kernel :46).  The array is N
// blocks, block i of bucket block_bucket[i]; d (k+1) are the buckets' block
// boundaries.  Bucket b keeps a write pointer w_b (from d_b) and a read
// pointer r_b (from d_{b+1}): [d_b, w_b) is done, [w_b, r_b) unprocessed,
// [r_b, d_{b+1}) emptied.  Every block is read once and written once, into
// its bucket's range.  Not stable: which block of a bucket lands in which of
// the bucket's slots follows the order of the moves, as in the paper and the
// TPU kernel (whose test compares per-bucket block multisets).
//
// Bound: bytes.  Each block is read once and written once: 2 x N x
// block_bytes, 0.64 ms for 1 GiB at 3.35 TB/s.
//
// The first design replayed the TPU kernel's one-core move order: every
// step waited on the bucket of the block taken in the step before, so the
// whole permutation was one chain of dependent ~0.5 us steps (140 ms for
// 262,144 blocks, 219x the bound).  This one runs the paper's threads:
//   - one 64-bit word per bucket holds (w_b << 32 | r_b + 2^31) and every
//     update is one atomicAdd that returns the old pair.  A read adds -1
//     (the bias keeps r's borrow out of w: r falls below w at most twice a
//     CTA) and owns slot r - 1 only if w < r held; a write adds 1 << 32 and,
//     if the old w < r, the slot w is unprocessed, so the CTA swaps (reads
//     the block there, writes its own, holds the one it read); otherwise
//     slot w was emptied by a reader and the held block is dropped there;
//   - a persistent grid of as many CTAs as fit the card (about 8 per SM of
//     256 threads and two swap buffers of one block each in shared memory),
//     each a paper thread: CTA c starts its cyclic primary-bucket scan at
//     bucket c * k / P, reads from its primary bucket until that is
//     exhausted, then moves on; a full cycle of failed reads ends it;
//   - a block moves as 16-byte words, thread t owning words t, t + 256, ...
//     of both buffers, so a CTA's data needs no barrier of its own.
// The race the paper guards with a per-bucket count of pending reads:
// reader R claims slot s by its decrement, then writer W finds s emptied
// and would drop its block into s while R still copies s out.  Here every
// slot has a flag (N ints of scratch, zeroed first) that its
// reader sets once the whole block is in shared memory (a barrier, then a
// __threadfence), as K8's slot states do; a writer into an emptied slot
// waits for the flag.  A reader sets it before any wait of its own, so no
// wait can close a cycle.  Inputs that break the contract (a bucket id
// outside [0, k), a bucket with more blocks than slots) stop the CTA that
// meets them instead of hanging: the output is then unspecified.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kBias = 1ull << 31;  // keeps r's borrow out of w

__device__ __forceinline__ int ptr_w(unsigned long long x) { return (int)(x >> 32); }
__device__ __forceinline__ int ptr_r(unsigned long long x) {
  return (int)((long long)(x & 0xffffffffull) - (long long)kBias);
}

__global__ void __launch_bounds__(kThreads)
permute_inplace_kernel(uint4* __restrict__ a, const int* __restrict__ block_bucket,
                       const int* __restrict__ d, unsigned long long* __restrict__ ptrs,
                       int* __restrict__ read_flag, int k, int nblocks, int words_per_block) {
  extern __shared__ uint4 buf[];  // two swap buffers of one block each
  __shared__ int s_slot, s_r;
  uint4* held = buf;
  uint4* incoming = buf + words_per_block;
  const int tid = threadIdx.x;
  int primary = (int)(((long long)blockIdx.x * k) / gridDim.x);
  for (;;) {
    // read: claim slot r - 1 of the first bucket from the primary on with
    // w < r; a full cycle without one ends the CTA
    if (tid == 0) {
      int slot = -1;
      for (int cnt = 0; cnt < k; ++cnt) {
        const unsigned long long old = atomicAdd(&ptrs[primary], ~0ull);
        if (ptr_w(old) < ptr_r(old)) {
          slot = ptr_r(old) - 1;
          break;
        }
        primary = primary + 1 == k ? 0 : primary + 1;
      }
      s_slot = slot;
    }
    __syncthreads();
    int slot = s_slot;
    if ((unsigned)slot >= (unsigned)nblocks) return;  // done (or a broken input)
    const long long r_off = (long long)slot * words_per_block;
    for (int w = tid; w < words_per_block; w += kThreads) held[w] = a[r_off + w];
    __syncthreads();  // the whole block is read (and s_slot may be reused)
    if (tid == 0) {
      __threadfence();
      atomicExch(&read_flag[slot], 1);
    }
    int dest = block_bucket[slot];
    // write: the held block goes to its bucket's w; swap while the slot
    // there is unprocessed
    for (;;) {
      if ((unsigned)dest >= (unsigned)k) return;  // a bucket id out of range
      if (tid == 0) {
        const unsigned long long old = atomicAdd(&ptrs[dest], 1ull << 32);
        s_slot = ptr_w(old);
        s_r = ptr_r(old);
      }
      __syncthreads();
      slot = s_slot;
      const bool swap = slot < s_r;
      __syncthreads();  // every thread has read s_slot and s_r
      if (slot >= d[dest + 1] || slot < 0) return;  // more blocks than slots
      const long long w_off = (long long)slot * words_per_block;
      if (swap) {
        for (int w = tid; w < words_per_block; w += kThreads) {
          incoming[w] = a[w_off + w];
          a[w_off + w] = held[w];
        }
        uint4* t = held;
        held = incoming;
        incoming = t;
        dest = block_bucket[slot];
        continue;
      }
      // slot was emptied by a reader: wait until its block has been read
      if (tid == 0) {
        while (*(volatile int*)&read_flag[slot] == 0) __nanosleep(32);
        __threadfence();
      }
      __syncthreads();
      for (int w = tid; w < words_per_block; w += kThreads) a[w_off + w] = held[w];
      break;
    }
    // the held buffer is free again once every thread has written its words
    __syncthreads();
  }
}

// the bucket words from d, and every slot's read flag cleared
__global__ void permute_inplace_init(const int* __restrict__ d, unsigned long long* ptrs,
                                     int* read_flag, int k, int nblocks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k + nblocks;
       i += gridDim.x * blockDim.x) {
    if (i < k)
      ptrs[i] = ((unsigned long long)(unsigned)d[i] << 32) | ((unsigned)d[i + 1] + kBias);
    else
      read_flag[i - k] = 0;
  }
}

}  // namespace

extern "C" {

const char* permute_inplace_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: N blocks of words_per_block 16-byte words (16-byte aligned);
// block_bucket (N,) int32 in [0, k); d (k+1,) int32 block boundaries;
// scratch: 8 * k + 4 * N bytes, 8-byte aligned (the bucket words, then the
// read flags).
int permute_inplace(void* a, const void* block_bucket, const void* d, void* scratch, int k,
                    int nblocks, int words_per_block, void* stream) {
  const int smem = 2 * words_per_block * (int)sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      permute_inplace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (nblocks <= 0 || words_per_block <= 0 || k <= 0) return cudaSuccess;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, permute_inplace_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  unsigned long long* ptrs = (unsigned long long*)scratch;
  int* read_flag = (int*)(ptrs + k);
  permute_inplace_init<<<min((k + nblocks + 255) / 256, 4 * sms), 256, 0,
                         (cudaStream_t)stream>>>((const int*)d, ptrs, read_flag, k, nblocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ctas = min(nblocks, sms * per_sm);
  permute_inplace_kernel<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      (uint4*)a, (const int*)block_bucket, (const int*)d, ptrs, read_flag, k, nblocks,
      words_per_block);
  return cudaGetLastError();
}

}  // extern "C"
