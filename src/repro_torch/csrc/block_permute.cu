// K8 permute_blocks_by_dest: move block i of an array to slot dst[i], in
// place in the caller's buffer, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `permute_blocks_by_dest` in
// src/repro/kernels/block_permute.py (:145, kernel :64): N full blocks of
// `block_bytes` each move along the cycles of the permutation dst, with no
// second n-sized buffer.  A trailing partial block is never touched (the
// wrapper passes only the N full blocks).  Bytes move as 16-byte words,
// whatever the element type.
//
// Bound: bytes.  Each block is read once and written once: 2 x N x
// block_bytes, 0.64 ms for 1 GiB at 3.35 TB/s.
//
// Design.  The TPU kernel chases the cycles one after another over its
// sequential grid; chased that way on the card (one CTA), every block move
// waits for the one before it, ~0.5 us each, 125 ms for 262,144 blocks.
// Since dst is explicit, the output does not depend on the order of the
// moves, so the cycles are cut into chains that CTAs follow at once:
//   - every slot has a state, unread -> being read -> read, changed by CAS
//     (state[], N ints of scratch, zeroed by the wrapper);
//   - a CTA claims a start slot s from a global cursor (unread -> being
//     read), reads block s into shared memory and marks s read; it now holds
//     the block destined for d = dst[s];
//   - it tries to claim d.  Won: it reads d's block, writes the held block
//     into d, marks d read, and carries d's block on to dst[d].  Lost
//     (another CTA claimed d, or d is the chain's own start): it waits until
//     d is marked read, writes the held block into d and takes a new start.
// Each slot is claimed, so read, exactly once, before the one block
// destined for it is written there, and a CTA only waits on a slot whose
// claimer is reading it, which needs nothing else: no cycle of waits.  A
// CTA's threads split the block's words, so the data passes through shared
// memory without barriers; a barrier orders the reads before the read mark,
// and a __threadfence publishes them.  A persistent grid of as many CTAs as
// fit the card keeps ~1,000 chains in flight.
//
// A dst that is not a permutation cannot hang the kernel: a CTA stops at a
// slot outside [0, N), and a wait is only ever on a slot being read.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnread = 0;
constexpr int kReading = 1;
constexpr int kRead = 2;

__global__ void __launch_bounds__(kThreads)
permute_by_dest_kernel(uint4* __restrict__ a, const int* __restrict__ dst,
                       int* __restrict__ state, int* __restrict__ cursor,
                       int nblocks, int words_per_block) {
  extern __shared__ uint4 buf[];  // two blocks: the held one and the next
  __shared__ int s_val;
  uint4* held = buf;
  uint4* incoming = buf + words_per_block;
  const int tid = threadIdx.x;
  for (;;) {
    if (tid == 0) {  // claim the next unread start slot
      int s = atomicAdd(cursor, 1);
      while (s < nblocks && atomicCAS(&state[s], kUnread, kReading) != kUnread) {
        s = atomicAdd(cursor, 1);
      }
      s_val = s;
    }
    __syncthreads();
    const int s = s_val;
    __syncthreads();  // every thread has s before s_val is reused
    if (s >= nblocks) return;
    const long long s_off = (long long)s * words_per_block;
    for (int w = tid; w < words_per_block; w += kThreads) held[w] = a[s_off + w];
    __syncthreads();  // the whole block is read
    if (tid == 0) {
      __threadfence();
      atomicExch(&state[s], kRead);
    }
    int d = dst[s];
    for (;;) {
      if ((unsigned)d >= (unsigned)nblocks) return;  // not a permutation
      if (tid == 0) s_val = atomicCAS(&state[d], kUnread, kReading);
      __syncthreads();
      const bool won = s_val == kUnread;
      const long long d_off = (long long)d * words_per_block;
      if (!won) {  // wait until d's claimer has read it, then drop the block
        if (tid == 0) {
          while (*(volatile int*)&state[d] != kRead) __nanosleep(64);
          __threadfence();
        }
        __syncthreads();
        for (int w = tid; w < words_per_block; w += kThreads) a[d_off + w] = held[w];
        __syncthreads();  // s_val and the buffers are free again
        break;
      }
      for (int w = tid; w < words_per_block; w += kThreads) {
        incoming[w] = a[d_off + w];
        a[d_off + w] = held[w];
      }
      __syncthreads();  // the whole of d's block is read
      if (tid == 0) {
        __threadfence();
        atomicExch(&state[d], kRead);
      }
      uint4* t = held;
      held = incoming;
      incoming = t;
      d = dst[d];
    }
  }
}

}  // namespace

extern "C" {

const char* block_permute_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: N blocks of words_per_block 16-byte words (16-byte aligned); dst: (N,)
// int32, a permutation of [0, N); scratch: N + 1 zeroed ints (the slot
// states and the cursor).
int block_permute_by_dest(void* a, const void* dst, void* scratch, int nblocks,
                          int words_per_block, void* stream) {
  const int smem = 2 * words_per_block * (int)sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      permute_by_dest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  if (nblocks <= 1 || words_per_block <= 0) return cudaSuccess;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, permute_by_dest_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ctas = min(nblocks, sms * per_sm);
  int* state = (int*)scratch;
  permute_by_dest_kernel<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      (uint4*)a, (const int*)dst, state, state + nblocks, nblocks,
      words_per_block);
  return cudaGetLastError();
}

}  // extern "C"
