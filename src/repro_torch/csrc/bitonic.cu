// K3 sort_windows: the stable base-case window sort, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `bitonic_sort_windows`
// (src/repro/kernels/bitonic.py), driven by `base_case_windows`
// (src/repro/kernels/ops.py).  The TPU network compares (bucket, key) only
// and so is not stable; this kernel orders by (bucket, key, idx), which is
// the stable `_window_perm` that the reference's main path computes.
//
// Bound: bytes.  Per element it reads 4 B of bucket and 4 B of key and
// writes 4 B of window-local index and 4 B of sorted bucket: 16 B, ~80 us
// for 2^24 elements at 3.35 TB/s.  The network's log2(W)(log2(W)+1)/4
// compare-exchanges per element (45.5 at W = 8192) stay in shared memory.
//
// Design.  One CTA of 1024 threads per window of W (a power of two, W <=
// 16384).  Each element is packed into one 64-bit word, bucket in the top
// bits, then the key with its sign bit flipped (so unsigned order is the
// signed key order), then its window index in the low log2(W) bits.  The
// index makes every word distinct, so the plain bitonic network over the
// words is a stable sort by (bucket, key).  The wrapper checks that the
// buckets fit the 32 - log2(W) top bits.  W words of 8 B sit in dynamic
// shared memory (64 KiB at W = 8192); each compare-exchange step is one
// pass of the block over W/2 pairs between barriers.  Right and simple
// first: no register-resident small strides yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void sort_windows_kernel(const int* __restrict__ bucket,
                                    const int* __restrict__ keys, int W,
                                    int log2w, int* __restrict__ perm,
                                    int* __restrict__ bucket_out) {
  extern __shared__ unsigned long long s[];
  const long long base = (long long)blockIdx.x * W;
  const int key_shift = log2w;
  const int bucket_shift = 32 + log2w;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const unsigned long long b = (unsigned)bucket[base + i];
    const unsigned long long key = (unsigned)keys[base + i] ^ 0x80000000u;
    s[i] = (b << bucket_shift) | (key << key_shift) | (unsigned long long)i;
  }
  __syncthreads();

  const int half = W >> 1;
  for (int size = 2; size <= W; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      for (int t = threadIdx.x; t < half; t += kThreads) {
        const int lo = 2 * t - (t & (d - 1));
        const int hi = lo + d;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = s[lo];
        const unsigned long long c = s[hi];
        if ((a > c) == ascending) {
          s[lo] = c;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  const unsigned long long idx_mask = (1ull << log2w) - 1ull;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const unsigned long long v = s[i];
    perm[base + i] = (int)(v & idx_mask);
    bucket_out[base + i] = (int)(v >> bucket_shift);
  }
}

}  // namespace

extern "C" {

const char* bitonic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bitonic_sort_windows(const void* bucket, const void* keys, int num_w, int W,
                         int log2w, void* perm, void* bucket_out,
                         void* stream) {
  const int smem = W * (int)sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      sort_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (num_w == 0) return cudaSuccess;
  sort_windows_kernel<<<num_w, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)bucket, (const int*)keys, W, log2w, (int*)perm,
      (int*)bucket_out);
  return cudaGetLastError();
}

}  // extern "C"
