// K5 merge_path_perm: the stable 2-way merge permutation, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `merge_path_perm` in
// src/repro/kernels/merge_path.py:157 (with its XLA diagonal search
// `merge_path_partition`, :76, and the in-tile bitonic merger, :130): for
// two sorted runs a (nA,) and b (nB,) of encoded int32 keys it writes perm
// (nA+nB,) int32 with cat(a, b)[perm] the stable merge -- ties go to a, and
// each run keeps its own order.  perm holds i for a[i] and nA + j for b[j].
//
// Bound: bytes.  Each output reads one key (4 B) and writes one source
// (4 B): 8 B per output, ~80 us for 2^25 outputs at 3.35 TB/s.  The work is
// a compare and a select per output plus two binary searches per CTA and
// one short search per thread: far below the integer rate.
//
// Design.  One CTA per tile of T consecutive outputs (T a power of two, at
// most 256 threads, T/threads outputs each).  Two threads of the CTA find
// the tile's two cuts with the merge-path binary search on the diagonals
// d0 = tile * T and d1 = min(d0 + T, n): the cut i(d) is the largest i in
// [max(0, d-nB), min(d, nA)] with a[i-1] <= b[d-i], the stable tie rule
// (the reference's condition).  The tile's outputs are then exactly
// a[ia, ia+la) ++ b[ja, ja+lb), which the CTA loads into shared memory.
// Each thread finds its own sub-diagonal in the two windows with the same
// search and merges its outputs sequentially, taking a when a <= b.  The
// sources are staged in shared memory and written coalesced.
//
// Keys compare as signed ints: the port's codes are the reference's
// unsigned codes with the sign bit flipped.  NaN encodes to INT_MAX, the
// value a sentinel pad would hold, so there are no pads: every read is
// bounds-checked against the true run lengths instead.  The TPU kernel's
// bitonic merger, which sorts 2T (key, src) pairs padded to the tile, has
// no reason to exist here: a thread's sequential merge is branch-light and
// does T outputs' work, not T log T.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

// The number of a-keys among the first d outputs of the stable merge.
__device__ __forceinline__ int merge_cut(const int* a, int na, const int* b,
                                         int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;  // in (lo, hi]: a[mid-1], b[d-mid] exist
    if (a[mid - 1] <= b[d - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void merge_path_kernel(const int* __restrict__ a, int na,
                                  const int* __restrict__ b, int nb, int tile,
                                  int per, int* __restrict__ perm) {
  extern __shared__ int smem[];
  int* s_key = smem;         // the a window, then the b window
  int* s_src = smem + tile;  // the tile's sources, in output order
  __shared__ int s_cut[2];
  const int n = na + nb;
  const int d0 = blockIdx.x * tile;
  const int d1 = min(d0 + tile, n);
  if (threadIdx.x < 2) {
    s_cut[threadIdx.x] = merge_cut(a, na, b, nb, threadIdx.x == 0 ? d0 : d1);
  }
  __syncthreads();
  const int ia = s_cut[0];
  const int la = s_cut[1] - ia;
  const int ja = d0 - ia;
  const int len = d1 - d0;
  const int lb = len - la;
  for (int i = threadIdx.x; i < la; i += blockDim.x) s_key[i] = a[ia + i];
  for (int j = threadIdx.x; j < lb; j += blockDim.x) s_key[la + j] = b[ja + j];
  __syncthreads();

  const int* sa = s_key;
  const int* sb = s_key + la;
  const int lo = min((int)threadIdx.x * per, len);
  const int hi = min(lo + per, len);
  int i = merge_cut(sa, la, sb, lb, lo);
  int j = lo - i;
  for (int o = lo; o < hi; ++o) {
    // i + j = o < la + lb, so when a is exhausted b is not
    const bool take_a = i < la && (j >= lb || sa[i] <= sb[j]);
    s_src[o] = take_a ? ia + i : na + ja + j;
    i += take_a ? 1 : 0;
    j += take_a ? 0 : 1;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < len; o += blockDim.x) perm[d0 + o] = s_src[o];
}

}  // namespace

extern "C" {

const char* merge_path_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// perm (na+nb,) of the stable merge of sorted a (na,) and b (nb,); tile is a
// power of two, na + nb < 2^30 (the wrapper checks both).
int merge_path_perm(const void* a, int na, const void* b, int nb, int tile,
                    void* perm, void* stream) {
  const int threads = tile < kMaxThreads ? tile : kMaxThreads;
  const int smem = 2 * tile * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      merge_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n = (long long)na + nb;
  const long long ctas = (n + tile - 1) / tile;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  merge_path_kernel<<<(unsigned)ctas, threads, smem, (cudaStream_t)stream>>>(
      (const int*)a, na, (const int*)b, nb, tile, tile / threads, (int*)perm);
  return cudaGetLastError();
}

}  // extern "C"
