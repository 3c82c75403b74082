// K7 classify_histogram, classify_histogram_batched and radix_histogram:
// classification plus a per-tile histogram, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/classify.py:
//   `classify_histogram` (:100)         -- tree mode over one row of raw
//      keys (int32, float32 or bfloat16) against k-1 splitters and the
//      dtype's max as the last upper: j = #{i < k-1 : key > upper[i]},
//      eq = any_i (key == upper[i]), id = 2j + eq in [0, 2k);
//   `classify_histogram_batched` (:153) -- the same over (B, n) rows, row b
//      against its own uppers;
//   `radix_histogram` (:222)            -- radix mode over the port's signed
//      codes: the bits of (unsigned)key ^ 0x80000000 at `shift`, masked to
//      log2(k) bits, id = 2j + (key == INT_MAX), as K1r takes them
//      (`radix_histogram_batched` flattens its rows into one such call).
// Each also writes the tile's histogram of the 2k ids, (tiles, 2k) per row.
// No pad bucket and no rank: that is K1's work (level_fused.cu).
//
// Raw keys, not encoded ones: NaN compares false everywhere (j = 0, eq =
// 0), -0.0 equals a +0.0 upper, +inf lands in j = k-1 with eq = 0 unless
// an upper is +inf, and a key equal to the dtype's max gets eq = 1.
// bfloat16 keys are widened to float32 (exact) and compared against the
// float32 widening of the uppers.
//
// The reference compares each key against all k uppers.  Here j comes from
// a binary search of the k-1 splitters in shared memory, which counts the
// same splitters when they are sorted ascending with any NaN last (as
// torch.sort and jnp.sort leave them): key > upper[i] then holds on a prefix
// of the splitters.  For such splitters a key equal to any real splitter
// equals upper[j], so eq = (key == upper[j]) || (key == upper[k-1]), the
// second term for the dtype's max (which may follow NaN splitters).
//
// Bound: bytes.  A key read (4 or 2 B) and an id written (4 B) per element,
// and the (tiles, 2k) histogram: ~0.04 ms at 2^24 float32 keys on the H100
// at 3.35 TB/s.  The ~log2(k) search steps and one shared-memory atomic per
// element are far below the integer rate.
//
// Design.  One CTA of 256 threads per (row, tile); the tile is the
// reference's rows * 128 keys, which fixes the histogram's shape.  The
// uppers of the CTA's row are staged in shared memory; each thread
// classifies keys at a stride of 256 (coalesced reads and writes) and bumps
// a shared-memory counter with atomicAdd.  The histogram is a count, so
// the order of the atomics does not change it: no rank, no warp match.
// CTAs are numbered row-major over (row, tile), so hist is (rows,
// tiles_per_row, 2k) and each row's slab is contiguous.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// key loads: kind 0 int32, 1 float32, 2 bfloat16 (raw 16 bits, widened)
template <int kKind>
struct Key {
  using T = float;
  __device__ static float load(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
};

template <>
struct Key<0> {
  using T = int;
  __device__ static int load(const void* p, long long i) {
    return static_cast<const int*>(p)[i];
  }
};

template <>
struct Key<2> {
  using T = float;
  __device__ static float load(const void* p, long long i) {
    const unsigned bits = static_cast<const unsigned short*>(p)[i];
    return __uint_as_float(bits << 16);
  }
};

template <int kKind, bool kRadix>
__global__ void classify_hist_kernel(const void* __restrict__ keys,
                                     const void* __restrict__ upper, int n,
                                     int k, int shift, int tile,
                                     int tiles_per_row, int* __restrict__ bucket,
                                     int* __restrict__ hist) {
  using T = typename Key<kKind>::T;
  extern __shared__ int smem[];
  const int nb = 2 * k;
  int* s_hist = smem;
  T* s_upper = reinterpret_cast<T*>(smem + nb);
  const int row = blockIdx.x / tiles_per_row;
  const int col = (blockIdx.x - row * tiles_per_row) * tile;
  for (int i = threadIdx.x; i < nb; i += kThreads) s_hist[i] = 0;
  if (!kRadix) {
    const T* row_upper = static_cast<const T*>(upper) + (long long)row * k;
    for (int i = threadIdx.x; i < k; i += kThreads) s_upper[i] = row_upper[i];
  }
  __syncthreads();

  const long long start = (long long)row * n + col;
  const int len = min(tile, n - col);
  for (int p = threadIdx.x; p < len; p += kThreads) {
    int b;
    if (kRadix) {
      const int key = static_cast<const int*>(keys)[start + p];
      const unsigned bits = ((unsigned)key ^ 0x80000000u) >> shift;
      b = 2 * (int)(bits & (unsigned)(k - 1)) + (key == INT_MAX ? 1 : 0);
    } else {
      const T key = Key<kKind>::load(keys, start + p);
      int lo = 0, hi = k - 1;  // j = the splitters below the key, in [0, k-1]
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_upper[mid] < key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      b = 2 * lo + ((key == s_upper[lo] || key == s_upper[k - 1]) ? 1 : 0);
    }
    bucket[start + p] = b;
    atomicAdd(&s_hist[b], 1);
  }
  __syncthreads();
  int* hist_row = hist + (long long)blockIdx.x * nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) hist_row[i] = s_hist[i];
}

template <int kKind, bool kRadix>
int launch(const void* keys, const void* upper, int rows, int n, int k,
           int shift, int tile, void* bucket, void* hist, void* stream) {
  const int smem = (2 * k + (kRadix ? 0 : k)) * (int)sizeof(int);
  const auto kernel = &classify_hist_kernel<kKind, kRadix>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = n / tile;
  const long long ctas = (long long)rows * tiles_per_row;
  if (ctas == 0) return cudaSuccess;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      keys, upper, n, k, shift, tile, tiles_per_row, (int*)bucket, (int*)hist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* classify_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Tree mode over `rows` rows of n keys of `kind` (0 int32, 1 float32, 2
// bfloat16); upper is (rows, k), int32 for int32 keys and float32 otherwise.
// n is a multiple of tile.
int classify_histogram_tree(const void* keys, const void* upper, int kind,
                            int rows, int n, int k, int tile, void* bucket,
                            void* hist, void* stream) {
  switch (kind) {
    case 0:
      return launch<0, false>(keys, upper, rows, n, k, 0, tile, bucket, hist,
                              stream);
    case 1:
      return launch<1, false>(keys, upper, rows, n, k, 0, tile, bucket, hist,
                              stream);
    case 2:
      return launch<2, false>(keys, upper, rows, n, k, 0, tile, bucket, hist,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Radix mode over `rows` rows of n int32 codes.
int classify_histogram_radix(const void* keys, int rows, int n, int k,
                             int shift, int tile, void* bucket, void* hist,
                             void* stream) {
  return launch<0, true>(keys, nullptr, rows, n, k, shift, tile, bucket, hist,
                         stream);
}

}  // extern "C"
