// K7 classify_histogram, classify_histogram_batched and radix_histogram:
// classification plus a per-tile histogram, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/classify.py:
//   `classify_histogram` (:100)         -- tree mode over one row of raw
//      keys of any of the reference's twelve key dtypes (8/16/32/64-bit
//      ints and uints, float16, bfloat16, float32, float64) against k-1
//      splitters and the dtype's max as the last upper: j = #{i < k-1 :
//      key > upper[i]}, eq = any_i (key == upper[i]), id = 2j + eq in
//      [0, 2k);
//   `classify_histogram_batched` (:153) -- the same over (B, n) rows, row b
//      against its own uppers;
//   `radix_histogram` (:222)            -- radix mode over the port's signed
//      int32 or int64 codes: the bits of the code with its sign bit flipped
//      (the reference's unsigned code) at `shift`, masked to log2(k) bits,
//      id = 2j + (code == the signed max), as K1r takes them
//      (`radix_histogram_batched` flattens its rows into one such call).
// Each also writes the tile's histogram of the 2k ids, (tiles, 2k) per row.
// No pad bucket and no rank: that is K1's work (level_fused.cu).
//
// Raw keys, not encoded ones, compared in their own type as the
// reference's dense compare does: signed ints as signed, unsigned ints as
// unsigned (8- and 16-bit ones widened exactly to int, uint32 and uint64 as
// unsigned and unsigned long long), float64 as double, and bfloat16 and
// float16 widened exactly to float and compared against the float
// widening of the uppers.  So NaN compares false everywhere (j = 0, eq =
// 0), -0.0 equals a +0.0 upper, +inf lands in j = k-1 with eq = 0 unless an
// upper is +inf, and a key equal to the dtype's max gets eq = 1.
//
// The reference compares each key against all k uppers.  Here j comes from
// a binary search of the k-1 splitters in shared memory, which counts the
// same splitters when they are sorted ascending with any NaN last (as
// torch.sort and jnp.sort leave them): key > upper[i] then holds on a prefix
// of the splitters.  For such splitters a key equal to any real splitter
// equals upper[j], so eq = (key == upper[j]) || (key == upper[k-1]), the
// second term for the dtype's max (which may follow NaN splitters).
//
// Bound: bytes.  A key read (1, 2, 4 or 8 B) and an id written (4 B) per
// element, and the (tiles, 2k) histogram: ~0.04 ms at 2^24 float32 keys on
// the H100 at 3.35 TB/s, ~0.03 ms for 16-bit keys (6 B a key) and ~0.06 ms
// for 64-bit keys (12 B a key).  The ~log2(k) search steps and one
// shared-memory atomic per element are far below the integer rate (the
// 64-bit compares take two instructions each, still far below it).
//
// Design.  One CTA of 256 threads per (row, tile); the tile is the
// reference's rows * 128 keys, which fixes the histogram's shape.  The
// uppers of the CTA's row are staged in shared memory in the compare type;
// each thread classifies keys at a stride of 256 (coalesced reads and
// writes) and bumps a shared-memory counter with atomicAdd.  The histogram
// is a count, so the order of the atomics does not change it: no rank, no
// warp match.  CTAs are numbered row-major over (row, tile), so hist is
// (rows, tiles_per_row, 2k) and each row's slab is contiguous.  One
// template over the key kind serves every dtype.
#include <climits>
#include <type_traits>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The key kinds, as the wrapper numbers them (kernels/classify.py).
enum Kind {
  kInt32 = 0, kFloat32 = 1, kBFloat16 = 2, kInt8 = 3, kUInt8 = 4, kInt16 = 5,
  kUInt16 = 6, kFloat16 = 7, kUInt32 = 8, kInt64 = 9, kUInt64 = 10, kFloat64 = 11,
};

// A key kind's stored type S and compare type T (the uppers' type too).
template <class S, class T>
struct Plain {
  using Type = T;
  __device__ static T load(const void* p, long long i) {
    return static_cast<T>(static_cast<const S*>(p)[i]);
  }
};

template <int kKind> struct Key;
template <> struct Key<kInt32> : Plain<int, int> {};
template <> struct Key<kFloat32> : Plain<float, float> {};
template <> struct Key<kInt8> : Plain<signed char, int> {};
template <> struct Key<kUInt8> : Plain<unsigned char, int> {};
template <> struct Key<kInt16> : Plain<short, int> {};
template <> struct Key<kUInt16> : Plain<unsigned short, int> {};
template <> struct Key<kUInt32> : Plain<unsigned, unsigned> {};
template <> struct Key<kInt64> : Plain<long long, long long> {};
template <> struct Key<kUInt64> : Plain<unsigned long long, unsigned long long> {};
template <> struct Key<kFloat64> : Plain<double, double> {};

template <>
struct Key<kBFloat16> {  // the raw 16 bits, widened
  using Type = float;
  __device__ static float load(const void* p, long long i) {
    const unsigned bits = static_cast<const unsigned short*>(p)[i];
    return __uint_as_float(bits << 16);
  }
};

template <>
struct Key<kFloat16> {  // widened exactly
  using Type = float;
  __device__ static float load(const void* p, long long i) {
    return __half2float(static_cast<const __half*>(p)[i]);
  }
};

template <int kKind, bool kRadix>
__global__ void classify_hist_kernel(const void* __restrict__ keys,
                                     const void* __restrict__ upper, int n,
                                     int k, int shift, int tile,
                                     int tiles_per_row, int* __restrict__ bucket,
                                     int* __restrict__ hist) {
  using T = typename Key<kKind>::Type;
  extern __shared__ __align__(8) int smem[];
  const int nb = 2 * k;
  int* s_hist = smem;
  T* s_upper = reinterpret_cast<T*>(smem + nb);  // 8k bytes in: 8-byte aligned
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
    const T key = Key<kKind>::load(keys, start + p);
    if constexpr (kRadix) {  // T is int or long long: a signed code
      using U = std::make_unsigned_t<T>;
      constexpr U sign = (U)1 << (8 * sizeof(T) - 1);
      const U bits = ((U)key ^ sign) >> shift;
      b = 2 * (int)(bits & (U)(k - 1)) + (key == (T)(sign - 1) ? 1 : 0);
    } else {
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
  using T = typename Key<kKind>::Type;
  const int smem = 2 * k * (int)sizeof(int) + (kRadix ? 0 : k * (int)sizeof(T));
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

// Tree mode over `rows` rows of n keys of `kind` (Kind above); upper is
// (rows, k) in the kind's compare type: int32 for the int32 and 8- and
// 16-bit int kinds, the raw bits of uint32 / int64 / uint64 / float64, and
// float32 for the three float kinds of 32 bits or fewer.  n is a multiple of
// tile.
int classify_histogram_tree(const void* keys, const void* upper, int kind,
                            int rows, int n, int k, int tile, void* bucket,
                            void* hist, void* stream) {
#define TREE(K)                                                           \
  case K:                                                                 \
    return launch<K, false>(keys, upper, rows, n, k, 0, tile, bucket, hist, \
                            stream)
  switch (kind) {
    TREE(kInt32);
    TREE(kFloat32);
    TREE(kBFloat16);
    TREE(kInt8);
    TREE(kUInt8);
    TREE(kInt16);
    TREE(kUInt16);
    TREE(kFloat16);
    TREE(kUInt32);
    TREE(kInt64);
    TREE(kUInt64);
    TREE(kFloat64);
    default:
      return cudaErrorInvalidValue;
  }
#undef TREE
}

// Radix mode over `rows` rows of n int32 codes.
int classify_histogram_radix(const void* keys, int rows, int n, int k,
                             int shift, int tile, void* bucket, void* hist,
                             void* stream) {
  return launch<kInt32, true>(keys, nullptr, rows, n, k, shift, tile, bucket,
                              hist, stream);
}

// Radix mode over `rows` rows of n int64 codes (shift in [0, 64)).
int classify_histogram_radix64(const void* keys, int rows, int n, int k,
                               int shift, int tile, void* bucket, void* hist,
                               void* stream) {
  return launch<kInt64, true>(keys, nullptr, rows, n, k, shift, tile, bucket,
                              hist, stream);
}

}  // extern "C"
