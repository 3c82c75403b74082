// G5: the keyspace codec and the sort's pad, by hand for Hopper (sm_90a).
//
// This replaces no Pallas TPU kernel.  The reference maps its keys into the
// ordered keyspace and back with XLA (`encode`, src/repro/ops/keyspace.py:94,
// `decode`, :118) and pads them with XLA too (src/repro/core/ips4o.py:289);
// XLA fuses that into one pass on the TPU.  The port ran it as chains of
// eager torch ops (two `where`s, `isnan`, casts, then zeros, a copy and a
// fill per array); those chains stay as the plain twins (ops/keyspace.py,
// core/ips4o.py `_pad`, kernels/codec.py).
//
//   encode -- keys (rows, n) of any of the twelve key dtypes, read as raw
//      bits, to codes (rows, n_pad): int32 for keys of 32 bits or fewer
//      (narrow keys left-aligned, the all-ones code filling the low bits),
//      int64 for 64-bit keys; positions n..n_pad-1 of each row get the
//      sentinel (the code dtype's max).  Optionally the complement of each
//      code (`~`, the top-k's order reversal; the pads stay the max) and
//      the int32 index payload, idx[r, i] = i below n and 0 in the pads.
//   decode -- the first n codes of each row of a (rows, stride) buffer (the
//      sorted, padded keys) back to the caller's dtype: NaN comes back as
//      the reference's canonical NaN bits, narrow floats are rebuilt from
//      their 16-bit codes, never through a float conversion.
//
// Bound: bytes.  Encode reads each key once (1-8 B) and writes each code
// (4 or 8 B) and the index (4 B) once: 8 B a float32 key, 12 B with the
// index, ~40 us and ~60 us at 2^24 and 3.35 TB/s.  Decode reads a code and
// writes a key.  A handful of integer operations a key.
//
// Design.  One launch each.  A CTA takes a stretch of kThreads * kPer
// positions of one row (grid y over the rows, a grid-stride loop beyond
// 65,535 of them); each thread its kPer positions kThreads apart, so every
// load and store of the warp is coalesced, all kPer loads in flight before
// the stores.  The dtype is a template (its raw width and its kind: signed
// int, unsigned int, IEEE float or bfloat16), so the per-key work is a few
// compares and selects on the raw bits, as the plain twin's formulas.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kSpan = kThreads * kPer;

enum Kind { kSigned = 0, kUnsigned = 1, kFloat = 2, kBFloat = 3 };

template <int Bits>
struct Raw;
template <>
struct Raw<8> { using T = unsigned char; };
template <>
struct Raw<16> { using T = unsigned short; };
template <>
struct Raw<32> { using T = unsigned; };
template <>
struct Raw<64> { using T = unsigned long long; };

// Whether the raw bits of an IEEE key (float16, float32, float64: the
// exponent all ones above `kInf`; bfloat16 the same with 8 exponent bits)
// are a NaN.
template <int Bits, int K>
__device__ __forceinline__ bool is_nan(unsigned long long raw) {
  if (K == kSigned || K == kUnsigned) return false;
  constexpr unsigned long long sign = 1ull << (Bits - 1);
  constexpr unsigned long long inf = Bits == 16 ? (K == kBFloat ? 0x7f80ull : 0x7c00ull)
                                     : Bits == 32 ? 0x7f800000ull
                                                  : 0x7ff0000000000000ull;
  return (raw & (sign - 1)) > inf;
}

// The port's code of a key of Bits <= 16 bits: the reference's Bits-wide
// unsigned code u, left-aligned in 32 bits, the all-ones u filling the low
// bits (ops/keyspace.py `encode`).
template <int Bits, int K>
__device__ __forceinline__ int encode_narrow(unsigned raw) {
  constexpr unsigned mask = (1u << Bits) - 1, sign = 1u << (Bits - 1);
  constexpr int s = 32 - Bits;
  unsigned u = raw & mask;
  if (K == kSigned) u ^= sign;
  if (K == kFloat || K == kBFloat) {
    u = (u & sign) ? (u ^ mask) : (u | sign);
    if (is_nan<Bits, K>(raw & mask)) u = mask;
  }
  const unsigned code = ((u - sign) << s) + (u == mask ? (1u << s) - 1 : 0u);
  return (int)code;
}

// The code of a 32- or 64-bit key: the identity for signed ints, the sign
// bit flipped for unsigned ones, the magnitude bits complemented for
// negative floats, NaN the signed max.
template <int Bits, int K>
__device__ __forceinline__ typename Raw<Bits>::T encode_wide(typename Raw<Bits>::T raw) {
  using T = typename Raw<Bits>::T;
  constexpr T sign = (T)1 << (Bits - 1);
  if (K == kSigned) return raw;
  if (K == kUnsigned) return raw ^ sign;
  if (is_nan<Bits, K>(raw)) return sign - 1;
  return (raw & sign) ? raw ^ (sign - 1) : raw;
}

template <int Bits, int K>
__device__ __forceinline__ typename Raw<Bits>::T decode_narrow(int code) {
  constexpr unsigned mask = (1u << Bits) - 1, sign = 1u << (Bits - 1);
  const unsigned u = (unsigned)((code >> (32 - Bits)) + (int)sign);  // in [0, 2^Bits)
  unsigned raw = u;
  if (K == kSigned) raw = u ^ sign;
  if (K == kFloat || K == kBFloat) raw = (u & sign) ? (u ^ sign) : (u ^ mask);
  return (typename Raw<Bits>::T)raw;
}

template <int Bits, int K>
__device__ __forceinline__ typename Raw<Bits>::T decode_wide(typename Raw<Bits>::T code) {
  using T = typename Raw<Bits>::T;
  constexpr T sign = (T)1 << (Bits - 1);
  if (K == kSigned) return code;
  if (K == kUnsigned) return code ^ sign;
  return (code & sign) ? code ^ (sign - 1) : code;
}

template <int Bits>
struct CodeOf {
  using T = typename std::conditional<Bits == 64, unsigned long long, unsigned>::type;
};

template <int Bits, int K>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const typename Raw<Bits>::T* __restrict__ keys, int rows, int n, int n_pad,
                  bool complement, typename CodeOf<Bits>::T* __restrict__ codes,
                  int* __restrict__ index) {
  using R = typename Raw<Bits>::T;
  using C = typename CodeOf<Bits>::T;
  constexpr C kSentinel = ((C)1 << (sizeof(C) * 8 - 1)) - 1;
  const int p0 = blockIdx.x * kSpan + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const R* rk = keys + (long long)row * n;
    C* rc = codes + (long long)row * n_pad;
    R raw[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads;
      raw[j] = p < n ? rk[p] : (R)0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads;
      if (p >= n_pad) continue;
      C code = kSentinel;
      if (p < n) {
        if constexpr (Bits < 32) {
          code = (C)encode_narrow<Bits, K>((unsigned)raw[j]);
        } else {
          code = (C)encode_wide<Bits, K>(raw[j]);
        }
        if (complement) code = ~code;
      }
      rc[p] = code;
      if (index != nullptr) index[(long long)row * n_pad + p] = p < n ? p : 0;
    }
  }
}

template <int Bits, int K>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const typename CodeOf<Bits>::T* __restrict__ codes, int rows, int n, int stride,
                  bool complement, typename Raw<Bits>::T* __restrict__ out) {
  using C = typename CodeOf<Bits>::T;
  const int p0 = blockIdx.x * kSpan + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const C* rc = codes + (long long)row * stride;
    C code[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads;
      code[j] = p < n ? rc[p] : (C)0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + j * kThreads;
      if (p >= n) continue;
      const C c = complement ? ~code[j] : code[j];
      if constexpr (Bits < 32) {
        out[(long long)row * n + p] = decode_narrow<Bits, K>((int)c);
      } else {
        out[(long long)row * n + p] = decode_wide<Bits, K>(c);
      }
    }
  }
}

dim3 grid_of(int rows, int width) {
  const int spans = (width + kSpan - 1) / kSpan;
  return dim3((unsigned)spans, (unsigned)(rows < 65535 ? rows : 65535));
}

template <int Bits, int K>
cudaError_t launch_encode(const void* keys, int rows, int n, int n_pad, int complement,
                          void* codes, void* index, cudaStream_t s) {
  encode_kernel<Bits, K><<<grid_of(rows, n_pad), kThreads, 0, s>>>(
      (const typename Raw<Bits>::T*)keys, rows, n, n_pad, complement != 0,
      (typename CodeOf<Bits>::T*)codes, (int*)index);
  return cudaGetLastError();
}

template <int Bits, int K>
cudaError_t launch_decode(const void* codes, int rows, int n, int stride, int complement,
                          void* out, cudaStream_t s) {
  decode_kernel<Bits, K><<<grid_of(rows, n), kThreads, 0, s>>>(
      (const typename CodeOf<Bits>::T*)codes, rows, n, stride, complement != 0,
      (typename Raw<Bits>::T*)out);
  return cudaGetLastError();
}

// The (bits, kind) pairs of the twelve key dtypes.
#define CODEC_DISPATCH(CALL)                                       \
  switch (bits * 4 + kind) {                                       \
    case 8 * 4 + kSigned: return CALL(8, kSigned);                 \
    case 8 * 4 + kUnsigned: return CALL(8, kUnsigned);             \
    case 16 * 4 + kSigned: return CALL(16, kSigned);               \
    case 16 * 4 + kUnsigned: return CALL(16, kUnsigned);           \
    case 16 * 4 + kFloat: return CALL(16, kFloat);                 \
    case 16 * 4 + kBFloat: return CALL(16, kBFloat);               \
    case 32 * 4 + kSigned: return CALL(32, kSigned);               \
    case 32 * 4 + kUnsigned: return CALL(32, kUnsigned);           \
    case 32 * 4 + kFloat: return CALL(32, kFloat);                 \
    case 64 * 4 + kSigned: return CALL(64, kSigned);               \
    case 64 * 4 + kUnsigned: return CALL(64, kUnsigned);           \
    case 64 * 4 + kFloat: return CALL(64, kFloat);                 \
  }                                                                \
  return cudaErrorInvalidValue

}  // namespace

extern "C" {

const char* codec_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// G5 encode: keys (rows, n) of `bits` bits and `kind` (0 signed, 1
// unsigned, 2 IEEE float, 3 bfloat16) to codes (rows, n_pad), int32 for
// bits <= 32 and int64 for 64, the sentinel past n; `complement` writes ~code
// below n; `index` (rows, n_pad) int32 or null.  One launch.
int codec_encode(const void* keys, int bits, int kind, int rows, int n, int n_pad, int complement,
                 void* codes, void* index, void* stream) {
  if (rows < 0 || n < 0 || n_pad < n) return cudaErrorInvalidValue;
  if (rows == 0 || n_pad == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define ENCODE(B, K) launch_encode<B, K>(keys, rows, n, n_pad, complement, codes, index, s)
  CODEC_DISPATCH(ENCODE);
#undef ENCODE
}

// G5 decode: the first n codes of each row of codes (rows, stride) to keys
// (rows, n) of `bits` bits and `kind`; `complement` undoes encode's.  One
// launch.
int codec_decode(const void* codes, int bits, int kind, int rows, int n, int stride,
                 int complement, void* out, void* stream) {
  if (rows < 0 || n < 0 || stride < n) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define DECODE(B, K) launch_decode<B, K>(codes, rows, n, stride, complement, out, s)
  CODEC_DISPATCH(DECODE);
#undef DECODE
}

}  // extern "C"
