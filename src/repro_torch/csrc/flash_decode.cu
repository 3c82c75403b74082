// K10 flash_decode: attention of one new token per request over its KV
// cache, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_decode.py), which the reference's decode step
// calls under `ComputePolicy.flash_decode` (src/repro/models/attention.py).
// The TPU kernel takes the cache group-expanded and transposed to
// (B, H, T, hd), a copy of group x the cache per layer per step; this one
// reads the cache where it lies, through strides, with query head h reading
// KV head h / group.
//
// Bound: bytes.  Per (request, KV head) it must read the valid prefix of K
// and V once (2 * length * hd elements) and the group's queries, and write
// the group's outputs; the operations (4 * group * length * hd flops) are
// far below the card's rate at any group size the configs use.
//
// Design.  One CTA of 512 threads per (request b, KV head): it loads each
// tile of BT cache rows of K and V once into shared memory (16-byte loads;
// K rows padded to an odd number of words so that the score pass, one row
// per thread, is free of bank conflicts) and uses it for all `group` query
// heads.  Per tile: every thread scores (head, row) pairs against the
// pre-scaled f32 queries in shared memory; one warp per head takes the
// tile's max, the exponentials and their sum (the online softmax's m, l and
// correction, in f32); then every thread updates its (head, dim) outputs,
// accumulated in f32 registers.  Only the tiles below `length` are read.
// The edges are the TPU kernel's: rows at or past `length` get -1e30 and a
// weight of exactly 0, and a request with length 0 gets acc / max(l, 1e-30)
// = 0.  Right and simple first: one CTA per (b, KV head) gives B * KVH CTAs
// (32 at B = 8 for yi-9b), and no split of T across CTAs yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 8;  // group * hd <= kThreads * kMaxAcc
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q . k over hd, q in f32, k a padded shared-memory row
__device__ __forceinline__ float dot_row(const float* q, const float* k, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(q[d], k[d], s);
  return s;
}
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k, int hd) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  float s = 0.f;
  for (int c = 0; c < hd / 2; ++c) {
    const float2 kf = __bfloat1622float2(k2[c]);
    s = fmaf(q[2 * c], kf.x, s);
    s = fmaf(q[2 * c + 1], kf.y, s);
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows of BT * sizeof(T) = 128 bytes of one column: 64 bf16 or 32 f32 rows
template <typename T> struct Tile {
  static constexpr int kRows = 128 / sizeof(T);
  static constexpr int kVec = 16 / sizeof(T);            // elements per 16-byte load
  static constexpr int kPad = 4 / sizeof(T) > 0 ? 4 / sizeof(T) : 1;  // one word
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const T* __restrict__ k, long long k_sb, long long k_st, long long k_sh,
    const T* __restrict__ v, long long v_sb, long long v_st, long long v_sh,
    const int* __restrict__ length, int T_, int kvh, int group, int hd, float scale,
    T* __restrict__ out) {
  constexpr int BT = Tile<T>::kRows;
  constexpr int VEC = Tile<T>::kVec;
  const int kstride = hd + Tile<T>::kPad;  // an odd number of 4-byte words
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);                       // BT x hd
  T* ks = vs + BT * hd;                                          // BT x kstride
  float* qs = reinterpret_cast<float*>(ks + BT * kstride);       // group x hd
  float* ps = qs + group * hd;                                   // group x BT
  float* m_s = ps + group * BT;
  float* l_s = m_s + group;
  float* c_s = l_s + group;

  const int b = blockIdx.x / kvh;
  const int hk = blockIdx.x % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gh = group * hd;
  int len = length[b];
  len = len < 0 ? 0 : (len > T_ ? T_ : len);

  for (int o = tid; o < gh; o += kThreads) {
    const int g = o / hd, d = o % hd;
    qs[o] = to_f(q[b * q_sb + (long long)(hk * group + g) * q_sh + d]) * scale;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int chunks = hd / VEC;  // 16-byte chunks per row
  for (int t0 = 0; t0 < len; t0 += BT) {
    const int n = min(BT, len - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < n * chunks; c += kThreads) {
      const int j = c / chunks, part = c % chunks;
      const uint4 kv4 = *reinterpret_cast<const uint4*>(kb + (t0 + j) * k_st + part * VEC);
      const uint4 vv4 = *reinterpret_cast<const uint4*>(vb + (t0 + j) * v_st + part * VEC);
      uint32_t* kw = reinterpret_cast<uint32_t*>(ks + j * kstride + part * VEC);
      kw[0] = kv4.x;
      kw[1] = kv4.y;
      kw[2] = kv4.z;
      kw[3] = kv4.w;
      *reinterpret_cast<uint4*>(vs + j * hd + part * VEC) = vv4;
    }
    __syncthreads();
    for (int p = tid; p < group * BT; p += kThreads) {
      const int g = p / BT, j = p % BT;
      ps[p] = j < n ? dot_row(qs + g * hd, ks + j * kstride, hd) : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* row = ps + g * BT;
      float mx = kNegInf;
      for (int j = lane; j < BT; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BT; j += 32) {
        const float p = j < n ? expf(row[j] - m_new) : 0.f;
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int o = tid + i * kThreads;
      if (o < gh) {
        const int g = o / hd, d = o % hd;
        const float* prow = ps + g * BT;
        float a = acc[i] * c_s[g];
        for (int j = 0; j < n; ++j) a = fmaf(prow[j], to_f(vs[j * hd + d]), a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * kvh + hk) * gh;  // out (B, H, hd), H = kvh * group
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int o = tid + i * kThreads;
    if (o < gh) ob[o] = from_f<T>(acc[i] / fmaxf(l_s[o / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, long long q_sb, long long q_sh, const void* k, long long k_sb,
           long long k_st, long long k_sh, const void* v, long long v_sb, long long v_st,
           long long v_sh, const void* length, int B, int T_, int kvh, int group, int hd,
           float scale, void* out, cudaStream_t stream) {
  constexpr int BT = Tile<T>::kRows;
  const int kstride = hd + Tile<T>::kPad;
  const int smem = (BT * hd + BT * kstride) * (int)sizeof(T) +
                   (group * hd + group * BT + 3 * group) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (B * kvh == 0) return cudaSuccess;
  flash_decode_kernel<T><<<B * kvh, kThreads, smem, stream>>>(
      (const T*)q, q_sb, q_sh, (const T*)k, k_sb, k_st, k_sh, (const T*)v, v_sb, v_st, v_sh,
      (const int*)length, T_, kvh, group, hd, scale, (T*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32, 1 bfloat16.  Strides in elements; the head dim is
// contiguous.  out is a contiguous (B, kvh * group, hd) tensor of the dtype.
int flash_decode_launch(const void* q, long long q_sb, long long q_sh, const void* k,
                        long long k_sb, long long k_st, long long k_sh, const void* v,
                        long long v_sb, long long v_st, long long v_sh, const void* length,
                        int B, int T, int kvh, int group, int hd, float scale, int dtype,
                        void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, q_sb, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, length, B,
                         T, kvh, group, hd, scale, out, s);
  return launch<__nv_bfloat16>(q, q_sb, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh,
                               length, B, T, kvh, group, hd, scale, out, s);
}

}  // extern "C"
