// K11 flash_attention: fused forward attention (causal and/or windowed),
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py), which only the reference's tests
// call.  Scores live and die in shared memory and registers: the HBM
// traffic is q, k, v read and the output written, and KV blocks that the
// mask empties (above the diagonal, below the window) are skipped, as the
// TPU kernel's `lo`/`hi` do.
//
// Bound: operations.  A causal (1, 32, 4096, 128) call needs ~6.9e10
// multiply-adds for QK^T and PV over the unmasked half; on the tensor cores
// (989 TFLOP/s bf16) that is ~0.14 ms, against ~0.13 ms for its 128 MiB of
// f32 bytes (~0.02 ms in bf16).
//
// Design.  One CTA of 256 threads per (b * h, block of BQ = 64 query rows),
// the longest causal blocks launched first.  The block's queries, scaled by
// 1/sqrt(hd), sit in shared memory as f32, transposed (hd x BQ); each KV
// block of BK = 64 rows is staged as f32, K transposed (hd x BK) and V as
// is (BK x hd).  Each thread owns a 4 x 4 tile of the scores (rows
// 4*ty.., columns 4*tx..) computed by outer products of float4 reads, the
// online softmax of its 4 rows (max and sum across the 16 threads of a row
// by shuffles, f32), and a 4 x hd/16 tile of the f32 accumulator (columns
// 4*tx + 64*c..), updated from the probabilities written transposed to
// shared memory.  Masked scores are -1e30 with a weight of exactly 0, and
// the output is acc / max(l, 1e-30), as in the TPU kernel.  The products
// run on the CUDA cores in f32 (no wgmma yet): right and simple first.
// Query head h reads KV head h / group, through strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 4;  // keeps the transposed rows 16-byte aligned
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max(float x) {  // over the 16 threads of a row
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
    int H, int S, int group, int causal, int window, float scale, T* __restrict__ out) {
  constexpr int NC = HD / 64;  // float4 column groups of the accumulator per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // HD x (BQ + PAD)
  float* kt = qt + HD * (BQ + PAD);                // HD x (BK + PAD)
  float* vs = kt + HD * (BK + PAD);                // BK x HD
  float* pt = vs + BK * HD;                        // BK x (BQ + PAD)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal blocks first
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    qt[d * (BQ + PAD) + i] = q0 + i < S ? to_f(qb[(q0 + i) * q_ss + d]) * scale : 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int nkv = (S + BK - 1) / BK;
  const int hi = causal ? min(nkv, q_last / BK + 1) : nkv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.f;
  }

  for (int kb_i = lo; kb_i < hi; ++kb_i) {
    const int k0 = kb_i * BK;
    __syncthreads();  // the previous block's readers are done (and qt is written)
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const bool in = k0 + j < S;
      kt[d * (BK + PAD) + j] = in ? to_f(kb[(k0 + j) * k_ss + d]) : 0.f;
      vs[j * HD + d] = in ? to_f(vb[(k0 + j) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * (BQ + PAD) + 4 * ty);
      const float4 bb = *reinterpret_cast<const float4*>(kt + d * (BK + PAD) + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + 4 * tx + c;
        valid[c] = j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
        s[r][c] = valid[c] ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = valid[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p[r][c];
      }
      sum = row_sum(sum);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[r][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (4 * tx + c) * (BQ + PAD) + 4 * ty) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(pt + j * (BQ + PAD) + 4 * ty);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int cg = 0; cg < NC; ++cg) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * HD + 64 * cg + 4 * tx);
        const float vvv[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][4 * cg + e] = fmaf(pv[r], vvv[e], acc[r][4 * cg + e]);
      }
    }
  }

  T* ob = out + ((long long)bh * S) * HD;  // out (B, H, S, HD) contiguous
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cg = 0; cg < NC; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(long long)i * HD + 64 * cg + 4 * tx + e] = from_f<T>(acc[r][4 * cg + e] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, int B, int H, int S, int group, int causal,
           int window, float scale, void* out, cudaStream_t stream) {
  const int smem = (HD * (BQ + PAD) + HD * (BK + PAD) + BK * HD + BK * (BQ + PAD)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (B * H == 0 || S == 0) return cudaSuccess;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, qs[0], qs[1], qs[2], (const T*)k, ks[0], ks[1], ks[2], (const T*)v, vs[0],
      vs[1], vs[2], H, S, group, causal, window, scale, (T*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32, 1 bfloat16; hd 64 or 128.  Strides (batch, head, seq)
// in elements, the head dim contiguous.  out is a contiguous (B, H, S, hd)
// tensor of the dtype.
int flash_attention_launch(const void* q, long long q_sb, long long q_sh, long long q_ss,
                           const void* k, long long k_sb, long long k_sh, long long k_ss,
                           const void* v, long long v_sb, long long v_sh, long long v_ss,
                           int B, int H, int S, int hd, int group, int causal, int window,
                           float scale, int dtype, void* out, void* stream) {
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) {
    if (dtype == 0)
      return launch<float, 64>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                               st);
    return launch<__nv_bfloat16, 64>(q, qs, k, ks, v, vs, B, H, S, group, causal, window,
                                     scale, out, st);
  }
  if (dtype == 0)
    return launch<float, 128>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                              st);
  return launch<__nv_bfloat16, 128>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale,
                                    out, st);
}

}  // extern "C"
