// K11 flash_attention: fused forward attention (causal and/or windowed),
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:102), which only the reference's
// tests call.  Scores live and die in shared memory and registers: the HBM
// traffic is q, k, v read and the output written, and KV blocks that the
// mask empties (above the diagonal, below the window) are skipped, as the
// TPU kernel's `lo`/`hi` do.  Query row i attends key j iff (not causal or
// j <= i) and (no window or j > i - window); masked scores get a weight of
// exactly 0 and the output is acc / max(l, 1e-30), as in the TPU kernel.
// Query head h reads KV head h / group (GQA), through strides.
//
// Bound: operations.  A causal (1, 32, 4096, 128) call needs ~6.9e10
// multiply-adds for QK^T and PV over the unmasked half: ~0.14 ms on the
// tensor cores (989 TFLOP/s bf16), against ~0.02 ms for its bf16 bytes.
//
// bfloat16: `wgmma` on the tensor cores.  The first design ran both
// products on the CUDA cores in f32 FMA, with q, k and v staged in shared
// memory as f32: 6.6 ms, 48x the bound, 2% of the bf16 tensor-core rate.
// Now one CTA of 288 threads per (b * h, block of BQ = 128 query rows), the
// longest causal blocks launched first:
//   - a producer warp (one elected thread) loads the block's q once and a
//     2-stage ring of K and V tiles of BK = 128 rows with TMA
//     (cp.async.bulk.tensor, 4-D tensor maps over (hd, S, heads, B) that
//     carry the callers' strides; 128-byte swizzle; rows past S read as
//     zeros), each stage on its own full mbarrier, freed by an empty one;
//   - two consumer warpgroups of 64 query rows each: S = q K^T by
//     wgmma m64n128k16 with both operands in shared memory (K-major), S in
//     f32 registers, scaled by 1/sqrt(hd) there (the products of raw bf16
//     values are exact in f32, so scaling S equals scaling q first up to
//     f32 rounding); the online softmax in registers in f32, in the log2
//     domain (row max and sum across the four lanes that hold a row); P
//     split in registers into two bf16 terms, hi = P rounded and lo = P - hi
//     rounded (S's accumulator layout is wgmma's A fragment layout pair for
//     pair), and O += lo V + hi V by two wgmma with A from registers and V
//     from shared memory read MN-major (transposed B); O in f32 registers,
//     then O / l written as bf16.
// P rounded once to bf16, the usual flash-attention rounding (8 significant
// bits), broke the bf16 check (4e-3 + 2^-8 |want|): rows with few keys have
// outputs of 2-4 built from weights near 1, and a weight off by its
// rounding moved such an output by a whole bf16 step, which that check does
// not allow below |want| = 3.  TF32 for P V (P in f32) would need V as
// 32-bit words in shared memory; the two bf16 terms keep V's bf16 tile, give
// P 16 significant bits (TF32: 11), and cost one more wgmma per k-step of
// P V.
//
// float32: FMA on the CUDA cores, as first written.  TF32 products would
// keep ~10 bits of each operand and miss the float32 check (2e-5).  One CTA
// of 256 threads per (b * h, BQ = 64 query rows); the block's queries,
// scaled by 1/sqrt(hd), sit in shared memory as f32, transposed (hd x BQ);
// each KV block of BK = 64 rows is staged K transposed (hd x BK) and V as
// is (BK x hd).  Each thread owns a 4 x 4 tile of the scores (rows
// 4*ty.., columns 4*tx..) computed by outer products of float4 reads, the
// online softmax of its 4 rows (max and sum across the 16 threads of a row
// by shuffles, f32), and a 4 x hd/16 tile of the f32 accumulator (columns
// 4*tx + 64*c..), updated from the probabilities written transposed to
// shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---- float32: FMA on the CUDA cores --------------------------------------

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 4;  // keeps the transposed rows 16-byte aligned
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float row_max(float x) {  // over the 16 threads of a row
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const float* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
    const float* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
    int H, int S, int group, int causal, int window, float scale, float* __restrict__ out) {
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;
  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    qt[d * (BQ + PAD) + i] = q0 + i < S ? qb[(q0 + i) * q_ss + d] * scale : 0.f;
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
      kt[d * (BK + PAD) + j] = in ? kb[(k0 + j) * k_ss + d] : 0.f;
      vs[j * HD + d] = in ? vb[(k0 + j) * v_ss + d] : 0.f;
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

  float* ob = out + ((long long)bh * S) * HD;  // out (B, H, S, HD) contiguous
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cg = 0; cg < NC; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(long long)i * HD + 64 * cg + 4 * tx + e] = acc[r][4 * cg + e] * inv;
  }
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, int B, int H, int S, int group, int causal,
           int window, float scale, void* out, cudaStream_t stream) {
  const int smem = (HD * (BQ + PAD) + HD * (BK + PAD) + BK * HD + BK * (BQ + PAD)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (B * H == 0 || S == 0) return cudaSuccess;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, qs[0], qs[1], qs[2], (const float*)k, ks[0], ks[1], ks[2],
      (const float*)v, vs[0], vs[1], vs[2], H, S, group, causal, window, scale, (float*)out);
  return cudaGetLastError();
}

// ---- bfloat16: wgmma on the tensor cores ---------------------------------

namespace tc {

constexpr int BQ = 128;               // query rows per CTA: two warpgroups of 64
constexpr int BK = 128;               // keys per KV tile
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = 128 * 128;      // 128 rows x 64 bf16 columns (128 B)
constexpr float kNegInit = -1e30f;    // the running max before any key

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 columns x 128 rows) box of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int head, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 B); lbo/sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N), bf16.  _ss: A and B from
// shared memory, K-major; _rs: A from registers, B from shared memory
// MN-major (trans-b).  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128_tb(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) attention_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, int H, int S, int group, int causal, int window,
    float scale_log2, __nv_bfloat16* __restrict__ out) {
  constexpr int NT = HD / 64;        // 64-column tiles of a row of q, K or V
  constexpr int NO = HD / 2;         // f32 accumulator registers of O per thread
  constexpr int NS = BK / 2;         // f32 registers of S per thread
  constexpr int kTileSet = NT * kTileBytes;  // q, or one stage of K or of V
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[7];  // q full; K full x2; V full x2; empty x2

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t sq = base;
  const uint32_t sk = sq + kTileSet;      // + stage * kTileSet
  const uint32_t sv = sk + 2 * kTileSet;  // + stage * kTileSet
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);  // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[3]);
  const uint32_t bar_e = smem_u32(&bars[5]);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal blocks first
  const int q_last = min(q0 + BQ, S) - 1;
  const int nkv = (S + BK - 1) / BK;
  const int hi = causal ? min(nkv, q_last / BK + 1) : nkv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warp ----
    if (tid != kConsumers) return;
    mbar_expect_tx(bar_q, kTileSet);
    for (int c = 0; c < NT; ++c) tma_load(sq + c * kTileBytes, &q_map, 64 * c, q0, h, b, bar_q);
    for (int i = 0; i < hi - lo; ++i) {
      const int st = i & 1;
      if (i >= 2) mbar_wait(bar_e + 8 * st, ((i >> 1) - 1) & 1);  // stage st released
      const int k0 = (lo + i) * BK;
      mbar_expect_tx(bar_k + 8 * st, kTileSet);
      for (int c = 0; c < NT; ++c)
        tma_load(sk + st * kTileSet + c * kTileBytes, &k_map, 64 * c, k0, hk, b, bar_k + 8 * st);
      mbar_expect_tx(bar_v + 8 * st, kTileSet);
      for (int c = 0; c < NT; ++c)
        tma_load(sv + st * kTileSet + c * kTileBytes, &v_map, 64 * c, k0, hk, b, bar_v + 8 * st);
    }
    return;
  }

  // ---- a consumer warpgroup: query rows q0 + 64 * wg .. + 63 ----
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col_l = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int i = 0; i < hi - lo; ++i) {
    const int st = i & 1, parity = (i >> 1) & 1;
    const int k0 = (lo + i) * BK;
    float s[NS];
    mbar_wait(bar_k + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int step = 0; step < HD / 16; ++step) {  // 16 columns of hd per step
      const uint32_t off = (step / 4) * kTileBytes + (step % 4) * 32;
      wgmma_ss_n128(s, smem_desc(sq + 64 * 128 * wg + off, 16, 1024),
                    smem_desc(sk + st * kTileSet + off, 16, 1024), step > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // mask, scale into the log2 domain, and the row maxima
    const bool edge = (causal && k0 + BK - 1 > wg_first) ||
                      (window > 0 && k0 <= wg_last - window) || k0 + BK > S;
    float mx[2] = {kNegInit, kNegInit};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int row = row0 + 8 * (e >> 1), col = k0 + 8 * j + col_l + (e & 1);
          const bool ok = col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
          x = ok ? x : -INFINITY;  // a weight of exactly 0
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P = exp2(s - m), summed per thread, as wgmma's A fragments in two
    // bf16 terms, P = hi + lo (hi = P rounded, lo = the rest rounded): k-step
    // kk's four registers are pairs 8kk .. 8kk + 7 of s
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int r = j & 1;  // pairs alternate between row0 and row0 + 8
      const float p0 = exp2f(s[2 * j] - m[r]), p1 = exp2f(s[2 * j + 1] - m[r]);
      l[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      p_hi[j] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[j] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= corr[(j >> 1) & 1];

    mbar_wait(bar_v + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys per step
      const uint64_t dv = smem_desc(sv + st * kTileSet + kk * 16 * 128, kTileBytes, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128_tb(o, p_lo + 4 * kk, dv, 1);
        wgmma_rs_n128_tb(o, p_hi + 4 * kk, dv, 1);
      } else {
        wgmma_rs_n64_tb(o, p_lo + 4 * kk, dv, 1);
        wgmma_rs_n64_tb(o, p_hi + 4 * kk, dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e + 8 * st);  // this warp is done with stage st
  }

  // O / l, the row sums gathered across the four lanes of a row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + (long long)bh * S * HD;  // out (B, H, S, HD) contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * HD + 8 * j + col_l) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found through the runtime's entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over (hd, S, heads, B) of bf16 with strides (in elements) for
// seq, head and batch, read in boxes of 64 columns x 128 rows
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B,
              const long long* strides) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2, (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, int B, int H, int KVH, int S, int causal,
           int window, float scale, void* out, cudaStream_t stream) {
  const int smem = 5 * (HD / 64) * kTileBytes + 1024;  // q, two stages of K and V, alignment
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (B * H == 0 || S == 0) return cudaSuccess;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, HD, S, H, B, qs) || !make_map(&k_map, k, HD, S, KVH, B, ks) ||
      !make_map(&v_map, v, HD, S, KVH, B, vs))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, H, S, H / KVH, causal, window, scale * 1.4426950408889634f,
      (__nv_bfloat16*)out);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32 (FMA), 1 bfloat16 (wgmma); hd 64 or 128.  Strides
// (batch, head, seq) in elements, the head dim contiguous; for bfloat16 the
// pointers and strides are 16-byte aligned (TMA).  out is a contiguous
// (B, H, S, hd) tensor of the dtype.
int flash_attention_launch(const void* q, long long q_sb, long long q_sh, long long q_ss,
                           const void* k, long long k_sb, long long k_sh, long long k_ss,
                           const void* v, long long v_sb, long long v_sh, long long v_ss,
                           int B, int H, int S, int hd, int group, int causal, int window,
                           float scale, int dtype, void* out, void* stream) {
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    const int kvh = H / group;
    if (hd == 64)
      return tc::launch<64>(q, qs, k, ks, v, vs, B, H, kvh, S, causal, window, scale, out, st);
    return tc::launch<128>(q, qs, k, ks, v, vs, B, H, kvh, S, causal, window, scale, out, st);
  }
  if (hd == 64)
    return launch<64>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                             st);
  return launch<128>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                            st);
}

}  // extern "C"
