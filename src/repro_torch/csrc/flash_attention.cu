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
// In float32, split three ways on the TF32 tensor cores (below), it is
// three times those products at 495 TFLOP/s: ~0.83 ms.
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
// float32: 3xTF32 `wgmma` on the tensor cores.  The first design ran both
// products as f32 FMA on the CUDA cores (6.93 ms causal at (1, 32, 4096,
// 128) on an NVIDIA H100 80GB HBM3 at 700 W, 3.4x its FMA bound of 2.05 ms
// at 67 TFLOP/s, 2.1x SDPA's f32 kernel).  TF32 keeps 11
// significant bits, which alone misses the f32 check (2e-5 + 2e-5 |want|),
// so every operand x is split into big = x rounded to tf32 and small = (x -
// big) rounded to tf32, and each product a b is taken as a_s b_b + a_b b_s +
// a_b b_b (a_s b_s, ~2^-22 of |a b|, is dropped), the small terms first so
// that each partial sum is rounded at its own size.  One CTA of 256 threads
// (two warpgroups, no producer) per (b * h, block of BQ = 128 query rows),
// the longest causal blocks first:
//   - q is scaled by 1/sqrt(hd) in f32 (as the twin does), split, and
//     written once into two tf32 copies in shared memory (128-byte rows,
//     swizzled as TMA would lay them out, in boxes of 32 columns);
//   - the KV loop takes tiles of BK = 32 keys.  tf32 `wgmma` reads both
//     shared operands K-major only (no transpose), so V must sit transposed
//     (hd x keys), which TMA cannot write: the threads themselves load each
//     tile (16-byte loads, one key a lane, the tile after next in flight in
//     registers while the current one is multiplied), split it, and write K
//     as is and V transposed into their big and small copies (the V^T store
//     of a warp is one 128-byte row: conflict-free), then
//     `fence.proxy.async` and a barrier;
//   - S = q K^T by wgmma m64n32k8 from shared memory (3 x hd/8 per tile),
//     the mask and the online softmax in f32 registers in the log2 domain;
//     P split in registers into its two tf32 terms.  The f32 accumulator
//     holds columns (2c, 2c+1) of 8 where a tf32 A fragment holds (c, c+4),
//     so V^T's columns are stored in that order (key 2c at c, 2c+1 at c+4
//     of each 8) and S's registers serve as P's A fragments as they are;
//   - O += P V by wgmma m64nHDk8 with A from registers (3 x 4 per tile).
// Shared memory at hd = 128: q 2 x 64 KB, K and V^T 2 x 16 KB each, 192 KB
// (one CTA an SM; hd = 64 half of it, two CTAs).  BK = 32 is what fits:
// BK = 64 would need 256 KB.  Measured (chip_smoke.py, the same card): ~2.2
// ms causal, 0.67x SDPA's f32 kernel and 2.6x the 3xTF32 bound, with
// max |got - want| ~7e-6 against the f32 twin.  What is left: the S
// products read both operands from shared memory at N = 32 keys, and with
// one tile in shared memory the staging and the softmax do not overlap the
// products (239 registers a thread, one CTA an SM).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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

// ---- float32: 3xTF32 on the tensor cores ---------------------------------

namespace tf32 {

using tc::smem_desc;
using tc::smem_u32;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;

constexpr int BQ = 128;         // query rows per CTA: two warpgroups of 64
constexpr int BK = 32;          // keys per tile: one 128-byte row of V^T
constexpr int kThreads = 256;   // the two warpgroups; they also stage the tiles
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// byte offsets of the split copies in shared memory, each of 128-byte rows
// in boxes of 32 f32 columns, 128-byte swizzled (1024-byte atoms)
template <int HD>
struct Smem {
  static constexpr int NT = HD / 32;       // column boxes of a row of q or K
  static constexpr int kQBox = BQ * 128;   // 128 query rows x 32 columns
  static constexpr int kKBox = BK * 128;   // 32 keys x 32 columns
  static constexpr int kQ = NT * kQBox, kK = NT * kKBox;
  static constexpr int kV = HD * 128;      // V^T: HD rows x 32 keys
  static constexpr int q_big = 0, q_small = kQ, k_big = 2 * kQ, k_small = k_big + kK,
                       v_big = k_small + kK, v_small = v_big + kV, bytes = v_small + kV;
};

// byte offset of f32 column col of row row in a box of 128-byte rows, as
// TMA's 128-byte swizzle lays it out (16-byte chunk ^= row % 8)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  const uint32_t off = row * 128 + col * 4;
  return off ^ ((off >> 3) & 0x70);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to ~2^-22 of |x|: big = x rounded to tf32, small = the
// rest rounded to tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
  split(x.x, big.x, small.x);
  split(x.y, big.y, small.y);
  split(x.z, big.z, small.z);
  split(x.w, big.w, small.w);
}

// D (64 x 32, f32) (+)= A (64 x 8) B (8 x 32), tf32, both from shared
// memory, K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 8, tf32 registers) B (8 x N, shared, K-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// this thread's part of a KV tile (keys k0 .. k0 + 31, rows past S as 0):
// key k0 + lane, float4 columns warp * NCW .. + NCW - 1 of K and of V
template <int NCW>
__device__ __forceinline__ void fetch(const float* kb, long long k_ss, const float* vb,
                                      long long v_ss, int key, int S, int c0, float4* kr,
                                      float4* vr) {
#pragma unroll
  for (int c = 0; c < NCW; ++c) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    kr[c] = key < S ? *reinterpret_cast<const float4*>(kb + key * k_ss + 4 * (c0 + c)) : zero;
    vr[c] = key < S ? *reinterpret_cast<const float4*>(vb + key * v_ss + 4 * (c0 + c)) : zero;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1) attention_kernel(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const float* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
    const float* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
    int H, int S, int group, int causal, int window, float scale, float* __restrict__ out) {
  using L = Smem<HD>;
  constexpr int NO = HD / 2;   // f32 accumulator registers of O per thread
  constexpr int C4 = HD / 4;   // float4 columns of a row
  constexpr int NCW = C4 / 8;  // float4 columns of a tile row per warp
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* sm = smem_raw + (base - raw);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal blocks first
  const int q_last = min(q0 + BQ, S) - 1;
  const int nkv = (S + BK - 1) / BK;
  const int hi = causal ? min(nkv, q_last / BK + 1) : nkv;
  const int lo = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;
  const int tid = threadIdx.x, lane = tid % 32, c0 = (tid / 32) * NCW;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  // q * scale, split into its two tf32 copies (rows past S as 0)
  for (int idx = tid; idx < BQ * C4; idx += kThreads) {
    const int i = idx / C4, c4 = idx % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + i < S) x = *reinterpret_cast<const float4*>(qb + (q0 + i) * q_ss + 4 * c4);
    uint4 big, small;
    split4(make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale), big, small);
    const uint32_t off = (c4 / 8) * L::kQBox + swz(i, 4 * (c4 % 8));
    *reinterpret_cast<uint4*>(sm + L::q_big + off) = big;
    *reinterpret_cast<uint4*>(sm + L::q_small + off) = small;
  }

  // a consumer warpgroup: query rows q0 + 64 * wg .. + 63
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col_l = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  // key lane's column in V^T: within each group of 8 keys, key 2c at c and
  // 2c + 1 at c + 4, which is where the tf32 A fragment of P holds them
  const int v_col = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  float4 kr[NCW], vr[NCW];
  if (lo < hi) fetch<NCW>(kb, k_ss, vb, v_ss, lo * BK + lane, S, c0, kr, vr);

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // both warpgroups are done with the previous tile
    // stage the fetched tile: K split as is (keys x hd), V split transposed
#pragma unroll
    for (int c = 0; c < NCW; ++c) {
      const int c4 = c0 + c;
      uint4 big, small;
      split4(kr[c], big, small);
      const uint32_t off = (c4 / 8) * L::kKBox + swz(lane, 4 * (c4 % 8));
      *reinterpret_cast<uint4*>(sm + L::k_big + off) = big;
      *reinterpret_cast<uint4*>(sm + L::k_small + off) = small;
      const float vv[4] = {vr[c].x, vr[c].y, vr[c].z, vr[c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t vbig, vsmall;
        split(vv[e], vbig, vsmall);
        const uint32_t voff = swz(4 * c4 + e, v_col);
        *reinterpret_cast<uint32_t*>(sm + L::v_big + voff) = vbig;
        *reinterpret_cast<uint32_t*>(sm + L::v_small + voff) = vsmall;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    if (t + 1 < hi) fetch<NCW>(kb, k_ss, vb, v_ss, k0 + BK + lane, S, c0, kr, vr);
    // a tile that masks every row of this warpgroup (or rows all past S)
    if (wg_first >= S || (causal && k0 > wg_last) ||
        (window > 0 && k0 + BK - 1 <= wg_first - window))
      continue;

    // S = q K^T: the two small terms first, then big x big, so each sum is
    // rounded relative to its own size
    float s[16];
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const int qa = term == 1 ? L::q_small : L::q_big;
      const int kbo = term == 0 ? L::k_small : L::k_big;
#pragma unroll
      for (int step = 0; step < HD / 8; ++step) {  // 8 columns of hd per step
        const uint32_t col = (step % 4) * 32;
        wgmma_ss_n32(s, smem_desc(base + qa + (step / 4) * L::kQBox + 64 * 128 * wg + col, 16, 1024),
                     smem_desc(base + kbo + (step / 4) * L::kKBox + col, 16, 1024),
                     term > 0 || step > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();

    // mask, into the log2 domain, and the row maxima
    const bool edge = (causal && k0 + BK - 1 > wg_first) ||
                      (window > 0 && k0 <= wg_last - window) || k0 + BK > S;
    float mx[2] = {kNegInit, kNegInit};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * kLog2e;
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
    // P = exp2(s - m) as tf32 A fragments of 8 keys each, in two terms:
    // registers (row0, 2c), (row0 + 8, 2c), (row0, 2c + 1), (row0 + 8, 2c + 1)
    // hold the fragment's columns c, c, c + 4, c + 4 (V^T's column order)
    uint32_t p_big[BK / 2], p_small[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(s[4 * j] - m[0]), p1 = exp2f(s[4 * j + 1] - m[0]);
      const float p2 = exp2f(s[4 * j + 2] - m[1]), p3 = exp2f(s[4 * j + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      split(p0, p_big[4 * j], p_small[4 * j]);
      split(p2, p_big[4 * j + 1], p_small[4 * j + 1]);
      split(p1, p_big[4 * j + 2], p_small[4 * j + 2]);
      split(p3, p_big[4 * j + 3], p_small[4 * j + 3]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= corr[(j >> 1) & 1];

    // O += P V: the two small terms, then big x big
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // 8 keys per step
      const uint64_t dvb = smem_desc(base + L::v_big + kk * 32, 16, 1024);
      const uint64_t dvs = smem_desc(base + L::v_small + kk * 32, 16, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128(o, p_small + 4 * kk, dvb);
        wgmma_rs_n128(o, p_big + 4 * kk, dvs);
        wgmma_rs_n128(o, p_big + 4 * kk, dvb);
      } else {
        wgmma_rs_n64(o, p_small + 4 * kk, dvb);
        wgmma_rs_n64(o, p_big + 4 * kk, dvs);
        wgmma_rs_n64(o, p_big + 4 * kk, dvb);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
  }

  // O / l, the row sums gathered across the four lanes of a row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  float* ob = out + (long long)bh * S * HD;  // out (B, H, S, HD) contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(ob + (long long)row * HD + 8 * j + col_l) =
          make_float2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
}

template <int HD>
int smem_bytes() {
  return Smem<HD>::bytes + 1024;  // and the alignment of the atoms
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, int B, int H, int S, int group, int causal,
           int window, float scale, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  if (err != cudaSuccess) return err;
  if (B * H == 0 || S == 0) return cudaSuccess;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  attention_kernel<HD><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      (const float*)q, qs[0], qs[1], qs[2], (const float*)k, ks[0], ks[1], ks[2],
      (const float*)v, vs[0], vs[1], vs[2], H, S, group, causal, window, scale, (float*)out);
  return cudaGetLastError();
}

template <int HD>
int info(int B, int H, int S, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, attention_kernel<HD>)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], attention_kernel<HD>,
                                                           kThreads, smem_bytes<HD>())) !=
      cudaSuccess)
    return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem_bytes<HD>();
  out[3] = kThreads;
  out[5] = (int)a.localSizeBytes;
  out[6] = B * H * ((S + BQ - 1) / BQ);
  return cudaSuccess;
}

}  // namespace tf32

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32 (3xTF32 wgmma), 1 bfloat16 (wgmma); hd 64 or 128.
// Strides (batch, head, seq) in elements, the head dim contiguous; the
// pointers and strides are 16-byte aligned (TMA for bfloat16, 16-byte loads
// for float32).  out is a contiguous (B, H, S, hd) tensor of the dtype.
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
    return tf32::launch<64>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                            st);
  return tf32::launch<128>(q, qs, k, ks, v, vs, B, H, S, group, causal, window, scale, out,
                           st);
}

// The float32 kernel's launch for (B, H, S, hd): out[0] registers per
// thread, out[1] static and out[2] dynamic shared memory per CTA in bytes,
// out[3] threads per CTA, out[4] CTAs an SM holds at once, out[5] local
// memory per thread (spills) in bytes, out[6] CTAs of the grid.
int flash_attention_f32_info(int B, int H, int S, int hd, int* out) {
  if (hd == 64) return tf32::info<64>(B, H, S, out);
  return tf32::info<128>(B, H, S, out);
}

}  // extern "C"
