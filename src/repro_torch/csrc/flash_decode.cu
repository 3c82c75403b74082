// K10 flash_decode: attention of one new token per request over its KV
// cache, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_decode.py:70), which the reference's decode step
// calls under `ComputePolicy.flash_decode` (src/repro/models/attention.py).
// The TPU kernel takes the cache group-expanded and transposed to
// (B, H, T, hd), a copy of group x the cache per layer per step; this one
// reads the cache where it lies, through strides, with query head h reading
// KV head h / group.
//
// Bound: bytes.  Per (request, KV head) it must read the valid prefix of K
// and V once (2 * length * hd elements) and the group's queries, and write
// the group's outputs; the operations (4 * group * length * hd flops) are
// far below the card's rate at any group size the configs use.  At yi-9b's
// decode shape (B = 8, KVH = 4, length 1056, bf16) that is 17.3 MB, 5.2 us
// at 3.35 TB/s: so little that the kernel is bound by latency (how many
// bytes are in flight, how long each tile's math waits on the last), not
// by the rate.
//
// Design: split-KV across a thread-block cluster, in one launch.
//   - Each (request b, KV head) gets a cluster of S CTAs (S = 8, or the
//     non-portable 16 when B * KVH * 8 CTAs would leave most SMs idle and a
//     cluster of 16 fits).  Rank r takes a contiguous share of the valid
//     prefix, computed on the device from length[b] in units of 16 rows:
//     the host never reads `length`.
//   - bf16, group <= 16, hd in {16, 32, 64, 128} (every config): a CTA of
//     4 warps, each warp owning every 4th 16-row piece of the share, with
//     its own 2-stage ring of K and V pieces filled by 16-byte `cp.async`
//     (piece i + 1 in flight while piece i is used), so no block barrier
//     sits in the loop.  Per piece, on the tensor cores (`mma.sync`
//     m16n8k16, the group's heads as M, padded to 16): S = Q K^T with K read
//     by `ldmatrix`, the online softmax on S's fragments in registers (a
//     row's max and sum across the 4 lanes that hold it, m, l and acc in
//     f32), then O += P V with P taken from S's fragments as the A operand
//     (FlashAttention-2's register reuse) as two bf16 terms, hi + lo, 16
//     significant bits as K11 does, and V read by `ldmatrix.trans`.  K and V
//     rows are stored with their 16-byte chunks rotated by the row index, so
//     `ldmatrix` is free of bank conflicts without padding, which `cp.async`
//     could not write.  At the end the 4 warps' partials merge through
//     shared memory into the CTA's.
//   - Otherwise (f32, and bf16 at other shapes): a CTA of 256 threads walks
//     its share in tiles of 32 bf16 or 16 f32 rows through a 4-stage
//     `cp.async` ring; per tile every thread scores (head, row) pairs with
//     FMAs against the pre-scaled f32 queries, one warp per head updates
//     m, l and the correction, and every thread its (head, dim) outputs in
//     f32 registers; three block barriers a tile.  K rows are rotated as
//     above for the score pass.  f32 stays on the CUDA cores so that the f32
//     limit holds.
//   - The CTA's partial (m, l, acc[group * hd]) stays in its shared memory.
//     After `cluster.sync()` rank r finalises its slice of the group * hd
//     outputs, reading every rank's m, l and acc for it through distributed
//     shared memory, all reads of one output unrolled so that they are in
//     flight together: out = sum acc_q e^(m_q - M) / max(sum l_q e^(m_q -
//     M), 1e-30), M = max m_q.  A second `cluster.sync()` keeps the peers'
//     shared memory alive until every read is done.  No workspace, no
//     memset, no second launch.
// The edges are the TPU kernel's: rows at or past `length` are never read
// (a short piece's missing rows score -1e30 with a weight of exactly 0, and
// their V rows are zero in shared memory), a share with no valid rows
// contributes m = -1e30 and l = 0 (weight 0 beside any non-empty share),
// and length 0 gives 0 / max(0, 1e-30) = 0.  Lengths are clamped to [0, T].
// Only the order of summation differs from one CTA walking the whole
// prefix.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnit = 16;  // rows: the grain of the split across the cluster
constexpr int kPortableSplits = 8;
constexpr int kWideSplits = 16;
constexpr float kNegInf = -1e30f;
// the FMA kernel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;  // group * hd <= kThreads * kMaxAcc
constexpr int kStages = 4;   // tiles in the CTA's cp.async ring
// the tensor-core kernel
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPiece = 16;      // rows a warp takes at a time
constexpr int kMmaStages = 2;   // pieces in each warp's ring
constexpr int kMmaMaxGroup = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// s + q[0..VEC) . the 16 bytes k (VEC elements of T)
__device__ __forceinline__ float dot_chunk(const float* q, uint4 k, float s, float) {
  const float4 q4 = *reinterpret_cast<const float4*>(q);
  s = fmaf(q4.x, __uint_as_float(k.x), s);
  s = fmaf(q4.y, __uint_as_float(k.y), s);
  s = fmaf(q4.z, __uint_as_float(k.z), s);
  return fmaf(q4.w, __uint_as_float(k.w), s);
}
__device__ __forceinline__ float dot_chunk(const float* q, uint4 k, float s, __nv_bfloat16) {
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  const uint32_t w[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    s = fmaf(qv[2 * i], f.x, s);
    s = fmaf(qv[2 * i + 1], f.y, s);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// c += a b, m16n8k16, bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}
// two f32 weights as two bf16 pairs, hi + lo (16 significant bits)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x - hf.x, y - hf.y);
}

// rank's share [start, end) of a valid prefix of len rows, in units of kUnit
__device__ __forceinline__ void share_of(int len, int rank, int splits, int* start, int* end) {
  const int units = (len + kUnit - 1) / kUnit;
  *start = min(len, rank * units / splits * kUnit);
  *end = min(len, (rank + 1) * units / splits * kUnit);
}

// the cluster's combine of every CTA's partial (m_s, l_s, acc_s in its
// shared memory) into this rank's slice of the (group, hd) outputs at ob
template <typename T>
__device__ void combine(const float* m_s, const float* l_s, const float* acc_s, int group,
                        int hd, T* __restrict__ ob) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every rank's partial is in its shared memory
  const int gh = group * hd;
  const int per = (gh + splits - 1) / splits;
  for (int o = rank * per + threadIdx.x; o < min(gh, (rank + 1) * per); o += blockDim.x) {
    const int g = o / hd;
    float m[kWideSplits], l[kWideSplits], a[kWideSplits];
#pragma unroll
    for (int r = 0; r < kWideSplits; ++r) {
      m[r] = r < splits ? cluster.map_shared_rank(m_s, r)[g] : kNegInf;
      l[r] = r < splits ? cluster.map_shared_rank(l_s, r)[g] : 0.f;
      a[r] = r < splits ? cluster.map_shared_rank(acc_s, r)[o] : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kWideSplits; ++r) mx = fmaxf(mx, m[r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int r = 0; r < kWideSplits; ++r) {
      if (r < splits) {
        const float w = expf(m[r] - mx);
        lsum = fmaf(l[r], w, lsum);
        asum = fmaf(a[r], w, asum);
      }
    }
    ob[o] = from_f<T>(asum / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();  // the peers' shared memory stays until every read is done
}

// ---- the FMA kernel: f32, and bf16 at shapes the tensor-core one does not take

// a tile is 64 bytes of one column: 32 bf16 or 16 f32 rows
template <typename T> struct Tile {
  static constexpr int kRows = 64 / sizeof(T);
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
};

// dynamic shared memory, in bytes: the ring, the scaled f32 queries, the
// partial outputs, the scores, m, l and the correction
template <typename T> int fma_smem_bytes(int group, int hd) {
  constexpr int BT = Tile<T>::kRows;
  return kStages * 2 * BT * hd * (int)sizeof(T) +
         (2 * group * hd + group * BT + 3 * group) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_fma(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const T* __restrict__ k, long long k_sb, long long k_st, long long k_sh,
    const T* __restrict__ v, long long v_sb, long long v_st, long long v_sh,
    const int* __restrict__ length, int T_, int kvh, int group, int hd, float scale,
    T* __restrict__ out) {
  constexpr int BT = Tile<T>::kRows;
  constexpr int VEC = Tile<T>::kVec;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int gh = group * hd;
  const int chunks = hd / VEC;  // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                            // kStages x (K, V)
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * BT * hd);  // group x hd
  float* acc_s = qs + gh;                                               // group x hd
  float* ps = acc_s + gh;                                               // group x BT
  float* m_s = ps + group * BT;
  float* l_s = m_s + group;
  float* c_s = l_s + group;

  const int pair = blockIdx.x / splits;  // (b, KV head)
  const int b = pair / kvh;
  const int hk = pair % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int len = length[b];
  len = len < 0 ? 0 : (len > T_ ? T_ : len);
  int start, end;
  share_of(len, rank, splits, &start, &end);
  const int nrows = end - start;
  const int ntiles = (nrows + BT - 1) / BT;

  const T* kb = k + b * k_sb + hk * k_sh + (long long)start * k_st;
  const T* vb = v + b * v_sb + hk * v_sh + (long long)start * v_st;
  auto issue = [&](int t) {  // cp.async of tile t into its stage, one group
    if (t < ntiles) {
      T* ks = ring + (t % kStages) * 2 * BT * hd;
      T* vs = ks + BT * hd;
      const int n = min(BT, nrows - t * BT);
      for (int c = tid; c < 2 * n * chunks; c += kThreads) {
        const int kv = c >= n * chunks;
        const int cc = c - kv * n * chunks;
        const int j = cc / chunks, part = cc % chunks;
        const long long row = (long long)t * BT + j;
        if (kv) {
          cp_async16(vs + j * hd + part * VEC, vb + row * v_st + part * VEC);
        } else {
          int rot = part + j % chunks;  // the chunk's place in a rotated row
          rot -= rot >= chunks ? chunks : 0;
          cp_async16(ks + j * hd + rot * VEC, kb + row * k_st + part * VEC);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (int o = tid; o < gh; o += kThreads) {
    const int g = o / hd, d = o % hd;
    qs[o] = to_f(q[b * q_sb + (long long)(hk * group + g) * q_sh + d]) * scale;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];  // output o = tid + i * kThreads
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile t has landed
    __syncthreads();               // everyone's part; tile t - 1 is done with
    issue(t + kStages - 1);        // into the stage tile t - 1 used
    const T* ks = ring + (t % kStages) * 2 * BT * hd;
    const T* vs = ks + BT * hd;
    const int n = min(BT, nrows - t * BT);
    for (int p = tid; p < group * BT; p += kThreads) {
      const int g = p / BT, j = p % BT;
      float s = kNegInf;
      if (j < n) {
        const float* qg = qs + g * hd;
        const uint4* row = reinterpret_cast<const uint4*>(ks + j * hd);
        int rot = j % chunks;
        s = 0.f;
        for (int c = 0; c < chunks; ++c) {
          s = dot_chunk(qg + c * VEC, row[rot], s, T());
          rot = rot + 1 == chunks ? 0 : rot + 1;
        }
      }
      ps[p] = s;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* row = ps + g * BT;
      const float x = lane < BT ? row[lane] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = lane < n ? expf(x - m_new) : 0.f;
      if (lane < BT) row[lane] = p;
      const float sum = warp_sum(p);
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
  cp_async_wait<0>();  // the empty groups issued past the last tile
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int o = tid + i * kThreads;
    if (o < gh) acc_s[o] = acc[i];
  }
  combine<T>(m_s, l_s, acc_s, group, hd, out + (long long)pair * gh);
}

// ---- the tensor-core kernel: bf16, group <= 16, hd = HD

// dynamic shared memory, in bytes: each warp's ring of pieces (reused at
// the end for the warps' partial outputs), the CTA's partial outputs, the
// warps' and the CTA's m and l
template <int HD> constexpr int mma_smem_bytes(int group) {
  return kMmaWarps * kMmaStages * 2 * kPiece * HD * 2 +
         (group * HD + 2 * kMmaWarps * kMmaMaxGroup + 2 * kMmaMaxGroup) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 3) flash_decode_mma(
    const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh,
    const __nv_bfloat16* __restrict__ k, long long k_sb, long long k_st, long long k_sh,
    const __nv_bfloat16* __restrict__ v, long long v_sb, long long v_st, long long v_sh,
    const int* __restrict__ length, int T_, int kvh, int group, int /*hd*/, float scale,
    __nv_bfloat16* __restrict__ out) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = HD / 8;   // 8-wide column tiles of the output
  constexpr int PIECE = kPiece * HD;  // elements of one K (or V) piece
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // warps x stages x (K, V) pieces
  float* acc_s = reinterpret_cast<float*>(ring + kMmaWarps * kMmaStages * 2 * PIECE);
  float* m_w = acc_s + group * HD;                 // warps x 16
  float* l_w = m_w + kMmaWarps * kMmaMaxGroup;
  float* m_s = l_w + kMmaWarps * kMmaMaxGroup;     // the CTA's partial
  float* l_s = m_s + kMmaMaxGroup;

  const int pair = blockIdx.x / splits;  // (b, KV head)
  const int b = pair / kvh;
  const int hk = pair % kvh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, qid = lane & 3;  // a fragment's row and column pair
  int len = length[b];
  len = len < 0 ? 0 : (len > T_ ? T_ : len);
  int start, end;
  share_of(len, rank, splits, &start, &end);
  const int pieces = (end - start + kPiece - 1) / kPiece;
  const int mine = warp < pieces ? (pieces - warp + kMmaWarps - 1) / kMmaWarps : 0;

  bf16* wring = ring + warp * kMmaStages * 2 * PIECE;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  auto issue = [&](int i) {  // cp.async of this warp's i-th piece, one group
    if (i < mine) {
      bf16* ks = wring + (i % kMmaStages) * 2 * PIECE;
      bf16* vs = ks + PIECE;
      const int r0 = start + (warp + i * kMmaWarps) * kPiece;
      const int n = min(kPiece, end - r0);
#pragma unroll
      for (int c = lane; c < 2 * kPiece * CH; c += 32) {
        const int kv = c >= kPiece * CH;
        const int j = (c % (kPiece * CH)) / CH, part = c % CH;
        bf16* dst = (kv ? vs : ks) + j * HD + (part + j) % CH * 8;
        if (j < n) {
          cp_async16(dst, (kv ? vb + (long long)(r0 + j) * v_st : kb + (long long)(r0 + j) * k_st) +
                              part * 8);
        } else if (kv) {  // a short piece's missing V rows are zero: weight 0
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);  // times a stale NaN is not
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // Q as A fragments, rows gid and gid + 8 (heads past the group are 0)
  uint32_t qa[KS][4];
  const bf16* qb = q + b * q_sb + (long long)hk * group * q_sh;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // h: row half (bit 0), column half (bit 1)
      const int g = gid + (h & 1) * 8, d = s * 16 + (h >> 1) * 8 + 2 * qid;
      qa[s][h] = g < group ? pack_bf16(__bfloat162float(qb[g * q_sh + d]),
                                       __bfloat162float(qb[g * q_sh + d + 1]))
                           : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gid, gid + 8
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kMmaStages - 1>();  // this lane's part of piece i has landed
    __syncwarp();                     // and every lane's
    const bf16* ks = wring + (i % kMmaStages) * 2 * PIECE;
    const bf16* vs = ks + PIECE;
    const int n = min(kPiece, end - (start + (warp + i * kMmaWarps) * kPiece));

    // S = Q K^T: two 8-row column tiles; ldmatrix x4 reads rows (lane & 7)
    // + 8 (lane >> 4) at chunk 2s + ((lane >> 3) & 1)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int krow = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t r[4];
      ldmatrix_x4(r, ks + krow * HD + (2 * s + ((lane >> 3) & 1) + krow) % CH * 8);
      mma_bf16(sc[0], qa[s], r[0], r[1]);
      mma_bf16(sc[1], qa[s], r[2], r[3]);
    }
    // the online softmax on the fragments: element e of tile t is row
    // gid + 8 (e >> 1), column 8t + 2 qid + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * t + 2 * qid + (e & 1) < n;
        sc[t][e] = valid ? sc[t][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];  // this lane's share of the row sum
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * t + 2 * qid + (e & 1) < n;
        sc[t][e] = valid ? expf(sc[t][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += sc[t][e];
      }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    // P as the A operand over the piece's 16 rows: S's tile t is k-half t
    uint32_t hi[4], lo[4];
    split_bf16(sc[0][0], sc[0][1], &hi[0], &lo[0]);
    split_bf16(sc[0][2], sc[0][3], &hi[1], &lo[1]);
    split_bf16(sc[1][0], sc[1][1], &hi[2], &lo[2]);
    split_bf16(sc[1][2], sc[1][3], &hi[3], &lo[3]);
    // O += P V: ldmatrix x4 trans reads V rows (lane & 7) + 8 ((lane >> 3)
    // & 1) at chunk dt + (lane >> 4): two 8-wide column tiles
    const int vrow = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int dt = 0; dt < NT; dt += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vs + vrow * HD + (dt + (lane >> 4) + vrow) % CH * 8);
      mma_bf16(acc[dt], hi, r[0], r[1]);
      mma_bf16(acc[dt], lo, r[0], r[1]);
      mma_bf16(acc[dt + 1], hi, r[2], r[3]);
      mma_bf16(acc[dt + 1], lo, r[2], r[3]);
    }
    __syncwarp();  // every lane is done with the stage
    issue(i + kMmaStages);
  }
  cp_async_wait<0>();  // the empty groups issued past the last piece
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums across the 4 lanes that hold a row
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // the warps' partials into the ring's space, then the CTA's partial
  __syncthreads();
  float* acc_w = reinterpret_cast<float*>(ring) + warp * kMmaMaxGroup * HD;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (gid + 8 * h < group)
        *reinterpret_cast<float2*>(acc_w + (gid + 8 * h) * HD + 8 * t + 2 * qid) =
            make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
  if (qid == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_w[warp * kMmaMaxGroup + gid + 8 * h] = m[h];
      l_w[warp * kMmaMaxGroup + gid + 8 * h] = l[h];
    }
  }
  __syncthreads();
  const float* acc_all = reinterpret_cast<const float*>(ring);
  for (int o = threadIdx.x; o < group * HD; o += kMmaThreads) {
    const int g = o / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, m_w[w * kMmaMaxGroup + g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = expf(m_w[w * kMmaMaxGroup + g] - mx);
      lsum = fmaf(l_w[w * kMmaMaxGroup + g], wt, lsum);
      asum = fmaf(acc_all[w * kMmaMaxGroup * HD + o], wt, asum);
    }
    acc_s[o] = asum;
    if (o % HD == 0) {
      m_s[g] = mx;
      l_s[g] = lsum;
    }
  }
  combine<bf16>(m_s, l_s, acc_s, group, HD, out + (long long)pair * group * HD);
}

// ---- launch

template <typename T>
using Kernel = void (*)(const T*, long long, long long, const T*, long long, long long,
                        long long, const T*, long long, long long, long long, const int*, int,
                        int, int, int, float, T*);

struct Plan {
  const void* fn = nullptr;
  int threads = 0, smem = 0, splits = kPortableSplits;
};

template <typename T> bool tensor_path(int group, int hd) {
  return sizeof(T) == 2 && group <= kMmaMaxGroup && (hd == 16 || hd == 32 || hd == 64 ||
                                                     hd == 128);
}

template <typename T> Kernel<T> pick(int group, int hd, int* threads, int* smem) {
  if constexpr (sizeof(T) == 2) {
    if (tensor_path<T>(group, hd)) {
      *threads = kMmaThreads;
      switch (hd) {
        case 16: *smem = mma_smem_bytes<16>(group); return flash_decode_mma<16>;
        case 32: *smem = mma_smem_bytes<32>(group); return flash_decode_mma<32>;
        case 64: *smem = mma_smem_bytes<64>(group); return flash_decode_mma<64>;
        default: *smem = mma_smem_bytes<128>(group); return flash_decode_mma<128>;
      }
    }
  }
  *threads = kThreads;
  *smem = fma_smem_bytes<T>(group, hd);
  return flash_decode_fma<T>;
}

cudaLaunchConfig_t cluster_config(int ctas, int threads, int smem, int splits,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel, cluster size and shared memory for one call.  Per (kernel,
// device) the SM count is read once, the largest shared memory asked for
// so far is set once (the attribute only ever rises: a smaller call runs
// under a larger limit), and whether a cluster of 16 fits is asked once per
// size: a decode step makes one call per layer, and its host is the limit.
template <typename T> cudaError_t plan(int B, int kvh, int group, int hd, Kernel<T>* fn,
                                       Plan* p) {
  struct Cache {
    const void* fn;
    int device, sms, smem_set, wide_smem, wide;
  };
  static Cache cache[8] = {};
  *fn = pick<T>(group, hd, &p->threads, &p->smem);
  p->fn = (const void*)*fn;
  if (p->threads == kThreads && group * hd > kThreads * kMaxAcc) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  Cache* c = nullptr;
  for (Cache& e : cache)
    if (e.fn == p->fn && e.device == device) c = &e;
  if (c == nullptr) {
    int sms = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(*fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
        cudaSuccess)
      return err;
    c = &cache[0];
    for (Cache& e : cache)
      if (e.fn == nullptr) c = &e;
    *c = {p->fn, device, sms, 0, -1, 0};
  }
  if (p->smem > c->smem_set) {
    if ((err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    p->smem)) != cudaSuccess)
      return err;
    c->smem_set = p->smem;
  }
  p->splits = kPortableSplits;
  if ((long long)B * kvh * kPortableSplits < c->sms) {  // most SMs would sit idle
    if (c->wide_smem != p->smem) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg =
          cluster_config(kWideSplits, p->threads, p->smem, kWideSplits, attr);
      int clusters = 0;
      c->wide = cudaOccupancyMaxActiveClusters(&clusters, *fn, &cfg) == cudaSuccess &&
                clusters > 0;
      cudaGetLastError();  // a refused query leaves the portable size
      c->wide_smem = p->smem;
    }
    if (c->wide) p->splits = kWideSplits;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* q, long long q_sb, long long q_sh, const void* k, long long k_sb,
           long long k_st, long long k_sh, const void* v, long long v_sb, long long v_st,
           long long v_sh, const void* length, int B, int T_, int kvh, int group, int hd,
           float scale, void* out, cudaStream_t stream) {
  Plan p;
  Kernel<T> fn;
  cudaError_t err = plan<T>(B, kvh, group, hd, &fn, &p);
  if (err != cudaSuccess) return err;
  if (B * kvh == 0) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B * kvh * p.splits, p.threads, p.smem, p.splits, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, fn, (const T*)q, q_sb, q_sh, (const T*)k, k_sb, k_st, k_sh,
                           (const T*)v, v_sb, v_st, v_sh, (const int*)length, T_, kvh, group,
                           hd, scale, (T*)out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T> int info(int B, int kvh, int group, int hd, int* out) {
  Plan p;
  Kernel<T> fn;
  cudaError_t err = plan<T>(B, kvh, group, hd, &fn, &p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(B * kvh * p.splits, p.threads, p.smem, p.splits, attr);
  if ((err = cudaOccupancyMaxActiveClusters(&out[6], fn, &cfg)) != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = p.smem;
  out[3] = p.splits;
  out[4] = (int)a.localSizeBytes;
  out[5] = p.threads;
  out[7] = tensor_path<T>(group, hd);
  return cudaSuccess;
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

// The launch for (B, kvh, group, hd, dtype): out[0] registers per thread,
// out[1] static and out[2] dynamic shared memory per CTA in bytes, out[3]
// CTAs per cluster (the split of T), out[4] local memory per thread
// (spills) in bytes, out[5] threads per CTA, out[6] clusters the card holds
// at once, out[7] 1 for the tensor-core kernel, 0 for the FMA one.
int flash_decode_info(int B, int kvh, int group, int hd, int dtype, int* out) {
  if (dtype == 0) return info<float>(B, kvh, group, hd, out);
  return info<__nv_bfloat16>(B, kvh, group, hd, out);
}

}  // extern "C"
