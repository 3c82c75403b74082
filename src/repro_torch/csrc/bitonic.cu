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
// for 2^24 elements at 3.35 TB/s.  What limits it is the network: its
// log2(W)(log2(W)+1)/4 compare-exchanges per element (45.5 at W = 8192) are
// 64-bit compares and selects, ~7 integer instructions each (~0.3 ms for
// 2^24 elements at the card's 64 integer lanes per SM and clock), and the
// window's exchanges through shared memory (below, ~0.2 ms of 8-byte
// accesses at 128 B per SM and clock).
//
// The word.  Each element is packed into one 64-bit word: bucket in the top
// 32 - log2(W) bits, then the key with its sign bit flipped (so unsigned
// order is the signed key order), then its window index in the low log2(W)
// bits.  The index makes every word distinct, so any sorting network over
// the words is the stable sort by (bucket, key).  The wrapper checks that
// the buckets fit the top bits.
//
// Design: register-resident bitonic stages.  The first design ran all
// log2W(log2W+1)/2 = 91 steps (W = 8192) as block-wide passes over the
// window in shared memory, 91 reads and writes of 64 KiB between barriers
// in 1024-thread CTAs: 1.0986 ms at 2048 windows of 8192 on an NVIDIA H100
// 80GB HBM3 at 700 W, 14x the bound.  Now each thread holds E = 2^e words
// in registers (E = 16 up to W = 8192, 32 at 16384; T = W / E threads a
// window).  In a layout with base b the thread's E words are the indices
// whose bits b .. b+e-1 run over the registers and whose other bits are the
// thread's: every step whose stride bit lies in b .. b+e-1 is a
// compare-exchange between two of the thread's registers.  Stage s
// (strides 2^s .. 1) runs its strides e bits at a time, top chunk first
// (base s-e+1, then ..., 2e, e, 0); between chunks the window goes through
// shared memory once (each thread writes its words and reads its new ones)
// to re-map which index bits the registers span.  At W = 8192 that is 24
// exchanges instead of 91 passes, and stages 0..e-1 need none.  An exchange
// needs one barrier, between the writes and the reads: a thread writes back
// the slots it read in the exchange before.  Between layouts b1 and b2 the
// words move only among threads that differ in t's bits min(b1, b2) ..
// max(b1, b2) - 1, so when those are lane bits the barrier is the warp's
// (15 of the 24 exchanges at W = 8192, all 8 at W = 256).  The sort
// direction of stage s is index bit s+1, always one of the thread's own
// bits, so it is one flag a thread per stage.  The shared window is padded
// by one word per E (slot = idx + idx / E): the transposed 64-bit accesses
// of every layout then fall on distinct bank pairs within a half-warp.  A
// CTA of 512 threads holds 512 / T windows (W <= 8192; W = 16384 one); its
// shared memory is 512 (E + 1) words (69,632 B at E = 16), so two CTAs of
// 512 fit an SM (the registers, 64 a thread, cap them at two).  Words are
// read and written E consecutive per thread with 16-byte accesses.  W = 2,
// 4 and 8 take one thread a window, all in registers.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): ~0.5 ms at 2048
// windows of 8192, 6x the byte bound.  What is left is the integer pipe and
// the exchanges' shared-memory traffic, which overlap only partly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kCta = 512;

// after it, a < b when up, a > b otherwise
__device__ __forceinline__ void exchange(u64& a, u64& b, bool up) {
  const bool swap = (a > b) == up;
  const u64 lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

// the strides of local bits LOG_E - 1 .. lj_lo (high first) in registers
template <int LOG_E>
__device__ __forceinline__ void register_steps(u64 (&x)[1 << LOG_E], int lj_lo, bool up) {
#pragma unroll
  for (int lj = LOG_E - 1; lj >= 0; --lj) {
    if (lj >= lj_lo) {
#pragma unroll
      for (int r = 0; r < (1 << LOG_E); ++r)
        if (!(r & (1 << lj))) exchange(x[r], x[r | (1 << lj)], up);
    }
  }
}

// thread t's word r in layout b sits at slot base(t, b) + offset(r, b) of the
// padded window (slot = idx + (idx >> LOG_E); the index's fields are
// disjoint bits, so the padding splits over them)
template <int LOG_E>
__device__ __forceinline__ int slot_base(int t, int b) {
  const int i = (t & ((1 << b) - 1)) | ((t >> b) << (b + LOG_E));
  return i + (i >> LOG_E);
}

template <int LOG_E, bool STORE>
__device__ __forceinline__ void exchange_window(u64* sw, u64 (&x)[1 << LOG_E], int t, int b) {
  constexpr int E = 1 << LOG_E;
  u64* p = sw + slot_base<LOG_E>(t, b);
  if (b == 0) {  // offset r
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (STORE) p[r] = x[r]; else x[r] = p[r];
    }
  } else if (b >= LOG_E) {  // offset r * (2^b + 2^(b - LOG_E))
    const int step = (1 << b) + (1 << (b - LOG_E));
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (STORE) p[r * step] = x[r]; else x[r] = p[r * step];
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int off = (r << b) + (r >> (LOG_E - b));
      if (STORE) p[off] = x[r]; else x[r] = p[off];
    }
  }
}

template <int LOG_E>
__global__ void __launch_bounds__(kCta, LOG_E == 4 ? 2 : 1) sort_windows_kernel(
    const int* __restrict__ bucket, const int* __restrict__ keys, int num_w, int log2w,
    int* __restrict__ perm, int* __restrict__ bucket_out) {
  constexpr int E = 1 << LOG_E;
  extern __shared__ u64 smem[];
  const int log2t = log2w - LOG_E;  // T = W / E threads a window
  const int T = 1 << log2t, W = 1 << log2w;
  const int local_w = threadIdx.x >> log2t;
  const int t = threadIdx.x & (T - 1);
  const long long w = (long long)blockIdx.x * (kCta >> log2t) + local_w;
  const bool live = w < num_w;
  u64* sw = smem + local_w * (W + T);  // the padded window
  const int bucket_shift = 32 + log2w;
  const long long base = w * W + (long long)t * E;

  // layout 0: thread t holds indices t * E + r
  u64 x[E];
  if (live) {
#pragma unroll
    for (int r4 = 0; r4 < E; r4 += 4) {
      const int4 b4 = *reinterpret_cast<const int4*>(bucket + base + r4);
      const int4 k4 = *reinterpret_cast<const int4*>(keys + base + r4);
      const int bv[4] = {b4.x, b4.y, b4.z, b4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[r4 + e] = ((u64)(unsigned)bv[e] << bucket_shift) |
                    ((u64)((unsigned)kv[e] ^ 0x80000000u) << log2w) |
                    (u64)(t * E + r4 + e);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = 0;
  }

  // stages 0 .. LOG_E - 1 within the thread; the direction is index bit s+1
#pragma unroll
  for (int s = 0; s < LOG_E; ++s) {
#pragma unroll
    for (int j = s; j >= 0; --j) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & (1 << j)) continue;
        const bool up = s + 1 < LOG_E ? !((r >> (s + 1)) & 1) : !(t & 1);
        exchange(x[r], x[r | (1 << j)], up);
      }
    }
  }

  // stages LOG_E .. log2w - 1: chunks of LOG_E strides, each in the layout
  // whose register bits hold them; index bit s+1 is the thread's bit s+1-LOG_E
  // in every such layout
  int b_cur = 0;
  for (int s = LOG_E; s < log2w; ++s) {
    const bool up = !((t >> (s + 1 - LOG_E)) & 1);
    const int k_top = s / LOG_E;
    for (int k = k_top; k >= 0; --k) {
      const int b = k == k_top ? s - LOG_E + 1 : k * LOG_E;
      // A thread writes back the slots it read in the last exchange, so no
      // barrier comes before the write.  Between layouts b_cur and b words
      // move only among the threads that differ in t's bits min(b_cur, b)
      // .. max(b_cur, b) - 1: within a warp when those are lane bits.
      exchange_window<LOG_E, true>(sw, x, t, b_cur);
      if (max(b_cur, b) <= 5) __syncwarp(); else __syncthreads();
      exchange_window<LOG_E, false>(sw, x, t, b);
      b_cur = b;
      register_steps<LOG_E>(x, k == k_top ? k * LOG_E - b : 0, up);
    }
  }

  if (!live) return;
  const u64 idx_mask = (1ull << log2w) - 1ull;
#pragma unroll
  for (int r4 = 0; r4 < E; r4 += 4) {
    int pv[4], bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] = (int)(x[r4 + e] & idx_mask);
      bv[e] = (int)(x[r4 + e] >> bucket_shift);
    }
    *reinterpret_cast<int4*>(perm + base + r4) = make_int4(pv[0], pv[1], pv[2], pv[3]);
    *reinterpret_cast<int4*>(bucket_out + base + r4) = make_int4(bv[0], bv[1], bv[2], bv[3]);
  }
}

// W = 2 .. 8: one thread sorts a window in registers
template <int LOG_W>
__global__ void __launch_bounds__(kCta) sort_small_windows_kernel(
    const int* __restrict__ bucket, const int* __restrict__ keys, int num_w,
    int* __restrict__ perm, int* __restrict__ bucket_out) {
  constexpr int W = 1 << LOG_W;
  const long long w = (long long)blockIdx.x * kCta + threadIdx.x;
  if (w >= num_w) return;
  const long long base = w * W;
  u64 x[W];
#pragma unroll
  for (int r = 0; r < W; ++r)
    x[r] = ((u64)(unsigned)bucket[base + r] << (32 + LOG_W)) |
           ((u64)((unsigned)keys[base + r] ^ 0x80000000u) << LOG_W) | (u64)r;
#pragma unroll
  for (int s = 0; s < LOG_W; ++s)
#pragma unroll
    for (int j = s; j >= 0; --j)
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (!(r & (1 << j))) exchange(x[r], x[r | (1 << j)], !((r >> (s + 1)) & 1));
#pragma unroll
  for (int r = 0; r < W; ++r) {
    perm[base + r] = (int)(x[r] & (W - 1));
    bucket_out[base + r] = (int)(x[r] >> (32 + LOG_W));
  }
}

template <int LOG_E>
int launch_windows(const void* bucket, const void* keys, int num_w, int log2w, void* perm,
                   void* bucket_out, cudaStream_t stream) {
  const int T = 1 << (log2w - LOG_E), per_cta = kCta / T;
  const int smem = per_cta * ((1 << log2w) + T) * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      sort_windows_kernel<LOG_E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (num_w == 0) return cudaSuccess;
  sort_windows_kernel<LOG_E><<<(num_w + per_cta - 1) / per_cta, kCta, smem, stream>>>(
      (const int*)bucket, (const int*)keys, num_w, log2w, (int*)perm, (int*)bucket_out);
  return cudaGetLastError();
}

template <int LOG_W>
int launch_small(const void* bucket, const void* keys, int num_w, void* perm,
                 void* bucket_out, cudaStream_t stream) {
  if (num_w == 0) return cudaSuccess;
  sort_small_windows_kernel<LOG_W><<<(num_w + kCta - 1) / kCta, kCta, 0, stream>>>(
      (const int*)bucket, (const int*)keys, num_w, (int*)perm, (int*)bucket_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bitonic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// W = 2^log2w in [2, 16384]; bucket, keys, perm and bucket_out are (num_w,
// W) int32, 16-byte aligned
int bitonic_sort_windows(const void* bucket, const void* keys, int num_w, int W,
                         int log2w, void* perm, void* bucket_out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2w) {
    case 1: return launch_small<1>(bucket, keys, num_w, perm, bucket_out, s);
    case 2: return launch_small<2>(bucket, keys, num_w, perm, bucket_out, s);
    case 3: return launch_small<3>(bucket, keys, num_w, perm, bucket_out, s);
    case 14: return launch_windows<5>(bucket, keys, num_w, log2w, perm, bucket_out, s);
    default:
      if (log2w < 4 || log2w > 14 || W != 1 << log2w) return cudaErrorInvalidValue;
      return launch_windows<4>(bucket, keys, num_w, log2w, perm, bucket_out, s);
  }
}

}  // extern "C"
