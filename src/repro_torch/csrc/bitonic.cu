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
//
// 64-bit keys (`bitonic_sort_windows64`): a stable merge sort inside the
// CTA.  A 64-bit key leaves no room in a 64-bit word, so an element is the
// 96-bit number (bucket, key ^ sign bit, idx) as a 64-bit high word and a
// 32-bit low word (`Packed96`), compared by a 96-bit subtraction chained
// through the carry flag.  The index makes the words distinct, so their
// order is a total order and it is the stable (bucket, key) order.  The
// first design ran the network above on these 12-byte elements: 45.5
// compare-exchanges an element at W = 8192, each a 96-bit compare and
// three selects, and 24 window exchanges, ~840 integer instructions an
// element (0.9952 ms at 2048 windows of 8192 on an H100, 10x the bound).
// A merge sort makes ~log2 W compares an element instead:
//   1. Load.  From E = 16 thread t takes the window's positions t + T r
//      (T = W / E threads a window), so a warp's loads are contiguous; at
//      E = 8 its E consecutive positions by 16-byte loads.
//   2. Thread sort.  Batcher's odd-even network over the E words in
//      registers (63 compare-exchanges at E = 16).
//   3. log2(W / E) merge rounds through the window in shared memory: the
//      high words and the low words in two arrays, padded by one slot per
//      E (slot = i + i / E), so a thread's E consecutive writes meet no
//      bank conflict across the warp.  In round k the 2R / E threads of a
//      pair of runs of R = E 2^k find where their E outputs start on the
//      merge path (a binary search on the diagonal, reading the low words
//      only where the high words tie) and merge them serially into
//      registers: a compare, three selects and one shared load an output.
//      Rounds whose pairs lie within a warp sync the warp only.
//   4. Store.  Perm = idx and the bucket: from E = 16 back through the
//      window and out at positions t + T r; at E = 8 16-byte stores.
// E is 8 up to W = 128, 16 up to 1024 and 32 above (the search and the
// global accesses per element fall as E grows; at 32 the 128-register cap
// of 512 threads an SM is reached), in CTAs of 128 threads, and of W / 32
// threads at W = 8192 and 16384 (101 and 203 KB of shared memory, 2 and 1
// CTAs an SM), all picked by timing on an H100 (PERF.md).  Staging the
// next window by TMA (`cp.async.bulk`) in persistent CTAs was tried at W =
// 8192 and gained nothing measurable: the load is a small share of the
// time once warps' accesses are contiguous.  W = 2, 4 and 8 take one
// thread a window (the bitonic network above on `Packed96` words).
// Bound: 20 B an element (8 B of key and 4 B of bucket in, 4 B of index
// and 4 B of bucket out), and log2 W compares an element at ~9 operations
// each (a 96-bit compare and the select of three words), whatever sort
// does the work: bytes bound it, 0.1002 ms at 2048 windows of 8192.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

// 32-bit keys: one 64-bit word (bucket, key ^ sign bit, idx), compared as
// it is; the window in shared memory is one array of words
struct Packed32 {
  typedef u64 Word;
  int log2w;
  __device__ __forceinline__ bool gt(const u64& a, const u64& b) const { return a > b; }
  __device__ __forceinline__ Word make(int bucket, int key, int idx) const {
    return ((u64)(unsigned)bucket << (32 + log2w)) |
           ((u64)((unsigned)key ^ 0x80000000u) << log2w) | (u64)idx;
  }
  __device__ __forceinline__ Word zero() const { return 0; }
  __device__ __forceinline__ int idx(const u64& x) const {
    return (int)(x & ((1ull << log2w) - 1ull));
  }
  __device__ __forceinline__ int bucket(const u64& x) const { return (int)(x >> (32 + log2w)); }
  static constexpr int kBytes = 8;  // shared memory a slot
  struct Window {
    u64* p;
    __device__ __forceinline__ void put(int i, const u64& x) const { p[i] = x; }
    __device__ __forceinline__ void get(int i, u64& x) const { x = p[i]; }
  };
  // window local_w of per_cta, each of `slots` padded slots
  __device__ __forceinline__ Window window(void* smem, int local_w, int per_cta,
                                           int slots) const {
    return Window{reinterpret_cast<u64*>(smem) + local_w * slots};
  }
};

// 64-bit keys, as one 96-bit number (bucket, key ^ sign bit, idx) in two
// words: hi = bucket << (32 + log2w) | key >> (32 - log2w), lo = the key's
// low 32 - log2w bits, then idx; compared as (hi, lo)
struct Packed96 {
  struct Word {
    u64 hi;
    unsigned lo;
  };
  int log2w;
  // a > b: the borrow out of the 96-bit b - a, three subtractions chained
  // by the carry flag (the compiler's (hi, lo) form takes more)
  __device__ __forceinline__ bool gt(const Word& a, const Word& b) const {
    unsigned borrow;
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %1, %2;\n\t"
        "subc.cc.u32 t, %3, %4;\n\t"
        "subc.cc.u32 t, %5, %6;\n\t"
        "subc.u32 %0, 0, 0;\n\t}"
        : "=r"(borrow)
        : "r"(b.lo), "r"(a.lo), "r"((unsigned)b.hi), "r"((unsigned)a.hi),
          "r"((unsigned)(b.hi >> 32)), "r"((unsigned)(a.hi >> 32)));
    return borrow != 0u;
  }
  __device__ __forceinline__ Word make(int bucket, long long key, int idx) const {
    const u64 u = (u64)key ^ 0x8000000000000000ull;
    return Word{((u64)(unsigned)bucket << (32 + log2w)) | (u >> (32 - log2w)),
                ((unsigned)u << log2w) | (unsigned)idx};
  }
  __device__ __forceinline__ Word zero() const { return Word{0ull, 0u}; }
  __device__ __forceinline__ int idx(const Word& x) const {
    return (int)(x.lo & ((1u << log2w) - 1u));
  }
  __device__ __forceinline__ int bucket(const Word& x) const {
    return (int)(x.hi >> (32 + log2w));
  }
  static constexpr int kBytes = 12;
  struct Window {
    u64* hi;
    unsigned* lo;
    __device__ __forceinline__ void put(int i, const Word& x) const { hi[i] = x.hi, lo[i] = x.lo; }
    __device__ __forceinline__ void get(int i, Word& x) const { x.hi = hi[i], x.lo = lo[i]; }
  };
  __device__ __forceinline__ Window window(void* smem, int local_w, int per_cta,
                                           int slots) const {
    u64* his = reinterpret_cast<u64*>(smem);
    return Window{his + local_w * slots,
                  reinterpret_cast<unsigned*>(his + per_cta * slots) + local_w * slots};
  }
};

template <int E>
__device__ __forceinline__ void load_words(const Packed96& pk, const int* bucket,
                                           const long long* keys, long long base, int first,
                                           Packed96::Word (&x)[E]) {
#pragma unroll
  for (int r4 = 0; r4 < E; r4 += 4) {
    const int4 b4 = *reinterpret_cast<const int4*>(bucket + base + r4);
    const longlong2 k0 = *reinterpret_cast<const longlong2*>(keys + base + r4);
    const longlong2 k1 = *reinterpret_cast<const longlong2*>(keys + base + r4 + 2);
    const int bv[4] = {b4.x, b4.y, b4.z, b4.w};
    const long long kv[4] = {k0.x, k0.y, k1.x, k1.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) x[r4 + e] = pk.make(bv[e], kv[e], first + r4 + e);
  }
}

// after it, a < b when up, a > b otherwise
template <class P>
__device__ __forceinline__ void exchange(const P& pk, typename P::Word& a,
                                         typename P::Word& b, bool up) {
  const bool swap = pk.gt(a, b) == up;
  const typename P::Word lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

// the strides of local bits LOG_E - 1 .. lj_lo (high first) in registers
template <class P, int LOG_E>
__device__ __forceinline__ void register_steps(const P& pk, typename P::Word (&x)[1 << LOG_E],
                                               int lj_lo, bool up) {
#pragma unroll
  for (int lj = LOG_E - 1; lj >= 0; --lj) {
    if (lj >= lj_lo) {
#pragma unroll
      for (int r = 0; r < (1 << LOG_E); ++r)
        if (!(r & (1 << lj))) exchange(pk, x[r], x[r | (1 << lj)], up);
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

template <class P, int LOG_E, bool STORE>
__device__ __forceinline__ void exchange_window(const typename P::Window& sw,
                                                typename P::Word (&x)[1 << LOG_E], int t,
                                                int b) {
  constexpr int E = 1 << LOG_E;
  const int p = slot_base<LOG_E>(t, b);
  if (b == 0) {  // offset r
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (STORE) sw.put(p + r, x[r]); else sw.get(p + r, x[r]);
    }
  } else if (b >= LOG_E) {  // offset r * (2^b + 2^(b - LOG_E))
    const int step = (1 << b) + (1 << (b - LOG_E));
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (STORE) sw.put(p + r * step, x[r]); else sw.get(p + r * step, x[r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int off = (r << b) + (r >> (LOG_E - b));
      if (STORE) sw.put(p + off, x[r]); else sw.get(p + off, x[r]);
    }
  }
}

// E consecutive elements from index `base`: the keys 16 bytes at a time
template <int E>
__device__ __forceinline__ void load_words(const Packed32& pk, const int* bucket,
                                           const int* keys, long long base, int first,
                                           u64 (&x)[E]) {
#pragma unroll
  for (int r4 = 0; r4 < E; r4 += 4) {
    const int4 b4 = *reinterpret_cast<const int4*>(bucket + base + r4);
    const int4 k4 = *reinterpret_cast<const int4*>(keys + base + r4);
    const int bv[4] = {b4.x, b4.y, b4.z, b4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) x[r4 + e] = pk.make(bv[e], kv[e], first + r4 + e);
  }
}

// Key: the keys' type (int: one word an element, long long: two); CTA
// threads, MIN_CTAS at once an SM (the register cap)
template <class P, typename Key, int LOG_E, int CTA, int MIN_CTAS>
__global__ void __launch_bounds__(CTA, MIN_CTAS) sort_windows_kernel(
    const int* __restrict__ bucket, const Key* __restrict__ keys, int num_w, int log2w,
    int* __restrict__ perm, int* __restrict__ bucket_out) {
  constexpr int E = 1 << LOG_E;
  extern __shared__ u64 smem[];
  const P pk{log2w};
  const int log2t = log2w - LOG_E;  // T = W / E threads a window
  const int T = 1 << log2t, W = 1 << log2w;
  const int local_w = threadIdx.x >> log2t;
  const int t = threadIdx.x & (T - 1);
  const long long w = (long long)blockIdx.x * (CTA >> log2t) + local_w;
  const bool live = w < num_w;
  const typename P::Window sw = pk.window(smem, local_w, CTA >> log2t, W + T);  // padded
  const long long base = w * W + (long long)t * E;

  // layout 0: thread t holds indices t * E + r
  typename P::Word x[E];
  if (live) {
    load_words<E>(pk, bucket, keys, base, t * E, x);
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = pk.zero();
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
        exchange(pk, x[r], x[r | (1 << j)], up);
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
      exchange_window<P, LOG_E, true>(sw, x, t, b_cur);
      if (max(b_cur, b) <= 5) __syncwarp(); else __syncthreads();
      exchange_window<P, LOG_E, false>(sw, x, t, b);
      b_cur = b;
      register_steps<P, LOG_E>(pk, x, k == k_top ? k * LOG_E - b : 0, up);
    }
  }

  if (!live) return;
#pragma unroll
  for (int r4 = 0; r4 < E; r4 += 4) {
    int pv[4], bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] = pk.idx(x[r4 + e]);
      bv[e] = pk.bucket(x[r4 + e]);
    }
    *reinterpret_cast<int4*>(perm + base + r4) = make_int4(pv[0], pv[1], pv[2], pv[3]);
    *reinterpret_cast<int4*>(bucket_out + base + r4) = make_int4(bv[0], bv[1], bv[2], bv[3]);
  }
}

constexpr int kSmallCta = 512;

// W = 2 .. 8: one thread sorts a window in registers
template <class P, typename Key, int LOG_W>
__global__ void __launch_bounds__(kSmallCta) sort_small_windows_kernel(
    const int* __restrict__ bucket, const Key* __restrict__ keys, int num_w,
    int* __restrict__ perm, int* __restrict__ bucket_out) {
  constexpr int W = 1 << LOG_W;
  const P pk{LOG_W};
  const long long w = (long long)blockIdx.x * kSmallCta + threadIdx.x;
  if (w >= num_w) return;
  const long long base = w * W;
  typename P::Word x[W];
#pragma unroll
  for (int r = 0; r < W; ++r) x[r] = pk.make(bucket[base + r], keys[base + r], r);
#pragma unroll
  for (int s = 0; s < LOG_W; ++s)
#pragma unroll
    for (int j = s; j >= 0; --j)
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (!(r & (1 << j))) exchange(pk, x[r], x[r | (1 << j)], !((r >> (s + 1)) & 1));
#pragma unroll
  for (int r = 0; r < W; ++r) {
    perm[base + r] = pk.idx(x[r]);
    bucket_out[base + r] = pk.bucket(x[r]);
  }
}

template <class P, typename Key, int LOG_E, int CTA, int MIN_CTAS>
int launch_windows(const void* bucket, const void* keys, int num_w, int log2w, void* perm,
                   void* bucket_out, cudaStream_t stream) {
  const int T = 1 << (log2w - LOG_E), per_cta = CTA / T;
  if (T > CTA) return cudaErrorInvalidValue;
  const int smem = per_cta * ((1 << log2w) + T) * P::kBytes;
  const auto kernel = sort_windows_kernel<P, Key, LOG_E, CTA, MIN_CTAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (num_w == 0) return cudaSuccess;
  kernel<<<(num_w + per_cta - 1) / per_cta, CTA, smem, stream>>>(
      (const int*)bucket, (const Key*)keys, num_w, log2w, (int*)perm, (int*)bucket_out);
  return cudaGetLastError();
}

template <class P, typename Key, int LOG_W>
int launch_small(const void* bucket, const void* keys, int num_w, void* perm,
                 void* bucket_out, cudaStream_t stream) {
  if (num_w == 0) return cudaSuccess;
  sort_small_windows_kernel<P, Key, LOG_W>
      <<<(num_w + kSmallCta - 1) / kSmallCta, kSmallCta, 0, stream>>>(
          (const int*)bucket, (const Key*)keys, num_w, (int*)perm, (int*)bucket_out);
  return cudaGetLastError();
}

// ---- the 64-bit form: a stable merge sort inside the CTA ----

// x ascending by pk.gt: Batcher's odd-even merge sort (63 compare-exchanges
// at N = 16, 19 at 8).  Step (2^lp, 2^lk), lk <= lp, pairs a with a + 2^lk;
// its pairs are disjoint.  Every loop has a constant trip count, so all
// three unroll and x stays in registers (a trip count taken from an outer
// loop's variable left x in local memory).
template <class P, int LOG_N>
__device__ __forceinline__ void network_sort(const P& pk, typename P::Word (&x)[1 << LOG_N]) {
  constexpr int N = 1 << LOG_N;
#pragma unroll
  for (int lp = 0; lp < LOG_N; ++lp) {
#pragma unroll
    for (int lk = LOG_N - 1; lk >= 0; --lk) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const int p = 1 << lp, k = 1 << lk, j0 = k % p;
        if (lk <= lp && a + k < N && a >= j0 && ((a - j0) & (2 * k - 1)) < k &&
            a / (2 * p) == (a + k) / (2 * p))
          exchange(pk, x[a], x[a + k], true);
      }
    }
  }
}

// a window's padded slots: W + T for its positions (slot = i + i / E) and
// one more, the slot of position W, which the merge reads and never uses
__host__ __device__ constexpr int merge_slots(int log_w, int log_e) {
  return (1 << log_w) + (1 << (log_w - log_e)) + 1;
}

template <int LOG_E>
__device__ __forceinline__ int padded(int i) {
  return i + (i >> LOG_E);
}

// Barrier for an aligned group of `span` threads (a power of two) that
// share slots: the warp's when the group lies in one warp.
__device__ __forceinline__ void sync_span(int span) {
  if (span <= 32) __syncwarp(); else __syncthreads();
}

// W = 2^LOG_W, E = 2^LOG_E elements a thread, T = W / E threads a window,
// CTA / T windows a CTA; the element is the 96-bit number of `Packed96`.
// W is a template argument, so shifts, slots and round bounds are
// constants and hold no registers.
template <int LOG_W, int LOG_E, int CTA, int MIN_CTAS>
__global__ void __launch_bounds__(CTA, MIN_CTAS) merge_sort_windows_kernel(
    const int* __restrict__ bucket, const long long* __restrict__ keys, int num_w,
    int* __restrict__ perm, int* __restrict__ bucket_out) {
  constexpr int E = 1 << LOG_E, LOG_T = LOG_W - LOG_E, T = 1 << LOG_T, PER_CTA = CTA / T;
  // From E = 16 thread t loads and stores the window's positions t + T r,
  // so a warp's accesses are contiguous; below, its E consecutive positions
  // by 16-byte accesses (T is small, so a warp's span is contiguous too).
  constexpr bool STRIPED = LOG_E >= 4;
  typedef Packed96::Word Word;
  extern __shared__ u64 smem[];
  const Packed96 pk{LOG_W};
  const int local_w = threadIdx.x >> LOG_T;
  const int t = threadIdx.x & (T - 1);
  const Packed96::Window sw = pk.window(smem, local_w, PER_CTA, merge_slots(LOG_W, LOG_E));
  const long long w = (long long)blockIdx.x * PER_CTA + local_w;
  const bool live = w < num_w;

  Word x[E];
  if (!live) {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = pk.zero();
  } else if (STRIPED) {
    const long long base = w << LOG_W;
#pragma unroll
    for (int r = 0; r < E; ++r)
      x[r] = pk.make(bucket[base + t + T * r], keys[base + t + T * r], t + T * r);
  } else {
    load_words<E>(pk, bucket, keys, (w << LOG_W) + (long long)t * E, t * E, x);
  }
  network_sort<Packed96, LOG_E>(pk, x);

  // Round k merges runs of R = E 2^k into runs of 2R; 2R / E threads share
  // a pair of runs.  The words are distinct (their low bits are the
  // index), so their order is a total order, and it is the stable (bucket,
  // key) order whichever positions a run holds.
#pragma unroll 1
  for (int k = 0; k < LOG_T; ++k) {
    if (k > 0) sync_span(1 << k);  // round k-1's pair has read these slots
#pragma unroll
    for (int r = 0; r < E; ++r) sw.put(padded<LOG_E>(t * E + r), x[r]);
    sync_span(2 << k);
    const int R = E << k;
    const int a0 = (t & ~((2 << k) - 1)) * E;  // the pair's first position
    const int d = t * E - a0;                   // this thread's diagonal
    // i: the left run's elements among the pair's first d outputs (the low
    // words are read only where the high words tie)
    int lo = max(0, d - R), hi = min(d, R);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int pa = padded<LOG_E>(a0 + mid), pb = padded<LOG_E>(a0 + R + d - 1 - mid);
      const u64 ah = sw.hi[pa], bh = sw.hi[pb];
      bool a_gt = ah > bh;
      if (ah == bh) a_gt = sw.lo[pa] > sw.lo[pb];
      if (a_gt) hi = mid; else lo = mid + 1;
    }
    int ia = a0 + lo, ib = a0 + R + d - lo;
    const int a_end = a0 + R, b_end = a0 + 2 * R;
    Word av, bv;
    sw.get(padded<LOG_E>(ia), av);
    sw.get(padded<LOG_E>(ib), bv);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      // both runs cannot be spent before the pair's 2R outputs
      const bool take_b = ib < b_end && (ia >= a_end || pk.gt(av, bv));
      x[r].hi = take_b ? bv.hi : av.hi;
      x[r].lo = take_b ? bv.lo : av.lo;
      if (r + 1 < E) {  // one load, its word to the spent run's head
        ia += !take_b;
        ib += take_b;
        Word nv;
        sw.get(padded<LOG_E>(take_b ? ib : ia), nv);
        av.hi = take_b ? av.hi : nv.hi;
        av.lo = take_b ? av.lo : nv.lo;
        bv.hi = take_b ? nv.hi : bv.hi;
        bv.lo = take_b ? nv.lo : bv.lo;
      }
    }
  }

  if (STRIPED) {  // back through the window, then out at positions t + T r
    sync_span(T);  // the last round has read the window
#pragma unroll
    for (int r = 0; r < E; ++r) sw.put(padded<LOG_E>(t * E + r), x[r]);
    sync_span(T);
    if (!live) return;
    const long long base = w << LOG_W;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      Word y;
      sw.get(padded<LOG_E>(t + T * r), y);
      perm[base + t + T * r] = pk.idx(y);
      bucket_out[base + t + T * r] = pk.bucket(y);
    }
  } else if (live) {
    const long long base = (w << LOG_W) + (long long)t * E;
#pragma unroll
    for (int r4 = 0; r4 < E; r4 += 4) {
      int pv[4], bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = pk.idx(x[r4 + e]);
        bv[e] = pk.bucket(x[r4 + e]);
      }
      *reinterpret_cast<int4*>(perm + base + r4) = make_int4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<int4*>(bucket_out + base + r4) = make_int4(bv[0], bv[1], bv[2], bv[3]);
    }
  }
}

// One launch of the merge sort: its kernel, threads, windows a CTA and
// dynamic shared memory (the attribute set for it)
struct MergeLaunch {
  const void* kernel;
  int threads, per_cta, smem;
};

template <int LOG_W, int LOG_E, int CTA, int MIN_CTAS>
cudaError_t merge_setup(MergeLaunch* m) {
  static_assert(LOG_W >= LOG_E && (1 << (LOG_W - LOG_E)) <= CTA, "a window in one CTA");
  m->kernel = (const void*)merge_sort_windows_kernel<LOG_W, LOG_E, CTA, MIN_CTAS>;
  m->threads = CTA;
  m->per_cta = CTA >> (LOG_W - LOG_E);
  m->smem = m->per_cta * merge_slots(LOG_W, LOG_E) * Packed96::kBytes;
  return cudaFuncSetAttribute(m->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, m->smem);
}

// The merge sort's shape at W = 2^log2w in [16, 16384], picked per W by
// timing on an H100: E = 8 up to W = 128, 16 up to 1024, then 32 (the
// search and the global accesses fall per element as E grows; registers
// cap it at 32); CTAs of 128 threads (more CTAs an SM), one window of W / 32
// threads from W = 8192 (2 and 1 CTAs an SM at the 128-register cap of E =
// 32, 101 and 203 KB of shared memory)
cudaError_t merge_config(int log2w, MergeLaunch* m) {
  switch (log2w) {
    case 4: return merge_setup<4, 3, 128, 8>(m);
    case 5: return merge_setup<5, 3, 128, 8>(m);
    case 6: return merge_setup<6, 3, 128, 8>(m);
    case 7: return merge_setup<7, 3, 128, 8>(m);
    case 8: return merge_setup<8, 4, 128, 7>(m);
    case 9: return merge_setup<9, 4, 128, 7>(m);
    case 10: return merge_setup<10, 4, 128, 7>(m);
    case 11: return merge_setup<11, 5, 128, 4>(m);
    case 12: return merge_setup<12, 5, 128, 4>(m);
    case 13: return merge_setup<13, 5, 256, 2>(m);
    case 14: return merge_setup<14, 5, 512, 1>(m);
  }
  return cudaErrorInvalidValue;
}

// Launch `m` over num_w windows, a CTA per m.per_cta of them
cudaError_t merge_launch(const MergeLaunch& m, const void* bucket, const void* keys, int num_w,
                         void* perm, void* bucket_out, cudaStream_t stream) {
  void* args[] = {(void*)&bucket, (void*)&keys, (void*)&num_w, (void*)&perm, (void*)&bucket_out};
  cudaError_t err = cudaLaunchKernel(m.kernel, dim3((num_w + m.per_cta - 1) / m.per_cta),
                                     dim3(m.threads), args, m.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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
    case 1: return launch_small<Packed32, int, 1>(bucket, keys, num_w, perm, bucket_out, s);
    case 2: return launch_small<Packed32, int, 2>(bucket, keys, num_w, perm, bucket_out, s);
    case 3: return launch_small<Packed32, int, 3>(bucket, keys, num_w, perm, bucket_out, s);
    case 14:
      return launch_windows<Packed32, int, 5, 512, 1>(bucket, keys, num_w, log2w, perm,
                                                     bucket_out, s);
    default:
      if (log2w < 4 || log2w > 14 || W != 1 << log2w) return cudaErrorInvalidValue;
      return launch_windows<Packed32, int, 4, 512, 2>(bucket, keys, num_w, log2w, perm,
                                                     bucket_out, s);
  }
}

// The same with int64 keys ((num_w, W) int64, 16-byte aligned): the merge
// sort of `merge_config` from W = 16, one thread a window below
int bitonic_sort_windows64(const void* bucket, const void* keys, int num_w, int W,
                           int log2w, void* perm, void* bucket_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2w) {
    case 1: return launch_small<Packed96, long long, 1>(bucket, keys, num_w, perm, bucket_out, s);
    case 2: return launch_small<Packed96, long long, 2>(bucket, keys, num_w, perm, bucket_out, s);
    case 3: return launch_small<Packed96, long long, 3>(bucket, keys, num_w, perm, bucket_out, s);
  }
  if (log2w < 4 || log2w > 14 || W != 1 << log2w) return cudaErrorInvalidValue;
  MergeLaunch m;
  cudaError_t err = merge_config(log2w, &m);
  if (err != cudaSuccess || num_w == 0) return err;
  return merge_launch(m, bucket, keys, num_w, perm, bucket_out, s);
}

// The 64-bit form's launch at W = 2^log2w, from the CUDA runtime: out[0..5]
// = registers a thread, static and dynamic shared memory a CTA in bytes,
// threads a CTA, CTAs an SM holds at once, local memory a thread in bytes
int bitonic_sort_windows64_info(int log2w, int* out) {
  MergeLaunch m{nullptr, kSmallCta, 0, 0};
  cudaError_t err = cudaSuccess;
  switch (log2w) {
    case 1: m.kernel = (const void*)sort_small_windows_kernel<Packed96, long long, 1>; break;
    case 2: m.kernel = (const void*)sort_small_windows_kernel<Packed96, long long, 2>; break;
    case 3: m.kernel = (const void*)sort_small_windows_kernel<Packed96, long long, 3>; break;
    default:
      if (log2w < 4 || log2w > 14) return cudaErrorInvalidValue;
      err = merge_config(log2w, &m);
  }
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, m.kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], m.kernel, m.threads,
                                                           m.smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = m.smem;
  out[3] = m.threads;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // extern "C"
