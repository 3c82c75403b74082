// K5 merge_path_perm: the stable 2-way merge permutation, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `merge_path_perm` in
// src/repro/kernels/merge_path.py:157 (with its XLA diagonal search
// `merge_path_partition`, :76, and the in-tile bitonic merger, :130): for
// two sorted runs a (nA,) and b (nB,) of encoded keys, int32 (the codes of
// keys of 32 bits or fewer) or int64 (the 64-bit key dtypes' codes), it
// writes perm (nA+nB,) int32 with cat(a, b)[perm] the stable merge -- ties
// go to a, and each run keeps its own order.  perm holds i for a[i] and
// nA + j for b[j].  One template over the key word (`int`, `long long`);
// the reference takes any dtype and tiles by its width (merge_rows,
// merge_path.py:69).
//
// Bound: bytes.  Each output reads one key (4 or 8 B) and writes one
// source (4 B): 8 B per output for int32 codes, ~80 us for 2^25 outputs at
// 3.35 TB/s, and 12 B for int64 codes, ~120 us.  The work is a compare and
// a select per output plus one short search per thread: far below the
// integer rate.
//
// What held the first design back (0.27 ms at 2^24 + 2^24 on an H100, 30% of
// the bound): one CTA per 2048 outputs, and before it loaded anything two
// of its threads ran a ~25-step binary search over device memory, each
// step waiting on the one before, while 254 threads waited at a barrier;
// then 4-byte window loads from unaligned starts, an 11-step search per
// thread for 8 outputs, and source stores at a stride of 8 words across
// the warp (an 8-way bank conflict).
//
// Design.  One persistent kernel a call.  The grid holds as many CTAs as
// the SMs hold at once, and each CTA merges a contiguous run of tiles of T
// outputs (T = 2048 by default: 256 threads of 8 outputs; a caller's tile
// above 8192 runs as steps of 8192, whose two stages fill shared memory).
//
// - The cuts.  Only a CTA's first cut is searched in device memory, and by
//   a whole warp: for its first diagonal d = t * T, the largest i in
//   [max(0, d-nB), min(d, nA)] with a[i-1] <= b[d-i] (the stable tie rule,
//   the reference's condition).  The warp probes 32 candidates a step and
//   keeps the gap between the last true and the first false probe (a
//   ballot), so a span of 2^24 closes in 5 dependent steps instead of 25;
//   its first steps probe only multiples of T, whose keys (a[mT - 1],
//   b[(t - m)T]) all CTAs share in the L2.  Every later cut is found in
//   shared memory: a tile's stage holds the next T keys of both runs from
//   the tile's heads (ia, ja), which hold every key its T outputs can take,
//   so one warp finds the tile's end cut there (32 probes a step, 3 steps
//   at T = 2048).
// - The loads.  With the end cut known, that warp at once asks for the
//   next tile's stage, from the new heads, as two TMA bulk copies
//   (`cp.async.bulk`, from the windows' starts rounded down to 16 B to
//   their ends rounded up: a piece, 4 int32 or 2 int64 keys, that holds one
//   key of a run lies inside its allocation) completing on the stage's mbarrier, while the tile
//   merges.  The keys of a stage past the tile's end cut are the next
//   tile's first, read again from the L2.  (Prefetching the stage after
//   next into the L2 as well, `cp.async.bulk.prefetch.L2`, made the kernel
//   slower.)
// - The merge.  Each thread finds its sub-diagonal in the stage by a short
//   binary search and merges PER outputs into registers, taking a when
//   a <= b.  The sources go through a shared transpose padded by one word
//   in 32 (thread t's output r at slot o + o/32, o = t * PER + r: no bank
//   conflict on the write, nor on the read of four consecutive slots a
//   thread) and out as 16-byte stores.
//
// Keys compare as signed ints: the port's codes are the reference's
// unsigned codes with the sign bit flipped.  NaN encodes to INT_MAX
// (LLONG_MAX for doubles), the value a sentinel pad would hold, so there
// are no pads: every read is bounds-checked against the true run lengths
// instead.  The TPU kernel's
// bitonic merger, which sorts 2T (key, src) pairs padded to the tile, has
// no reason to exist here: a thread's sequential merge is branch-light and
// does T outputs' work, not T log T.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // the CTA width at T >= 2048
// outputs a CTA merges at a step, by key bytes: two stages fit
constexpr int kMaxStep = 8192;
constexpr int kMaxStep64 = 4096;
constexpr int kDevices = 16;      // devices whose resident CTAs are remembered

// One warp: the largest c in [lo, hi] with pred(c), where pred(lo) is taken
// to hold and pred is monotone (true, then false).  32 probes a step.
template <class Pred>
__device__ __forceinline__ int warp_search(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int span = hi - lo;
    auto probe = [&](int l) {  // strictly rising in l; probe(31) = hi at spans >= 32
      return lo + (span >= 32 ? (int)(((long long)(l + 1) * span) >> 5) : l + 1);
    };
    const int mine = probe(lane);
    const unsigned yes = __ballot_sync(0xffffffffu, mine <= hi && pred(mine));
    const int c = __popc(yes);  // the true probes are lanes [0, c)
    const int first_false = probe(c);
    if (c > 0) lo = probe(c - 1);
    if (c < 32 && first_false <= hi) hi = first_false - 1;
  }
  return lo;
}

// The number of a-keys among the first d outputs of the stable merge, by
// one warp in device memory; s divides d (the first steps probe multiples
// of s only).
template <class K>
__device__ int warp_cut(const K* __restrict__ a, int na, const K* __restrict__ b,
                        int nb, int d, int s) {
  const int lo = max(0, d - nb);
  const int hi = min(d, na);
  auto q = [&](int i) { return __ldg(a + i - 1) <= __ldg(b + d - i); };  // i in (lo, hi]
  const int m = warp_search(lo / s, hi / s, [&](int m) { return q(m * s); });
  return warp_search(max(lo, m * s), min(hi, m * s + s - 1), q);
}

// The number of a-keys among the first d outputs of the windows' merge, by
// one thread (a binary search in shared memory).
template <class K>
__device__ __forceinline__ int thread_cut(const K* sa, int la, const K* sb,
                                          int lb, int d) {
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;  // in (lo, hi]: sa[mid-1], sb[d-mid] exist
    if (sa[mid - 1] <= sb[d - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

__device__ __forceinline__ void bulk_copy(uint32_t dst, uintptr_t src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A window's 16-byte pieces: from x + start rounded down to 16 B up to
// x + start + len rounded up.
template <class K>
struct Window {
  uintptr_t first;  // address of the first piece
  int pieces;       // 16-byte pieces (0 for an empty window)
  int skip;         // keys before the window's first in its first piece
  __device__ Window(const K* x, int start, int len) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(x + start);
    first = lo & ~(uintptr_t)15;
    skip = (int)((lo - first) / sizeof(K));
    pieces = len > 0 ? (int)((((lo + sizeof(K) * (uintptr_t)len + 15) & ~(uintptr_t)15) -
                              first) >> 4)
                     : 0;
  }
};

// Shared layout: two stages of stage_bytes (up to T keys of a from the
// tile's head, then up to T of b, each with its 16-byte slack), then the
// padded transpose of T + T/32 + 1 ints.
__host__ __device__ __forceinline__ int stage_bytes(int tile, int key_bytes) {
  return 2 * ((tile * key_bytes + 15) & ~15) + 64;
}

template <class K, int PER>
__global__ void __launch_bounds__(kMaxThreads)
    merge_kernel(const K* __restrict__ a, int na, const K* __restrict__ b, int nb,
                 int tile, int num_tiles, int* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ int s_cut[2];
  const int sbytes = stage_bytes(tile, (int)sizeof(K));
  int* s_out = reinterpret_cast<int*>(smem + 2 * sbytes);
  const int n = na + nb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this CTA's contiguous run of tiles [t0, t1)
  const int share = num_tiles / gridDim.x;
  const int extra = num_tiles % gridDim.x;
  const int t0 = blockIdx.x * share + min((int)blockIdx.x, extra);
  const int t1 = t0 + share + ((int)blockIdx.x < extra ? 1 : 0);

  // the stage of the tile with heads (ia, ja): the next T keys of each run
  auto load = [&](int stage, int ia, int ja) {
    const Window<K> wa(a, ia, min(tile, na - ia)), wb(b, ja, min(tile, nb - ja));
    const uint32_t bar = smem_u32(&bars[stage]);
    const uint32_t dst = smem_u32(smem + stage * sbytes);
    // the stage's last reads (generic proxy) before the copies' writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 16 * (wa.pieces + wb.pieces));
    if (wa.pieces) bulk_copy(dst, wa.first, 16 * wa.pieces, bar);
    if (wb.pieces) bulk_copy(dst + 16 * wa.pieces, wb.first, 16 * wb.pieces, bar);
  };

  if (warp == 0) {  // the only search in device memory: this CTA's first cut
    const int cut = warp_cut(a, na, b, nb, t0 * tile, tile);
    if (lane == 0) {
      mbar_init(smem_u32(&bars[0]));
      mbar_init(smem_u32(&bars[1]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      load(0, cut, t0 * tile - cut);
      s_cut[1] = cut;
    }
  }
  __syncthreads();
  int ia = s_cut[1];
  int ja = t0 * tile - ia;
  __syncthreads();  // s_cut[1] is free again

  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const int d0 = t * tile;
    const int len = min(tile, n - d0);
    const int la = min(tile, na - ia), lb = min(tile, nb - ja);  // the stage's keys
    const Window<K> wa(a, ia, la), wb(b, ja, lb);
    const K* stage = reinterpret_cast<const K*>(smem + (it & 1) * sbytes);
    const K* sa = stage + wa.skip;
    const K* sb = stage + 16 / (int)sizeof(K) * wa.pieces + wb.skip;
    mbar_wait(smem_u32(&bars[it & 1]), (it >> 1) & 1);

    if (warp == 0 && t + 1 < t1) {  // the tile's end cut, then the next stage
      const int end = warp_search(max(0, len - lb), min(len, la),
                                  [&](int i) { return sa[i - 1] <= sb[len - i]; });
      if (lane == 0) {
        s_cut[it & 1] = end;
        load((it + 1) & 1, ia + end, ja + len - end);
      }
    }

    const int lo = min((int)threadIdx.x * PER, len);
    int i = thread_cut(sa, la, sb, lb, lo);
    int j = lo - i;
    K ka = i < la ? sa[i] : 0;
    K kb = j < lb ? sb[j] : 0;
    int src[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      // past the tile's end nothing is stored; the stage's bounds keep the reads inside
      const bool take_a = i < la && (j >= lb || ka <= kb);
      src[r] = take_a ? ia + i : na + ja + j;
      if (take_a) {
        ++i;
        ka = i < la ? sa[i] : 0;
      } else {
        ++j;
        kb = j < lb ? sb[j] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int o = threadIdx.x * PER + r;
      if (o < len) s_out[o + (o >> 5)] = src[r];
    }
    __syncthreads();  // the transpose and the end cut are written

    int* out = perm + d0;
    int o = 0;
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      const int quads = len >> 2;
      for (int v = threadIdx.x; v < quads; v += blockDim.x) {
        const int* s = s_out + 4 * v + (v >> 3);  // (4v + q) / 32 = v / 8 for q < 4
        *reinterpret_cast<int4*>(out + 4 * v) = make_int4(s[0], s[1], s[2], s[3]);
      }
      o = 4 * quads;
    }
    for (o += threadIdx.x; o < len; o += blockDim.x) out[o] = s_out[o + (o >> 5)];
    const int end = s_cut[it & 1];
    ia += end;
    ja += len - end;
    __syncthreads();  // the transpose is read
  }
}

// The outputs a CTA merges at a step: the caller's tile up to kMaxStep
// (kMaxStep64 for int64 keys; a larger tile runs as steps of that, which
// changes nothing in perm).
int step_of(int tile, int key_bytes) {
  const int top = key_bytes == 8 ? kMaxStep64 : kMaxStep;
  return tile < top ? tile : top;
}

// The merge's outputs per thread at a step: 8 at T in [8, 2048], T / 256
// above (so at most 256 threads), T below.
int outputs_per_thread(int tile) {
  return tile >= 2048 ? tile / kMaxThreads : (tile < 8 ? tile : 8);
}

template <class K>
using MergeKernel = void (*)(const K*, int, const K*, int, int, int, int*);

template <class K>
MergeKernel<K> merge_kernel_for(int per) {
  switch (per) {
    case 1: return merge_kernel<K, 1>;
    case 2: return merge_kernel<K, 2>;
    case 4: return merge_kernel<K, 4>;
    case 8: return merge_kernel<K, 8>;
    case 16: return merge_kernel<K, 16>;
    case 32: return merge_kernel<K, 32>;
    default: return nullptr;
  }
}

// The kernel at a step of T outputs, its threads and dynamic shared bytes,
// with the attribute set.
template <class K>
cudaError_t merge_setup(int tile, MergeKernel<K>* kernel, int* threads, int* smem) {
  const int per = outputs_per_thread(tile);
  *kernel = merge_kernel_for<K>(per);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  *threads = tile / per < 32 ? 32 : tile / per;  // a whole warp: the cut searches are a warp's
  *smem = 2 * stage_bytes(tile, (int)sizeof(K)) + (tile + tile / 32 + 1) * (int)sizeof(int);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// perm (na+nb,) of the stable merge of sorted a (na,) and b (nb,) of K
// keys; one launch.
template <class K>
int merge_perm(const K* a, int na, const K* b, int nb, int tile, int* perm,
               cudaStream_t stream) {
  constexpr int wide = sizeof(K) == 8 ? 1 : 0;
  tile = step_of(tile, (int)sizeof(K));
  MergeKernel<K> kernel;
  int threads, smem;
  cudaError_t err = merge_setup<K>(tile, &kernel, &threads, &smem);
  if (err != cudaSuccess) return err;
  const long long num_tiles = ((long long)na + nb + tile - 1) / tile;
  if (num_tiles == 0) return cudaSuccess;
  if (num_tiles >= INT_MAX) return cudaErrorInvalidConfiguration;
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  // the CTAs the card holds at once, per device, key width and tile: asked once
  static int resident_ctas[kDevices][2][14];
  const int log_tile = 31 - __builtin_clz(tile);
  int resident = device < kDevices ? resident_ctas[device][wide][log_tile] : 0;
  if (resident == 0) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                             smem)) != cudaSuccess)
      return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kDevices) resident_ctas[device][wide][log_tile] = resident;
  }
  const long long grid = num_tiles < resident ? num_tiles : resident;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(a, na, b, nb, tile, (int)num_tiles, perm);
  return cudaGetLastError();
}

template <class K>
int merge_info(int tile, int* out) {
  tile = step_of(tile, (int)sizeof(K));
  MergeKernel<K> kernel;
  int threads, smem;
  cudaError_t err = merge_setup<K>(tile, &kernel, &threads, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = threads;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* merge_path_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// perm (na+nb,) of the stable merge of sorted int32 a (na,) and b (nb,);
// tile is a power of two in [1, 16384], 0 < na, nb and na + nb < 2^30 (the
// wrapper checks all three).  One launch.
int merge_path_perm(const void* a, int na, const void* b, int nb, int tile,
                    void* perm, void* stream) {
  return merge_perm<int>((const int*)a, na, (const int*)b, nb, tile, (int*)perm,
                         (cudaStream_t)stream);
}

// The same for int64 a and b; tile is a power of two in [1, 8192].
int merge_path_perm64(const void* a, int na, const void* b, int nb, int tile,
                      void* perm, void* stream) {
  return merge_perm<long long>((const long long*)a, na, (const long long*)b, nb, tile,
                               (int*)perm, (cudaStream_t)stream);
}

// The kernel's launch at a tile for keys of key_bytes (4 or 8), from the
// CUDA runtime: out[0] registers per thread, out[1] static and out[2]
// dynamic shared memory per CTA in bytes, out[3] threads per CTA, out[4]
// CTAs an SM holds at once, out[5] local memory per thread (spills) in
// bytes.
int merge_path_info(int tile, int key_bytes, int* out) {
  if (key_bytes == 8) return merge_info<long long>(tile, out);
  if (key_bytes == 4) return merge_info<int>(tile, out);
  return cudaErrorInvalidValue;
}

}  // extern "C"
