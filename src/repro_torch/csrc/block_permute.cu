// K8 permute_blocks_by_dest: move block i of an array to slot dst[i], in
// place in the caller's buffer, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `permute_blocks_by_dest` in
// src/repro/kernels/block_permute.py (:145, kernel :64): N full blocks of
// `block_bytes` each move along the cycles of the permutation dst, with no
// second n-sized buffer.  A trailing partial block is never touched (the
// wrapper passes only the N full blocks).  Bytes move as 16-byte words,
// whatever the element type.
//
// Bound: bytes.  Each block is read once and written once: 2 x N x
// block_bytes, 0.64 ms for 1 GiB at 3.35 TB/s.  What keeps a chain from
// that rate is the latency of each step (a claim and a block read), so the
// design keeps many cheap chains in flight (~2,100 at 4 KB blocks) and
// takes all waiting but one round trip off each step.  With that many in
// flight the steps queue at the memory: what is left between this kernel
// and `index_select` (~10% on the H100) is the memory's rate for a read
// and a write of the same random 4 KB slot against random reads and
// sequential writes; more chains did not move it.  The block moves carry
// the streaming cache hint (each byte is touched once).
//
// Design.  Since dst is explicit, the output does not depend on the order
// of the moves, so the cycles are cut into chains that teams of threads
// follow at once.  A team is one warp for blocks up to 4 KB, holding its
// block in registers (8 16-byte words a lane at 4 KB), or, for larger
// blocks, a CTA of up to 29 warps, 8 words a lane, holding its block in its
// shared memory (registers would cap a 1024-thread CTA at 64 a thread) and
// synchronised by a named barrier.
// Every slot has a state (state[], N ints of scratch, zeroed by the
// wrapper): unread, start (claimed as a chain's start, being read), read
// (a start that has been read), chain (claimed by the chain that carries
// its block in).
//   - A team claims a start: one atomicAdd on a global cursor hands it a
//     batch of 32 slots; the lanes read their states at once, and lane 0
//     CASes the first unread one (unread -> start).  Slots it passed over
//     were claimed by someone; the rest of the batch stays the team's for
//     its next start, so no unread slot is skipped.
//   - It reads the start's block into registers, fences, and marks it read.
//     It now holds the block destined for d = dst[s].
//   - Each step: lane 0 CASes d (unread -> chain) and every lane loads
//     dst[d] and its words of d's block, all at once (8 loads of 16 bytes a
//     lane in flight from 4 KB blocks up).  Won: each lane writes its held
//     words into d (the same lane read those words of d just before, so
//     program order keeps the read first) and carries d's block on to
//     dst[d].  No barrier, fence or read mark: with a permutation nobody
//     else ever writes into d.  Lost: d is a start (another team's, or the
//     chain's own); the team waits while d is being read, then writes the
//     held block into d and claims a new start.
// Each slot is claimed, so read, exactly once before the one block destined
// for it is written there.  A team only waits on a slot in state start,
// whose claimer reads it and marks it without waiting on anything: no cycle
// of waits.  A dst that is not a permutation cannot hang the kernel either:
// a team stops a chain at a slot outside [0, N), and a slot in state chain
// is never waited on.
#include <cuda_runtime.h>

namespace {

constexpr int kUnread = 0;
constexpr int kStart = 1;
constexpr int kRead = 2;
constexpr int kChain = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpCta = 128;  // CTAs of the one-warp teams: 4 teams each
constexpr int kBatch = 32;     // start slots handed out per cursor step

__device__ __forceinline__ int load_volatile(const int* p) { return *(const volatile int*)p; }

// a team of one warp: lane 0 leads, shuffles broadcast
struct WarpTeam {
  __device__ explicit WarpTeam(int*) {}
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ int bcast(int x) { return __shfl_sync(kFull, x, 0); }
  __device__ void sync() { __syncwarp(); }
};

// a team of the whole CTA: thread 0 leads, a double-buffered shared word
// and named barrier 1 broadcast (one barrier per broadcast: a slot is
// written again only two broadcasts later, after everyone has read it)
struct CtaTeam {
  int* slot;
  int parity = 0;
  __device__ explicit CtaTeam(int* s) : slot(s) {}
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() { asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x) : "memory"); }
  __device__ int bcast(int x) {
    if (threadIdx.x == 0) slot[parity] = x;
    sync();
    x = slot[parity];
    parity ^= 1;
    return x;
  }
};

template <bool kCta> struct TeamOf { using type = WarpTeam; };
template <> struct TeamOf<true> { using type = CtaTeam; };

// The next start slot for a team, claimed by lanes of one warp (all 32
// lanes call it); nblocks when none is left.  base and pending (a bitmask
// over base + [0, 32)) are the team's batch between calls.
__device__ int claim_start(int* state, int* cursor, int nblocks, int& base,
                           unsigned& pending) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    if (pending == 0) {
      int b0 = 0;
      if (lane == 0) b0 = atomicAdd(cursor, kBatch);
      base = __shfl_sync(kFull, b0, 0);
      if (base >= nblocks) return nblocks;
      const int left = nblocks - base;
      pending = left >= 32 ? kFull : (1u << left) - 1;
    }
    const bool unread =
        (pending >> lane & 1) && load_volatile(&state[base + lane]) == kUnread;
    const unsigned m = __ballot_sync(kFull, unread);
    if (m == 0) {  // the whole batch was claimed by chains
      pending = 0;
      continue;
    }
    const int bit = __ffs(m) - 1;
    pending &= bit == 31 ? 0u : kFull << (bit + 1);
    int old = 0;
    if (lane == 0) old = atomicCAS(&state[base + bit], kUnread, kStart);
    if (__shfl_sync(kFull, old, 0) == kUnread) return base + bit;
  }
}

// WPL 16-byte words a thread moves: a one-warp team holds them in
// registers; a CTA team holds the block in its shared memory (registers
// would cap its threads at 64 and spill).  Either way every lane has all
// WPL loads of the next block in flight at once.
template <int WPL, bool kCta>
__global__ void __launch_bounds__(kCta ? 1024 : kWarpCta)
permute_by_dest_kernel(uint4* __restrict__ a, const int* __restrict__ dst,
                       int* __restrict__ state, int* __restrict__ cursor, int nblocks,
                       int words) {
  extern __shared__ uint4 held_s[];  // the CTA team's block
  __shared__ int slot[2];
  typename TeamOf<kCta>::type team(slot);
  const int rank = team.rank(), size = team.size();
  int base = 0;
  unsigned pending = 0;
  uint4 held[kCta ? 1 : WPL];
  for (;;) {
    int s = nblocks;
    if (threadIdx.x < 32 || !kCta) s = claim_start(state, cursor, nblocks, base, pending);
    s = team.bcast(s);
    if (s >= nblocks) return;
    const uint4* src = a + (long long)s * words;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int w = rank + i * size;
      if (w < words) {
        if constexpr (kCta) {
          held_s[w] = __ldcs(src + w);
        } else {
          held[i] = __ldcs(src + w);
        }
      }
    }
    int d = __ldg(&dst[s]);
    __threadfence();  // the start's words are read before it is marked read
    team.sync();
    if (rank == 0) atomicExch(&state[s], kRead);
    for (;;) {
      if ((unsigned)d >= (unsigned)nblocks) break;  // not a permutation: drop it
      uint4* to = a + (long long)d * words;
      const int next = __ldg(&dst[d]);
      int old = kUnread;
      if (rank == 0) old = atomicCAS(&state[d], kUnread, kChain);
      uint4 in[WPL];  // d's words, read before the claim is known
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = rank + i * size;
        if (w < words) in[i] = __ldcs(to + w);
      }
      const bool won = team.bcast(old) == kUnread;
      if (!won) {  // d is a start: wait until it is read, then drop the block there
        if (rank == 0) {
          while (load_volatile(&state[d]) == kStart) __nanosleep(32);
          __threadfence();
        }
        team.sync();
      }
      // each lane writes the words of d it read just before (program order
      // keeps the read first) and, if it won, keeps d's block
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = rank + i * size;
        if (w < words) {
          if constexpr (kCta) {
            __stcs(to + w, held_s[w]);
            held_s[w] = in[i];
          } else {
            __stcs(to + w, held[i]);
            held[i] = in[i];
          }
        }
      }
      if (!won) break;
      d = next;
    }
  }
}

struct Variant {
  const void* fn;
  int threads;  // per CTA
  int teams;    // per CTA
  int smem;     // dynamic shared memory per CTA
};

// the kernel for a team of `warps` warps moving `wpl` words a lane; the
// wrapper's team_shape() picks them
bool variant(int warps, int wpl, int words, Variant* v) {
  v->smem = 0;
  if (warps == 1) {
    v->threads = kWarpCta;
    v->teams = kWarpCta / 32;
    switch (wpl) {
      case 1: v->fn = (const void*)permute_by_dest_kernel<1, false>; return true;
      case 2: v->fn = (const void*)permute_by_dest_kernel<2, false>; return true;
      case 4: v->fn = (const void*)permute_by_dest_kernel<4, false>; return true;
      case 8: v->fn = (const void*)permute_by_dest_kernel<8, false>; return true;
      default: return false;
    }
  }
  if (wpl != 8 || warps < 2 || warps > 32) return false;
  v->threads = warps * 32;
  v->teams = 1;
  v->smem = words * (int)sizeof(uint4);
  v->fn = (const void*)permute_by_dest_kernel<8, true>;
  return cudaFuncSetAttribute(v->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, v->smem) ==
         cudaSuccess;
}

// CTAs of a persistent grid: as many as fit the card, no more teams than blocks
cudaError_t grid(const Variant& v, int nblocks, int* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, v.threads, v.smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int needed = (nblocks + v.teams - 1) / v.teams;
  *ctas = needed < sms * per_sm ? needed : sms * per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* block_permute_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: N blocks of `words` 16-byte words (16-byte aligned); dst: (N,) int32, a
// permutation of [0, N); scratch: N + 1 zeroed ints (the slot states and the
// cursor); a team of `warps` warps holding `wpl` words a lane, with
// warps * 32 * wpl >= words.
int block_permute_by_dest(void* a, const void* dst, void* scratch, int nblocks, int words,
                          int warps, int wpl, void* stream) {
  Variant v;
  if (warps * 32 * wpl < words || !variant(warps, wpl, words, &v)) return cudaErrorInvalidValue;
  if (nblocks <= 1 || words <= 0) return cudaSuccess;
  int ctas = 0;
  cudaError_t err = grid(v, nblocks, &ctas);
  if (err != cudaSuccess) return err;
  int* state = (int*)scratch;
  int* cursor = state + nblocks;
  void* args[] = {&a, (void*)&dst, &state, &cursor, &nblocks, &words};
  err = cudaLaunchKernel(v.fn, dim3(ctas), dim3(v.threads), args, (size_t)v.smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch for that team and N blocks of `words` words: out[0] registers
// per thread, out[1] local memory per thread (spills) in bytes, out[2]
// threads per CTA, out[3] CTAs, out[4] teams (chains in flight), out[5]
// dynamic shared memory per CTA in bytes.
int block_permute_info(int nblocks, int words, int warps, int wpl, int* out) {
  Variant v;
  if (!variant(warps, wpl, words, &v)) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, v.fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  if ((err = grid(v, nblocks, &ctas)) != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = v.threads;
  out[3] = ctas;
  out[4] = ctas * v.teams;
  out[5] = v.smem;
  return cudaSuccess;
}

}  // extern "C"
