// K6 stable counting placement (dispatch_ranks, partition_ranks,
// partition_ranks_batched), by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/dispatch_rank.py:
// `dispatch_ranks` (:87, MoE experts), `partition_ranks` (:154, nb buckets)
// and `partition_ranks_batched` (:224, per row).  The three share one
// contract, so here they are one kernel with a row dimension: for `rows`
// rows of n ids,
//   dest[row, i] = start[row, b] + #{j < i : id[row, j] == b},  b = id[row, i],
// for ids in [0, nb), nb <= 4096.  Other ids (the trash id nb the reference
// pads with) never touch a counter and get dest -1.  Starts need not be a
// prefix; rows are independent; rows * n < 2^31.
//
// Bound: bytes.  4 B of id read and 4 B of dest written per element: 8 B,
// ~30 us for 12.6M ids at 3.35 TB/s.  The work per element (an atomicOr, a
// few shared-memory reads, two popcounts) is far below the integer rate.
//
// Design: one pass, one launch after one memset, the ids read once.  The
// TPU kernel carries running counters across its sequential grid; CTAs here
// run in any order, so the count of the earlier tiles is carried by
// decoupled look-back (Merrill & Garland 2016), per (row, id) as in Onesweep
// (Adinets & Merrill 2022).
//   - Tiles of `tile` ids are handed out in order by a ticket from one
//     atomic counter (zeroed by the memset), so a CTA only ever waits on
//     tiles handed out before its own, whatever order the CTAs run in.  The
//     grid is persistent (the CTAs the card holds at once).
//   - The in-tile rank is K1's (level_fused.cu): a warp per 512 positions,
//     every load of a lane in flight before it ranks, the lanes holding one
//     id found by one shared-memory atomicOr a lane into a per-warp mask
//     per id (cleared by the group's lowest lane; __match_any_sync costs
//     more the more distinct ids a warp holds), 16-bit per-warp counters,
//     the rank in registers, then an exclusive scan over the warps whose
//     total is the tile's count per id, published at once.
//   - Status words, one per (tile, id), 32 bits: 0 until published, then
//     1 + the tile's count ("aggregate": at most the tile, so below 2^15),
//     or 2^31 | the count of the row's tiles up to and including it
//     ("prefix": below 2^31, since rows * n < 2^31).  So any count the
//     contract allows fits beside the flag; 2 flag bits and a 30-bit count
//     would not.  Words are written and read relaxed at GPU scope: each
//     carries its own payload, and an aligned 32-bit access is single-copy
//     atomic, so no other memory needs ordering.
//   - The look-back is deferred by one tile: a CTA ranks tile t + 1 and
//     publishes its count before it looks back for tile t, so the earlier
//     tiles' counts are out by then and it seldom waits; tile t's packed
//     ranks wait in shared memory.  Meanwhile the ids of the next tile and
//     the ticket after it are in flight.  A CTA holds those tickets while
//     it looks back; a look-back that waited would hold up their counts
//     and chain the waits across CTAs, and the deferral is what keeps it
//     from waiting.
//   - The whole CTA looks back: per round, a thread reads 8 words (one id,
//     8 earlier tiles), a warp's loads fall on neighbouring ids of one
//     tile, and ids with blockDim / nb threads read that many windows.  An
//     id stops at a prefix, or waits at a word not yet published.  On the
//     H100 the look-back costs about its fixed part, a round trip and the
//     CTA's barriers: the window size hardly moved the time (4 to 12 words
//     a thread at tiles of 8192), and 16 words spilled registers.  Tiles of
//     8192 ids (16 warps) are the default: at 4096 a CTA of 256 threads
//     looks back for nb = 257 ids in two passes.
//   - dest = start + the earlier tiles' count + the rank in the tile,
//     stored in position order, so the stores coalesce.
// The scratch is a ticket and rows x tiles x nb status words (4 B each,
// 0.4-1.6% of the ids' and dests' bytes at the main path's shapes).
// Shared memory per CTA: per id two tiles' counts and a base (12 B), per
// warp and id a mask and a counter (6 B), two tiles of packed ranks and
// the look-back's rounds (16 B a thread): at nb = 4096, 6 warps (tiles of
// 3072).
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kChunks = 16;          // 32-position chunks a lane holds
constexpr int kSpan = 32 * kChunks;  // positions a warp ranks
constexpr int kMaxThreads = 1024;
constexpr int kWindow = 8;           // status words a thread of the look-back reads at once
constexpr int kIdBits = 13;          // a packed position: id | rank << 13
constexpr int kNone = (1 << kIdBits) - 1;  // no id: trash, or past the tile
constexpr unsigned kPrefixBit = 0x80000000u;
constexpr int kHeader = 16;          // the ticket's bytes at the head of the scratch
constexpr int kDevices = 16;

// A status word: 0 until published; then 1 + the tile's own count (the
// aggregate, at most the tile, so below 2^15), or kPrefixBit | the count of
// the row's tiles up to and including it (the prefix, below 2^31).
__device__ __forceinline__ void publish(unsigned* word, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(word), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned peek(const unsigned* word) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(word));
  return v;
}

// The positions [lo, hi) of this warp in a tile of `len` ids.
struct Span {
  long long at;  // the tile's first position in the (rows, n) ids
  int row, j, lo, hi;
};

__device__ __forceinline__ Span span_of(int ticket, int n, int tile, int tiles_per_row) {
  Span s;
  s.row = ticket / tiles_per_row;
  s.j = ticket - s.row * tiles_per_row;
  const int col = s.j * tile;
  s.at = (long long)s.row * n + col;
  const int len = min(tile, n - col);
  const int warps = blockDim.x >> 5;
  const int span = (((len + warps - 1) / warps) + 31) & ~31;  // <= kSpan
  s.lo = (threadIdx.x >> 5) * span;
  s.hi = min(s.lo + span, len);
  return s;
}

// every load of the lane's chunks in flight; -1 past the warp's span
__device__ __forceinline__ void load_ids(const int* __restrict__ ids, const Span& s,
                                         int (&v)[kChunks]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = s.lo + 32 * c + lane;
    v[c] = p < s.hi ? __ldg(ids + s.at + p) : -1;
  }
}

// a window's leading published words, up to and including a prefix: their
// sum, and (ready aggregates) | (a prefix found) << 8
__device__ __forceinline__ int summarize(const unsigned (&w)[kWindow], unsigned& part) {
  bool open = true, prefix = false;
  int ready = 0;
  part = 0;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    if (open && w[i] != 0u) {
      if (w[i] & kPrefixBit) {
        part += w[i] & ~kPrefixBit;
        prefix = true, open = false;
      } else {
        part += w[i] - 1u;
        ++ready;
      }
    } else {
      open = false;
    }
  }
  return ready | (prefix ? 1 << 8 : 0);
}

// Tile g's look-back, by the whole CTA: per id, the count over the row's
// earlier tiles, read back from tile g - 1 until a prefix.  Thread t takes
// id b = t mod C and window m = t / C of a chunk of C ids: the 8 words of
// tiles k - 8m, ..., k - 8m - 7, where k is the id's next tile to read,
// so one round trip covers 8 tiles per window of the id, and the loads of
// a warp fall on neighbouring ids of one tile.  Per round the id's first
// thread takes the windows in order: their aggregates, until a prefix (the
// id is done) or a word not yet published (the next round starts there).
// Then the tile's prefix is published and s_base = start + that count.
// lb: 4 x blockDim ints of shared memory.
__device__ void finish_look_back(int g, const int* agg, int* s_base, int* lb,
                                 const int* __restrict__ start, unsigned* __restrict__ status,
                                 int nb, int tiles_per_row) {
  const int row = g / tiles_per_row;
  const int j = g - row * tiles_per_row;
  const int* row_start = start + (long long)row * nb;
  if (j == 0) {  // its prefix is out already
    for (int b = threadIdx.x; b < nb; b += blockDim.x) s_base[b] = row_start[b];
    __syncthreads();
    return;
  }
  const int first = g - j;  // the row's first tile: always a prefix
  const int T = blockDim.x;
  int* s_k = lb;
  unsigned* s_excl = reinterpret_cast<unsigned*>(lb + T);
  unsigned* s_part = reinterpret_cast<unsigned*>(lb + 2 * T);
  int* s_info = lb + 3 * T;
  for (int b0 = 0; b0 < nb; b0 += T) {
    const int C = min(nb - b0, T);
    const int b = (int)threadIdx.x % C;
    const int m = (int)threadIdx.x / C;
    const int windows = (T - b + C - 1) / C;  // the windows of id b: m * C + b < T
    const unsigned* col = status + b0 + b;
    for (int round = 0;; ++round) {
      const int k = round == 0 ? g - 1 : s_k[b];
      if (k >= first) {
        const int top = k - kWindow * m;
        unsigned w[kWindow];
#pragma unroll
        for (int i = 0; i < kWindow; ++i)
          w[i] = top - i >= first ? peek(col + (long long)(top - i) * nb) : 0u;
        unsigned part;
        s_info[threadIdx.x] = summarize(w, part);
        s_part[threadIdx.x] = part;
      }
      __syncthreads();
      bool more = false;
      if (m == 0 && k >= first) {
        unsigned excl = round == 0 ? 0u : s_excl[b];
        int taken = 0;
        bool done = false;
        for (int mm = 0; mm < windows; ++mm) {
          const int info = s_info[mm * C + b];
          excl += s_part[mm * C + b];
          if (info >> 8) {
            done = true;
            break;
          }
          taken += info & 0xff;
          if ((info & 0xff) < kWindow) break;  // a word not yet published
        }
        s_excl[b] = excl;
        s_k[b] = done ? INT_MIN : k - taken;
        more = !done;
        if (!done && taken == 0) __nanosleep(64);  // tile k has not published yet
      }
      if (!__syncthreads_or(more)) break;
    }
    if (m == 0) {
      const unsigned excl = s_excl[b];
      publish(status + (long long)g * nb + b0 + b, kPrefixBit | (excl + (unsigned)agg[b0 + b]));
      s_base[b0 + b] = (int)((unsigned)row_start[b0 + b] + excl);
    }
    __syncthreads();
  }
}

// dest of the pending tile g = s_base + the rank in the tile, from the
// packed ranks in `stage`, stored in position order
__device__ void store_tile(int g, const int* s_base, const int* stage, int n, int tile,
                           int tiles_per_row, int* __restrict__ dest) {
  const int row = g / tiles_per_row;
  const int col = (g - row * tiles_per_row) * tile;
  const long long at = (long long)row * n + col;
  const int len = min(tile, n - col);
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const int x = stage[p];
    const int b = x & kNone;
    dest[at + p] = b == kNone ? -1 : (int)((unsigned)s_base[b] + (unsigned)(x >> kIdBits));
  }
}

// ranks in the warp's span, in position order, packed with the id:
// id | rank << kIdBits, kNone past the span or for an id outside [0, nb)
__device__ __forceinline__ void rank_span(int (&v)[kChunks], const Span& s, int nb,
                                          unsigned* wsame, unsigned short* wcnt) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int b = v[c];
    v[c] = kNone;
    if (s.lo + 32 * c >= s.hi) continue;  // the same for the whole warp
    const bool mine = (unsigned)b < (unsigned)nb;
    if (mine) atomicOr(wsame + b, 1u << lane);  // the lanes holding this id
    __syncwarp();
    const unsigned same = mine ? wsame[b] : 0u;
    const int old = mine ? wcnt[b] : 0;
    __syncwarp();
    if (mine && (same & below) == 0) {  // the group's lowest lane
      wcnt[b] = (unsigned short)(old + __popc(same));
      wsame[b] = 0u;
    }
    __syncwarp();
    if (mine) v[c] = b | ((old + __popc(same & below)) << kIdBits);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    dispatch_rank_kernel(const int* __restrict__ ids, const int* __restrict__ start, int n,
                         int nb, int tile, int tiles_per_row, int total,
                         unsigned* __restrict__ ticket, unsigned* __restrict__ status,
                         int* __restrict__ dest) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  int* s_ticket = smem;
  int* s_agg = smem + kHeader / 4;  // 2 x nb: the counts of the last two tiles ranked
  int* s_base = s_agg + 2 * nb;     // nb: start + the earlier tiles' count
  int* lb = s_base + nb;            // 4 x blockDim: the look-back's rounds
  unsigned* masks = reinterpret_cast<unsigned*>(lb + 4 * blockDim.x);  // warps x nb
  unsigned short* cnt = reinterpret_cast<unsigned short*>(masks + warps * nb);  // warps x nb
  // two tiles' packed ranks: the tile ranked last, the one before it
  int* stage = reinterpret_cast<int*>(cnt + ((warps * nb + 1) & ~1));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < warps * nb; i += blockDim.x) masks[i] = 0u, cnt[i] = 0;
  if (threadIdx.x == 0) {
    s_ticket[0] = (int)atomicAdd(ticket, 1u);
    s_ticket[1] = (int)atomicAdd(ticket, 1u);
  }
  __syncthreads();
  int cur = s_ticket[0], nxt = s_ticket[1];
  if (cur >= total) return;
  unsigned* wsame = masks + warp * nb;
  unsigned short* wcnt = cnt + warp * nb;

  // Each tile's look-back comes after the next tile is ranked and its count
  // published: by then the earlier tiles' counts are out, so it seldom
  // waits.  The next tile's ids are loading all the while.
  int v[kChunks];
  load_ids(ids, span_of(cur, n, tile, tiles_per_row), v);
  int pending = -1, parity = 0;
  for (;;) {
    // in flight while this tile is ranked: the next tile's ids and the
    // ticket after next
    int nv[kChunks];
    if (nxt < total) load_ids(ids, span_of(nxt, n, tile, tiles_per_row), nv);
    unsigned after_ticket = 0;
    if (threadIdx.x == 0) after_ticket = atomicAdd(ticket, 1u);
    const Span s = span_of(cur, n, tile, tiles_per_row);
    rank_span(v, s, nb, wsame, wcnt);
    __syncthreads();
    // per id: the exclusive scan over the warps, whose total the tile publishes
    unsigned* own = status + (long long)cur * nb;
    int* agg = s_agg + parity * nb;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      int run = 0;
      for (int w = 0; w < warps; ++w) {
        const int c = cnt[w * nb + b];
        cnt[w * nb + b] = (unsigned short)run;
        run += c;
      }
      publish(own + b, s.j == 0 ? kPrefixBit | (unsigned)run : 1u + (unsigned)run);
      agg[b] = run;
    }
    if (threadIdx.x == 0) s_ticket[0] = (int)after_ticket;
    __syncthreads();
    const int after = s_ticket[0];
    // the rank in the tile: the warp's start added in, parked in the stage;
    // the warp's counters are free again
    int* slot = stage + parity * warps * kSpan;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p = s.lo + 32 * c + lane;
      if (p < s.hi) slot[p] = v[c] == kNone ? kNone : v[c] + ((int)wcnt[v[c] & kNone] << kIdBits);
    }
    __syncwarp();
    for (int i = lane; i < nb; i += 32) wcnt[i] = 0;
    __syncwarp();
    if (pending >= 0) {
      finish_look_back(pending, s_agg + (parity ^ 1) * nb, s_base, lb, start, status, nb,
                       tiles_per_row);
      // the next writes to this slot and to s_base come after the next
      // tile's barriers
      store_tile(pending, s_base, stage + (parity ^ 1) * warps * kSpan, n, tile,
                 tiles_per_row, dest);
    }
    pending = cur;
    parity ^= 1;
    if (nxt >= total) break;
    cur = nxt;
    nxt = after;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) v[c] = nv[c];
  }
  __syncthreads();  // the stage holds the last tile
  finish_look_back(pending, s_agg + (parity ^ 1) * nb, s_base, lb, start, status, nb,
                   tiles_per_row);
  store_tile(pending, s_base, stage + (parity ^ 1) * warps * kSpan, n, tile, tiles_per_row,
             dest);
}

int smem_bytes(int nb, int warps) {
  return kHeader + nb * (12 + 6 * warps) + ((warps * nb) & 1) * 2 + 2 * warps * kSpan * 4 +
         4 * 4 * 32 * warps;
}

// The kernel's shared memory at (nb, warps), allowed once per device and
// size (the allowance only grows); *resident: the CTAs the card holds at
// once at that shape, asked once per device and shape.
cudaError_t setup(int nb, int warps, int* smem, int* resident) {
  *smem = smem_bytes(nb, warps);
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static int allowed[kDevices], sms_of[kDevices];
  static int shape_smem[kDevices][33], shape_per_sm[kDevices][33];
  const bool cached = device < kDevices;
  if (!cached || *smem > allowed[device]) {
    err = cudaFuncSetAttribute(dispatch_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem);
    if (err != cudaSuccess) return err;
    if (cached) allowed[device] = *smem;
  }
  if (cached && sms_of[device] > 0 && shape_smem[device][warps] == *smem) {
    *resident = sms_of[device] * shape_per_sm[device][warps];
    return cudaSuccess;
  }
  int sms, per_sm;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dispatch_rank_kernel,
                                                           32 * warps, *smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = sms * per_sm;
  if (cached) {
    sms_of[device] = sms;
    shape_smem[device][warps] = *smem;
    shape_per_sm[device][warps] = per_sm;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* dispatch_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dest (rows, n) from ids (rows, n) and start (rows, nb).  tile <= warps *
// 512 ids a ticket, CTAs of 32 * warps threads; scratch holds 16 B and
// rows * ceil(n / tile) * nb 4-byte status words, zeroed here.  One memset,
// one launch.
int dispatch_rank_place(const void* ids, const void* start, int rows, int n, int nb,
                        int tile, int warps, void* scratch, void* dest, void* stream) {
  if (warps < 1 || 32 * warps > kMaxThreads || tile < 1 || tile > warps * kSpan ||
      nb < 1 || nb >= kNone)
    return cudaErrorInvalidValue;
  const long long tiles_per_row = ((long long)n + tile - 1) / tile;
  const long long total = (long long)rows * tiles_per_row;
  if (total == 0) return cudaSuccess;
  if (total > INT_MAX) return cudaErrorInvalidConfiguration;
  int smem, resident;
  cudaError_t err = setup(nb, warps, &smem, &resident);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t scratch_bytes = kHeader + (size_t)total * nb * sizeof(unsigned);
  if ((err = cudaMemsetAsync(scratch, 0, scratch_bytes, s)) != cudaSuccess) return err;
  const long long grid = total < resident ? total : resident;
  unsigned char* base = (unsigned char*)scratch;
  dispatch_rank_kernel<<<(unsigned)grid, 32 * warps, smem, s>>>(
      (const int*)ids, (const int*)start, n, nb, tile, (int)tiles_per_row, (int)total,
      (unsigned*)base, (unsigned*)(base + kHeader), (int*)dest);
  return cudaGetLastError();
}

// The kernel's launch at (nb, warps), from the CUDA runtime: out[0]
// registers per thread, out[1] static and out[2] dynamic shared memory per
// CTA in bytes, out[3] threads per CTA, out[4] CTAs an SM holds at once,
// out[5] local memory per thread (spills) in bytes.
int dispatch_rank_info(int nb, int warps, int* out) {
  if (warps < 1 || 32 * warps > kMaxThreads || nb < 1 || nb >= kNone)
    return cudaErrorInvalidValue;
  int smem, resident;
  cudaError_t err = setup(nb, warps, &smem, &resident);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, dispatch_rank_kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], dispatch_rank_kernel,
                                                           32 * warps, smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = 32 * warps;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // extern "C"
