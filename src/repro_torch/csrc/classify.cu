// K7 classify_histogram, classify_histogram_batched and radix_histogram:
// classification plus a per-tile histogram, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/classify.py:
//   `classify_histogram` (:100)         -- tree mode over one row of raw
//      keys of any of the reference's twelve key dtypes (8/16/32/64-bit
//      ints and uints, float16, bfloat16, float32, float64) against k-1
//      splitters and the dtype's max as the last upper: j = #{i < k-1 :
//      key > upper[i]}, eq = any_i (key == upper[i]), id = 2j + eq in
//      [0, 2k);
//   `classify_histogram_batched` (:153) -- the same over (B, n) rows, row b
//      against its own uppers;
//   `radix_histogram` (:222)            -- radix mode over the port's signed
//      int32 or int64 codes: the bits of the code with its sign bit flipped
//      (the reference's unsigned code) at `shift`, masked to log2(k) bits,
//      id = 2j + (code == the signed max), as K1r takes them
//      (`radix_histogram_batched` flattens its rows into one such call).
// Each also writes the tile's histogram of the 2k ids, (tiles, 2k) per row.
// No pad bucket and no rank: that is K1's work (level_fused.cu).
//
// Raw keys, not encoded ones, compared in their own type as the
// reference's dense compare does: signed ints as signed, unsigned ints as
// unsigned (8- and 16-bit ones widened exactly to int, uint32 and uint64 as
// unsigned and unsigned long long), float64 as double, and bfloat16 and
// float16 widened exactly to float and compared against the float
// widening of the uppers.  So NaN compares false everywhere (j = 0, eq =
// 0), -0.0 equals a +0.0 upper, +inf lands in j = k-1 with eq = 0 unless an
// upper is +inf, and a key equal to the dtype's max gets eq = 1.
//
// Bound: bytes.  A key read (1, 2, 4 or 8 B) and an id written (4 B) per
// element, and the (tiles, 2k) histogram: ~0.04 ms at 2^24 float32 keys on
// the H100 at 3.35 TB/s, ~0.03 ms for 8- and 16-bit keys (5 and 6 B a key)
// and ~0.06 ms for 64-bit keys (12 B a key).  The log2(k) descent steps and
// the histogram's shared-memory atomics are far below the integer rate.
//
// What held the first design back (0.0736 / 0.0789 / 0.0784 / 0.1487 ms of
// device time for 8-, 16-, 32- and 64-bit keys at n = 2^24, k = 128, the
// default tile of 4096 keys, on an H100 at 700 W: 36-53% of the bound, the
// narrow keys no faster than the 32-bit ones).  One CTA of 256 threads per
// tile, 4096 CTAs; each thread took its 16 keys one at a time at a stride of
// 256: a scalar load, a binary search of the splitters in shared memory (7
// loads at k = 128, each waiting on the one before), an atomicAdd on the
// shared histogram and a 4-byte store, the next key's load issued only
// after all that.  An SM held ~64 warps x 32 keys in flight (2 KB of 8-bit
// keys, 8 KB of 32-bit ones) where 3.35 TB/s at ~1 us of latency wants ~25
// KB: latency and dependent chains set the time, not the bytes.
//
// This design (`classify_hist_kernel<kind, radix, vec>`), after K1's (level_fused.cu):
//   - a CTA of 256 threads takes a run of whole tiles of one row (never two
//     rows, whose splitters differ), builds its tree once, and keeps every
//     tile's histogram in shared memory until its end (up to 32 KB of them:
//     32 tiles at k = 128), so its warps never wait on each other between
//     the first barrier and the last.  A launch gives a CTA ceil(tiles /
//     (4 x SMs x CTAs an SM holds)) tiles, at most that many: about four
//     waves, so one CTA's histograms go out while others stream (in one
//     wave they all went out at the end, which cost most in radix mode,
//     whose histograms are 16 MB at k = 256 and the default tile);
//   - each warp walks its own steps of the CTA's keys, w, w + 8, ...: a lane
//     takes 4 pieces of ids a step, a piece being 4 keys (2 of 64 bits), in
//     16-byte loads (16 keys of 8 bits, 8 of 16, 4 of 32 or 2 of 64 a load:
//     1, 2, 4 and 4 loads), and issues the next step's loads before it
//     classifies this step's keys (a register double buffer);
//   - for 8- and 16-bit keys a load holds 4 or 2 pieces; the warp's 32
//     loads are transposed by 4 or 2 shuffle rounds (the pieces rotated by
//     selects before and after) so that lane l holds pieces l, 32 + l, ...
//     of the warp's block.  Every id store is then 16 bytes (8 for 64-bit
//     keys), consecutive lanes on consecutive pieces;
//   - tree mode: the paper's branchless descent (IPS4o §4.1), j = 2j + (key >
//     tree[j]) over log2(k') levels, k' = k rounded up to a power of two, the
//     k-1 splitters in Eytzinger order in shared memory in the kind's compare
//     type and padded with a value no key exceeds: the compare type's max
//     for the ints (unsigned ones as unsigned), NaN for the floats (a pad of
//     the float's max would count below +inf keys).  A lane's keys descend 8
//     at a time, interleaved, so one key's dependent load overlaps the
//     others'; the top two levels come from registers (the root, and a
//     select between its children), the rest from shared memory by byte
//     offsets (the levels up to 16 nodes free of bank conflicts for 8-byte
//     splitters too).  Then eq = (key == upper[j] || key == upper[k-1]), the
//     k uppers beside the tree, so NaN keys, NaN splitters (last, as a sort
//     leaves them), -0.0 against +0.0, +-inf and the dtype's max land where
//     the dense compare puts them;
//   - 8-bit keys take 256 values: the CTA classifies each value once by the
//     same descent into a table of ids, and a key's id is one shared load;
//   - the histogram: one shared atomicAdd a key.  On the H100 a warp's
//     atomics on one address did not serialise: all-equal, sorted and Zipf
//     keys take the time of uniform ones (chip_smoke.py times them side by
//     side), while merging each lane's runs of one (tile, id) in registers
//     first cost about a tenth of the time on uniform keys.  So one
//     histogram per tile at every k: no run merging, no per-warp copies and
//     no switch by k;
//   - radix mode takes the same steps, stores and histogram, with the
//     shift and mask in place of the descent;
//   - keys or ids that are not 16-byte aligned (a view into a tensor) take
//     the same kernel with scalar loads and stores (`vec` false).
// Shared memory: the padded tree and the uppers, (k' + k) x 4 B ((k' + k) x
// 8 B for 64-bit keys), the 8-bit table (1 KB), and max(1, 32 KB / 8k)
// histograms of 2k counters.  By key width at k = 128 (k = 256 in radix
// mode), from `classify_info` on an H100 (chip_smoke.py prints it), no
// spills:
//   8-bit tree    48 registers, 34,816 B a CTA, 5 CTAs an SM
//   16-bit tree   64 registers, 33,792 B, 4 CTAs an SM
//   32-bit tree   79 registers, 33,792 B, 3 CTAs an SM
//   64-bit tree   79 registers, 34,816 B, 3 CTAs an SM
//   radix, 32- and 64-bit codes   64 registers, 32,768 B, 4 CTAs an SM
// `kernels/classify.py` `schedule` mirrors the warp step, the tiles a CTA
// keeps and the shared bytes.
#include <climits>
#include <type_traits>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPieces = 4;              // id pieces a lane takes a warp step
constexpr int kHistBudget = 32 * 1024;  // bytes of tile histograms a CTA keeps at most
constexpr int kWaves = 4;               // waves of CTAs a launch aims at
constexpr unsigned kFull = 0xffffffffu;

// The key kinds, as the wrapper numbers them (kernels/classify.py).
enum Kind {
  kInt32 = 0, kFloat32 = 1, kBFloat16 = 2, kInt8 = 3, kUInt8 = 4, kInt16 = 5,
  kUInt16 = 6, kFloat16 = 7, kUInt32 = 8, kInt64 = 9, kUInt64 = 10, kFloat64 = 11,
};

// A key kind: its stored bytes, its compare type T (the uppers' type too),
// the pad of the tree (no key exceeds it), and the e-th key of a piece's
// words (a piece: 4 keys of 1, 2 or 4 bytes in 1, 2 or 4 words; 2 keys of 8
// bytes in 4 words, little-endian).
template <int kBytes_, class T>
struct KeyOf {
  using Type = T;
  static constexpr int kBytes = kBytes_;
  static constexpr int kPieceKeys = kBytes == 8 ? 2 : 4;
  static constexpr int kPieceWords = kBytes == 8 ? 4 : kBytes;
  __device__ static T pad() {
    if constexpr (std::is_floating_point_v<T>) {
      return T(__int_as_float(0x7fc00000));  // NaN: no compare holds
    } else if constexpr (std::is_same_v<T, unsigned long long>) {
      return ULLONG_MAX;
    } else if constexpr (std::is_same_v<T, long long>) {
      return LLONG_MAX;
    } else if constexpr (std::is_same_v<T, unsigned>) {
      return UINT_MAX;
    } else {
      return INT_MAX;
    }
  }
};

template <int kKind> struct Key;
template <> struct Key<kInt8> : KeyOf<1, int> {
  __device__ static int get(const unsigned* w, int e) {
    return (int)(w[0] << (24 - 8 * e)) >> 24;
  }
};
template <> struct Key<kUInt8> : KeyOf<1, int> {
  __device__ static int get(const unsigned* w, int e) { return (int)((w[0] >> (8 * e)) & 0xffu); }
};
template <> struct Key<kInt16> : KeyOf<2, int> {
  __device__ static int get(const unsigned* w, int e) {
    return (int)(w[e >> 1] << (16 - 16 * (e & 1))) >> 16;
  }
};
template <> struct Key<kUInt16> : KeyOf<2, int> {
  __device__ static int get(const unsigned* w, int e) {
    return (int)((w[e >> 1] >> (16 * (e & 1))) & 0xffffu);
  }
};
template <> struct Key<kBFloat16> : KeyOf<2, float> {  // the raw 16 bits, widened
  __device__ static float get(const unsigned* w, int e) {
    return __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xffffu) << 16);
  }
};
template <> struct Key<kFloat16> : KeyOf<2, float> {  // widened exactly
  __device__ static float get(const unsigned* w, int e) {
    return __half2float(__ushort_as_half((unsigned short)(w[e >> 1] >> (16 * (e & 1)))));
  }
};
template <> struct Key<kInt32> : KeyOf<4, int> {
  __device__ static int get(const unsigned* w, int e) { return (int)w[e]; }
};
template <> struct Key<kUInt32> : KeyOf<4, unsigned> {
  __device__ static unsigned get(const unsigned* w, int e) { return w[e]; }
};
template <> struct Key<kFloat32> : KeyOf<4, float> {
  __device__ static float get(const unsigned* w, int e) { return __uint_as_float(w[e]); }
};
__device__ __forceinline__ unsigned long long word64(const unsigned* w, int e) {
  return ((unsigned long long)w[2 * e + 1] << 32) | w[2 * e];
}
template <> struct Key<kInt64> : KeyOf<8, long long> {
  __device__ static long long get(const unsigned* w, int e) { return (long long)word64(w, e); }
};
template <> struct Key<kUInt64> : KeyOf<8, unsigned long long> {
  __device__ static unsigned long long get(const unsigned* w, int e) { return word64(w, e); }
};
template <> struct Key<kFloat64> : KeyOf<8, double> {
  __device__ static double get(const unsigned* w, int e) {
    return __longlong_as_double((long long)word64(w, e));
  }
};

// Pieces i of the 4 words w (P pieces of 4 / P words) <- pieces (i - by) mod P.
template <int P>
__device__ __forceinline__ void rotate_pieces(unsigned (&w)[4], int by) {
  constexpr int PW = 4 / P;
#pragma unroll
  for (int bit = 1; bit < P; bit <<= 1) {
    unsigned t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = (by & bit) ? w[(i + 4 - bit * PW) & 3] : w[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = t[i];
  }
}

// The warp's 32 loads of 16 bytes, P pieces each (P = 4 for 8-bit keys, 2
// for 16-bit, 1 otherwise), transposed so that lane l gets pieces l, 32 + l,
// ... of the warp's 32P: piece 32q + l is in lane 32q / P + l / P's load at
// sub-piece l mod P.  Round r takes from each lane its piece (r - q) mod P,
// q = its lane / (32 / P), and gives lane l the piece of q = (r - l) mod P.
template <int P>
__device__ __forceinline__ void to_pieces(const uint4& v, unsigned (&out)[4], int lane) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (P == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = w[i];
  } else {
    constexpr int PW = 4 / P;
    constexpr int kSpan = 32 / P;  // lanes whose loads hold pieces [32q, 32q + 32)
    rotate_pieces<P>(w, lane / kSpan);
    const int s = lane & (P - 1);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int src = ((r - s) & (P - 1)) * kSpan + lane / P;
#pragma unroll
      for (int e = 0; e < PW; ++e) out[r * PW + e] = __shfl_sync(kFull, w[r * PW + e], src);
    }
    rotate_pieces<P>(out, (P - s) & (P - 1));
  }
}

template <int kBytes, bool kVec>
__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {  // aligned to the key's size only
    using S = std::conditional_t<kBytes == 1, unsigned char,
              std::conditional_t<kBytes == 2, unsigned short,
              std::conditional_t<kBytes == 4, unsigned, unsigned long long>>>;
    uint4 v;
    S* d = reinterpret_cast<S*>(&v);
#pragma unroll
    for (int i = 0; i < 16 / kBytes; ++i) d[i] = __ldg(reinterpret_cast<const S*>(p) + i);
    return v;
  }
}

// Division by the tile (a multiple of 128), exact for the positions of a
// row (< 2^31): q = umulhi(x, magic) >> shift, magic = ceil(2^(31 + l) /
// tile) < 2^32, shift = l - 1, l = ceil(log2 tile).
struct TileDiv {
  unsigned magic;
  int shift;
  __device__ int operator()(int x) const { return (int)(__umulhi((unsigned)x, magic) >> shift); }
};

TileDiv tile_div(int tile) {
  int l = 0;
  while ((1LL << l) < tile) ++l;
  return {(unsigned)(((1ull << (31 + l)) + tile - 1) / tile), l - 1};
}

// The splitter tree of one row: the top two levels in registers, the rest
// in shared memory, beside the k uppers.
template <class T>
struct Tree {
  const T* nodes;   // [1, k') in Eytzinger order
  const T* uppers;  // the k uppers, sorted
  T t1, t2, t3, last;
  int depth, kp;

  // ids 2j + eq of G keys, their descents interleaved; below the top two
  // levels a descent keeps the byte offset of its node
  template <int G>
  __device__ __forceinline__ void classify(const T (&key)[G], int (&id)[G]) const {
    unsigned at[G];
#pragma unroll
    for (int x = 0; x < G; ++x) {
      int j = 1;
      if (depth >= 1) j = key[x] > t1 ? 3 : 2;
      if (depth >= 2) j = 2 * j + (key[x] > (j == 3 ? t3 : t2) ? 1 : 0);
      at[x] = (unsigned)j * (unsigned)sizeof(T);
    }
    const unsigned char* base = reinterpret_cast<const unsigned char*>(nodes);
#pragma unroll 1
    for (int level = 2; level < depth; ++level) {
#pragma unroll
      for (int x = 0; x < G; ++x) {
        const T node = *reinterpret_cast<const T*>(base + at[x]);
        at[x] = 2 * at[x] + (key[x] > node ? (unsigned)sizeof(T) : 0u);
      }
    }
#pragma unroll
    for (int x = 0; x < G; ++x) {
      const int j = (int)(at[x] / (unsigned)sizeof(T)) - kp;  // the splitters below the key
      id[x] = 2 * j + ((key[x] == uppers[j] || key[x] == last) ? 1 : 0);
    }
  }
};

// CTAs are numbered row-major over (row, the row's runs of tiles_per_cta
// tiles); hist is (rows, tiles_per_row, 2k) and each tile writes its own row.
template <int kKind, bool kRadix, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    classify_hist_kernel(const void* __restrict__ keys, const void* __restrict__ upper,
                         int n, int k, int shift, int tile, TileDiv div, int tiles_per_row,
                         int tiles_per_cta, int ctas_per_row, int* __restrict__ bucket,
                         int* __restrict__ hist) {
  using K = Key<kKind>;
  using T = typename K::Type;
  constexpr int KB = K::kBytes;
  constexpr int PW = K::kPieceWords;
  constexpr int KP = K::kPieceKeys;
  constexpr int P = 4 / PW;            // pieces a 16-byte load holds (1 for 64-bit keys)
  constexpr int U = kPieces / P;       // 16-byte loads a lane makes a warp step
  constexpr int KV = 16 / KB;          // keys a load holds
  constexpr int WS = 32 * U * KV;      // keys a warp step
  constexpr int GP = KB == 8 ? kPieces : 2;  // pieces a group, whose descents interleave
  constexpr int GK = GP * KP;                // keys a group: 8
  constexpr bool kTable = KB == 1 && !kRadix;  // 8-bit keys: the ids of all 256 keys
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = 2 * k;
  const int depth = 32 - __clz(k - 1);  // log2(k'), k' = k rounded up to a power of two
  const int kp = 1 << depth;
  T* s_tree = reinterpret_cast<T*>(smem);  // tree mode: [1, k') in Eytzinger order
  T* s_upper = s_tree + kp;                 // tree mode: the k uppers
  int* s_table = reinterpret_cast<int*>(smem + (kRadix ? 0 : (kp + k) * (int)sizeof(T)));
  int* s_hist = s_table + (kTable ? 256 : 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / ctas_per_row;
  const int t_begin = (blockIdx.x - row * ctas_per_row) * tiles_per_cta;
  const int tiles = min(tiles_per_cta, tiles_per_row - t_begin);
  const int range = tiles * tile;  // the CTA's keys, from t_begin * tile

  for (int i = threadIdx.x; i < tiles * nb; i += kThreads) s_hist[i] = 0;
  Tree<T> tree{s_tree, s_upper, T(0), T(0), T(0), T(0), depth, kp};
  if (!kRadix) {
    const T* row_upper = static_cast<const T*>(upper) + (long long)row * k;
    for (int i = threadIdx.x + 1; i < kp; i += kThreads) {
      // node i at depth h, p-th of its depth: sorted index (2p+1) k'/2^(h+1) - 1
      const int h = 31 - __clz(i);
      const int at = (2 * (i - (1 << h)) + 1) * (kp >> (h + 1)) - 1;
      s_tree[i] = at < k - 1 ? row_upper[at] : K::pad();
    }
    for (int i = threadIdx.x; i < k; i += kThreads) s_upper[i] = row_upper[i];
    tree.last = tree.t1 = tree.t2 = tree.t3 = row_upper[k - 1];
  }
  __syncthreads();
  if (!kRadix && depth >= 1) tree.t1 = s_tree[1];
  if (!kRadix && depth >= 2) tree.t2 = s_tree[2], tree.t3 = s_tree[3];
  if constexpr (kTable) {  // a thread a key value, by the same descent
    const unsigned value = threadIdx.x;
    T key[1] = {K::get(&value, 0)};
    int id[1];
    tree.classify(key, id);
    s_table[threadIdx.x] = id[0];  // kThreads == 256
    __syncthreads();
  }

  const long long first = (long long)row * n + (long long)t_begin * tile;
  const unsigned char* cta_keys = static_cast<const unsigned char*>(keys) + first * KB;
  int* cta_ids = bucket + first;
  auto load = [&](uint4 (&buf)[U], int at0) {  // the warp step at key at0 of the CTA
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int at = at0 + (u * 32 + lane) * KV;  // the load's first key
      buf[u] = at < range ? load16<KB, kVec>(cta_keys + (long long)at * KB)
                          : make_uint4(0, 0, 0, 0);
    }
  };

  // the warp's steps: warp step w, w + 8, ... of the CTA's keys, the next
  // one's loads in flight while this one is classified
  uint4 next[U];
  int at0 = warp * WS;
  if (at0 < range) load(next, at0);
  for (; at0 < range; at0 += kWarps * WS) {
    unsigned w[kPieces * PW];  // the lane's pieces: 32u P + 32q + lane of the step
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unsigned v[4];
      to_pieces<P>(next[u], v, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[4 * u + i] = v[i];
    }
    if (at0 + kWarps * WS < range) load(next, at0 + kWarps * WS);

#pragma unroll
    for (int g = 0; g < kPieces / GP; ++g) {
      T key[GK];
#pragma unroll
      for (int i = 0; i < GP; ++i) {
#pragma unroll
        for (int e = 0; e < KP; ++e) key[i * KP + e] = K::get(w + (g * GP + i) * PW, e);
      }
      int id[GK];
      if constexpr (kRadix) {  // T is int or long long: a signed code
        using UT = std::make_unsigned_t<T>;
        constexpr UT sign = (UT)1 << (8 * sizeof(T) - 1);
#pragma unroll
        for (int x = 0; x < GK; ++x) {
          const UT bits = ((UT)key[x] ^ sign) >> shift;
          id[x] = 2 * (int)(bits & (UT)(k - 1)) + (key[x] == (T)(sign - 1) ? 1 : 0);
        }
      } else if constexpr (kTable) {
#pragma unroll
        for (int x = 0; x < GK; ++x) id[x] = s_table[key[x] & 0xff];
      } else {
        tree.classify(key, id);
      }

#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const int piece = g * GP + i;  // load piece / P, its piece piece % P
        const int at = at0 + ((piece / P) * 32 * P + 32 * (piece % P) + lane) * KP;
        if (at < range) {
          // the ids: a piece a store, consecutive lanes on consecutive pieces
          int* dst = cta_ids + at;
          if constexpr (KP == 4 && kVec) {
            *reinterpret_cast<int4*>(dst) =
                make_int4(id[4 * i], id[4 * i + 1], id[4 * i + 2], id[4 * i + 3]);
          } else if constexpr (KP == 2 && kVec) {
            *reinterpret_cast<int2*>(dst) = make_int2(id[2 * i], id[2 * i + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < KP; ++e) dst[e] = id[KP * i + e];
          }
          // the histogram: a shared atomic a key
          int* h = s_hist + div(at) * nb;
#pragma unroll
          for (int e = 0; e < KP; ++e) atomicAdd(&h[id[KP * i + e]], 1);
        }
      }
    }
  }
  __syncthreads();
  int* dst = hist + ((long long)row * tiles_per_row + t_begin) * nb;  // the CTA's rows
  for (int i = threadIdx.x; i < tiles * nb; i += kThreads) dst[i] = s_hist[i];
}

// The launch at (key bytes, k, mode): `kernels/classify.py` `schedule`.
// A CTA keeps the histograms of at most `tiles` tiles (32 KB of them, at
// least one tile's) beside the tree.
struct Schedule {
  int tiles, smem;
};

Schedule schedule(int key_bytes, int k, bool radix) {
  const int nb = 2 * k;
  int kp = 1;
  while (kp < k) kp <<= 1;
  int tiles = kHistBudget / (nb * 4);
  if (tiles < 1) tiles = 1;
  const int tree = radix ? 0 : (kp + k) * (key_bytes == 8 ? 8 : 4) + (key_bytes == 1 ? 1024 : 0);
  return {tiles, tree + tiles * nb * 4};
}

using KernelFn = void (*)(const void*, const void*, int, int, int, int, TileDiv, int, int, int,
                          int*, int*);

template <int kKind, bool kRadix>
KernelFn kernel_of(bool vec) {
  return vec ? &classify_hist_kernel<kKind, kRadix, true>
             : &classify_hist_kernel<kKind, kRadix, false>;
}

template <int kKind, bool kRadix>
cudaError_t setup(int k, bool vec, KernelFn* kernel, Schedule* sch) {
  *sch = schedule(Key<kKind>::kBytes, k, kRadix);
  *kernel = kernel_of<kKind, kRadix>(vec);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sch->smem);
}

template <int kKind, bool kRadix>
int launch(const void* keys, const void* upper, int rows, int n, int k, int shift, int tile,
           void* bucket, void* hist, void* stream) {
  const bool vec = (((unsigned long long)keys | (unsigned long long)bucket) & 15) == 0;
  KernelFn kernel;
  Schedule sch;
  cudaError_t err = setup<kKind, kRadix>(k, vec, &kernel, &sch);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = n / tile;
  const long long tiles = (long long)rows * tiles_per_row;
  if (tiles == 0) return cudaSuccess;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           sch.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // kWaves waves of CTAs where the histograms fit, each a run of tiles of
  // one row (a CTA's histograms go out at its end, over the others' streams)
  const long long wave = (long long)sms * per_sm * kWaves;
  long long per_cta = (tiles + wave - 1) / wave;
  if (per_cta > sch.tiles) per_cta = sch.tiles;
  if (per_cta > tiles_per_row) per_cta = tiles_per_row;
  const long long ctas_per_row = (tiles_per_row + per_cta - 1) / per_cta;
  const long long ctas = rows * ctas_per_row;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, kThreads, sch.smem, (cudaStream_t)stream>>>(
      keys, upper, n, k, shift, tile, tile_div(tile), tiles_per_row, (int)per_cta,
      (int)ctas_per_row, (int*)bucket, (int*)hist);
  return cudaGetLastError();
}

template <int kKind, bool kRadix>
int info(int k, int* out) {
  KernelFn kernel;
  Schedule sch;
  cudaError_t err = setup<kKind, kRadix>(k, true, &kernel, &sch);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, kThreads,
                                                           sch.smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = sch.smem;
  out[3] = kThreads;
  out[5] = (int)attr.localSizeBytes;
  out[6] = 32 * kPieces * Key<kKind>::kPieceKeys;
  out[7] = sch.tiles;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* classify_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Tree mode over `rows` rows of n keys of `kind` (Kind above); upper is
// (rows, k) in the kind's compare type: int32 for the int32 and 8- and
// 16-bit int kinds, the raw bits of uint32 / int64 / uint64 / float64, and
// float32 for the three float kinds of 32 bits or fewer.  n is a multiple of
// tile, and tile of 128.
int classify_histogram_tree(const void* keys, const void* upper, int kind,
                            int rows, int n, int k, int tile, void* bucket,
                            void* hist, void* stream) {
#define TREE(K)                                                               \
  case K:                                                                     \
    return launch<K, false>(keys, upper, rows, n, k, 0, tile, bucket, hist, stream)
  switch (kind) {
    TREE(kInt32);
    TREE(kFloat32);
    TREE(kBFloat16);
    TREE(kInt8);
    TREE(kUInt8);
    TREE(kInt16);
    TREE(kUInt16);
    TREE(kFloat16);
    TREE(kUInt32);
    TREE(kInt64);
    TREE(kUInt64);
    TREE(kFloat64);
    default:
      return cudaErrorInvalidValue;
  }
#undef TREE
}

// Radix mode over `rows` rows of n int32 codes.
int classify_histogram_radix(const void* keys, int rows, int n, int k,
                             int shift, int tile, void* bucket, void* hist,
                             void* stream) {
  return launch<kInt32, true>(keys, nullptr, rows, n, k, shift, tile, bucket,
                              hist, stream);
}

// Radix mode over `rows` rows of n int64 codes (shift in [0, 64)).
int classify_histogram_radix64(const void* keys, int rows, int n, int k,
                               int shift, int tile, void* bucket, void* hist,
                               void* stream) {
  return launch<kInt64, true>(keys, nullptr, rows, n, k, shift, tile, bucket,
                              hist, stream);
}

// The 16-byte-aligned launch of `kind` (radix: kind 0 or 9, the codes) at
// k: out[0] registers, [1] static and [2] dynamic shared bytes, [3]
// threads, [4] CTAs an SM holds, [5] local (spilled) bytes a thread, [6]
// keys a warp step, [7] the most tiles a CTA takes.
int classify_info(int kind, int radix, int k, int* out) {
  if (radix) {
    return kind == kInt64 ? info<kInt64, true>(k, out) : info<kInt32, true>(k, out);
  }
#define INFO(K) \
  case K:       \
    return info<K, false>(k, out)
  switch (kind) {
    INFO(kInt32);
    INFO(kFloat32);
    INFO(kBFloat16);
    INFO(kInt8);
    INFO(kUInt8);
    INFO(kInt16);
    INFO(kUInt16);
    INFO(kFloat16);
    INFO(kUInt32);
    INFO(kInt64);
    INFO(kUInt64);
    INFO(kFloat64);
    default:
      return cudaErrorInvalidValue;
  }
#undef INFO
}

}  // extern "C"
