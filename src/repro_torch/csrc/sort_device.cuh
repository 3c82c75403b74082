// Device code shared by csrc/level_fused.cu (K1, K2, K4) and csrc/glue.cu
// (G1-G4): warp and CTA exclusive scans, and a sort key's sentinel and radix
// digits.  Each source includes it inside its own anonymous namespace, so
// every library keeps a copy of its own.
#pragma once

constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan of v over the warp; *total gets the warp's sum.
__device__ __forceinline__ int warp_exclusive_scan(int v, int* total) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  *total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// Exclusive scan of v over the CTA (whole warps); *total gets the CTA's
// sum.  warp_sums: 33 ints of shared memory, free again on return.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int warp_total;
  const int excl = warp_exclusive_scan(v, &warp_total);
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? warp_sums[lane] : 0;
    int all;
    const int before = warp_exclusive_scan(w, &all);
    if (lane < warps) warp_sums[lane] = before;
    if (lane == 0) warp_sums[32] = all;
  }
  __syncthreads();
  const int out = excl + warp_sums[warp];
  *total = warp_sums[32];
  __syncthreads();
  return out;
}

// The key type's sentinel and its reference code's digits at `shift`: the
// port's signed code with the sign bit flipped is the reference's unsigned
// code (ops/keyspace.py).
template <typename Key>
struct KeyBits;
template <>
struct KeyBits<int> {
  static constexpr int kMax = INT_MAX;
  __device__ static unsigned digits(int key, int shift) {
    return ((unsigned)key ^ 0x80000000u) >> shift;
  }
};
template <>
struct KeyBits<long long> {
  static constexpr long long kMax = LLONG_MAX;
  __device__ static unsigned digits(long long key, int shift) {
    return (unsigned)(((unsigned long long)key ^ 0x8000000000000000ull) >> shift);
  }
};
