// The stable in-tile rank + histogram pass shared by K1/K1r/K2/K4
// (level_fused.cu) and K6 (dispatch_rank.cu).  One CTA of kWarps warps ranks
// one item of positions in position order: see level_fused.cu's header note
// for the design (warp spans, __match_any_sync + popc, per-warp counters,
// an exclusive scan over the warps).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Stable rank + histogram of the `len` ids of one item, in position order.
// get_id(p) gives the id of item position p; an id outside [0, nb) breaks
// the caller's contract and is emitted as bucket -1, rank -1 without
// touching the counters.  emit(p, id, rank) stores the results; hist_row
// (nb ints, may be null) receives the item's histogram.  Shared memory:
// cnt holds kWarps * nb ints, s_id and s_rank `len` ints each.
template <class GetId, class Emit>
__device__ void rank_hist_item(int len, int nb, GetId get_id, Emit emit,
                               int* hist_row, int* cnt, int* s_id, int* s_rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * nb; i += kThreads) cnt[i] = 0;
  __syncthreads();

  // each warp walks one contiguous span in position order
  const int span = (((len + kWarps - 1) / kWarps) + 31) & ~31;
  const int lo = warp * span;
  const int hi = min(lo + span, len);
  int* wcnt = cnt + warp * nb;
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    int b = -1;
    if (p < hi) {
      b = get_id(p);
      if (b < 0 || b >= nb) {
        s_id[p] = -1;
        b = -1;
      }
    }
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0) {
      s_id[p] = b;
      s_rank[p] = wcnt[b] + __popc(same & below);
    }
    __syncwarp();
    if (b >= 0 && __ffs(same) - 1 == lane) wcnt[b] += __popc(same);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan over the warps, per id; the total is the histogram
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * nb + b];
      cnt[w * nb + b] = run;
      run += c;
    }
    if (hist_row != nullptr) hist_row[b] = run;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < len; p += kThreads) {
    const int b = s_id[p];
    if (b < 0) {
      emit(p, -1, -1);
    } else {
      emit(p, b, s_rank[p] + cnt[(p / span) * nb + b]);
    }
  }
}

}  // namespace
