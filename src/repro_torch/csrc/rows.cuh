// Row helpers shared by the AND+popcount kernels (fused_check.cu,
// fused_select.cu, intersect_count.cu).
//
// A row is reduced by a group of G threads (G a power of two up to a
// warp, from dispatch.plan_blocks): lane gl of the group sums words
// gl, gl + G, ... and __shfl_xor_sync folds the group.  Every thread of
// a warp must reach the shuffle, so callers keep the loop around it
// uniform and mask the row inside.
#pragma once

#include <cstdint>

namespace rows {

constexpr unsigned FULL = 0xFFFFFFFFu;

// Row of position i: i itself, or idx[i] under JAX's gather rule (a
// negative index wraps once, then it is clamped into [0, n_adj)).
__device__ __forceinline__ int gather(const int* idx, long long i,
                                      int n_adj) {
  if (idx == nullptr) return static_cast<int>(i);
  int r = idx[i];
  if (r < 0) r += n_adj;
  return r < 0 ? 0 : (r >= n_adj ? n_adj - 1 : r);
}

// popcount(a & m) over w words by a group of G threads; every lane of
// the group gets the sum.  `live` false contributes 0 (the shuffle still
// runs).
__device__ __forceinline__ uint32_t group_count(const uint32_t* a,
                                                const uint32_t* m, int w,
                                                int gl, int G, bool live) {
  uint32_t sum = 0;
  if (live)
    for (int k = gl; k < w; k += G) sum += __popc(a[k] & m[k]);
  for (int off = G >> 1; off > 0; off >>= 1)
    sum += __shfl_xor_sync(FULL, sum, off);
  return sum;
}

}  // namespace rows
