// Fused candidate selection: the first active row minimising
// popcount(adj[row(i)] & mask), as (position, count).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_select/kernel.py:_kernel
// (fused_select_pallas, dispatched by fused_select/ops.py:fused_select,
// fused_select_packed and fused_select_prefix) and the gathered wrappers
// over it (fused_select_gathered, fused_select_gathered_prefix), which
// read the rows adj[idx]: here row(i) = idx[b, i] under JAX's gather rule,
// read in place, and the returned index is the POSITION i.
//
// Activity kinds (template parameter): DENSE (b, n) int32 > 0, PACKED
// (b, ceil(n/32)) words (bit i of word i/32), PREFIX one int32 bound p per
// lane (positions [0, p) active).  No active row gives (-1, INT32_MAX),
// prefix p == 0 included; the kernel does not clamp it.
//
// Design: the TPU kernel carries the running minimum across its
// SEQUENTIAL grid (kernel.py:100-103).  Hopper blocks run in no order, so
// here ONE block per lane loops over all of the lane's rows (n <= 1024 at
// every engine bucket): `group` threads reduce a row with
// __shfl_xor_sync, and each active row becomes the 64-bit key
// (count << 32) | position.  The smallest key is the first minimum, as
// jnp.argmin picks it; a warp-shuffle min and one pass over the warps'
// minima in shared memory give it, with no atomics and no second launch.
// What bounds it: the rows read, n * w * 4 bytes per lane (bytes).  One
// block per lane uses at most `lanes` SMs, so a launch is latency-bound
// at the engine's sizes.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

enum Kind { DENSE = 0, PACKED = 1, PREFIX = 2 };
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(rows::FULL, k, off);
    k = o < k ? o : k;
  }
  return k;
}

template <int KIND>
__global__ void fused_select_kernel(const uint32_t* adj, long long adj_stride,
                                    int n_adj, const uint32_t* mask,
                                    const int* idx, const int* act,
                                    int* out_idx, int* out_val, int n, int w,
                                    int group) {
  extern __shared__ __align__(16) char smem[];
  unsigned long long* red = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* m = reinterpret_cast<uint32_t*>(smem + 8 * 32);
  const int b = blockIdx.x;
  const uint32_t* A = adj + adj_stride * b;
  const int* I = idx == nullptr ? nullptr : idx + static_cast<long long>(b) * n;
  for (int i = threadIdx.x; i < w; i += blockDim.x) m[i] = mask[b * w + i];
  __syncthreads();
  const int nw = (n + 31) / 32;
  const int bound = KIND == PREFIX ? act[b] : 0;
  const int G = group;
  const int gl = threadIdx.x & (G - 1);
  const int ngrp = blockDim.x / G;
  unsigned long long best = NONE;
  for (int r0 = 0; r0 < n; r0 += ngrp) {  // uniform: every warp shuffles
    const int pos = r0 + threadIdx.x / G;
    const bool live = pos < n;
    const int row = live ? rows::gather(I, pos, n_adj) : 0;
    const uint32_t c = rows::group_count(A + static_cast<long long>(row) * w,
                                         m, w, gl, G, live);
    bool on = false;
    if (live && gl == 0) {
      if (KIND == DENSE)
        on = act[static_cast<long long>(b) * n + pos] > 0;
      else if (KIND == PACKED)
        on = (static_cast<uint32_t>(act[b * nw + (pos >> 5)]) >> (pos & 31)) &
             1u;
      else
        on = pos < bound;
    }
    const unsigned long long key =
        on ? (static_cast<unsigned long long>(c) << 32) |
                 static_cast<uint32_t>(pos)
           : NONE;
    best = key < best ? key : best;
  }
  best = warp_min(best);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : NONE;
    best = warp_min(best);
    if (threadIdx.x == 0) {
      out_idx[b] = best == NONE ? -1 : static_cast<int>(best & 0xFFFFFFFFu);
      out_val[b] = best == NONE ? INT_MAX : static_cast<int>(best >> 32);
    }
  }
}

}  // namespace

extern "C" int rt_fused_select(const uint32_t* adj, long long adj_stride,
                               int n_adj, const uint32_t* mask,
                               const int* idx, const int* act, int kind,
                               int* out_idx, int* out_val, int batch, int n,
                               int w, int threads, int group, void* stream) {
  if (threads < 32 || threads % 32 != 0 || threads > 1024 || group < 1 ||
      group > 32 || batch < 1 || n < 1 || n_adj < 1 || w < 1 || kind < 0 ||
      kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 8 * 32 + 4 * w;
  auto kern = kind == DENSE    ? fused_select_kernel<DENSE>
              : kind == PACKED ? fused_select_kernel<PACKED>
                               : fused_select_kernel<PREFIX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      adj, adj_stride, n_adj, mask, idx, act, out_idx, out_val, n, w, group);
  return static_cast<int>(cudaGetLastError());
}
