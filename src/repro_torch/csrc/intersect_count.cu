// Intersect-count kernel: counts[b, i] = popcount(adj[row(i)] & mask[b]).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/intersect_count/kernel.py:_kernel
// (intersect_count_pallas, dispatched by intersect_count/ops.py), and
// with an index vector the gathered form the compact engine reads
// (intersect_count/ref.py:intersect_count_gathered_ref): row(i) = idx[b, i]
// under JAX's gather rule, so the rows adj[idx] are read in place and
// never copied.
//
// Design: fused_check.cu's counting loop without the flags.  Grid
// (ceil(n / 256), lanes), 256 threads; the lane's mask sits in shared
// memory, `group` threads (a power of two up to a warp, plan_blocks)
// reduce one row with __shfl_xor_sync so narrow rows do not idle a warp
// and wide rows read coalesced.  The adjacency is shared by every lane
// (adj_stride 0) or per lane.
// What bounds it: the rows read, n * w * 4 bytes per lane (bytes); at the
// engine's sizes (n <= 1024, w <= 128) a launch is dominated by its fixed
// latency.
#include <cstdint>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int ROWS = 256;

__global__ void intersect_count_kernel(const uint32_t* adj,
                                       long long adj_stride, int n_adj,
                                       const uint32_t* mask, const int* idx,
                                       int* counts, int n, int w, int group) {
  extern __shared__ __align__(16) char smem[];
  uint32_t* m = reinterpret_cast<uint32_t*>(smem);
  const int b = blockIdx.y;
  const uint32_t* A = adj + adj_stride * b;
  const int* I = idx == nullptr ? nullptr : idx + static_cast<long long>(b) * n;
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < w; i += blockDim.x) m[i] = mask[b * w + i];
  __syncthreads();
  const int G = group;
  const int gl = threadIdx.x & (G - 1);
  const int ngrp = blockDim.x / G;
  for (int r = threadIdx.x / G; r < ROWS; r += ngrp) {  // uniform per warp
    const int pos = row0 + r;
    const bool live = pos < n;
    const int row = live ? rows::gather(I, pos, n_adj) : 0;
    const uint32_t c = rows::group_count(A + static_cast<long long>(row) * w,
                                         m, w, gl, G, live);
    if (live && gl == 0)
      counts[static_cast<long long>(b) * n + pos] = static_cast<int>(c);
  }
}

}  // namespace

extern "C" int rt_intersect_count(const uint32_t* adj, long long adj_stride,
                                  int n_adj, const uint32_t* mask,
                                  const int* idx, int* counts, int batch,
                                  int n, int w, int threads, int group,
                                  void* stream) {
  if (threads < 32 || threads % 32 != 0 || threads > 1024 || group < 1 ||
      group > 32 || ROWS % (threads / group) != 0 || batch < 1 || n < 1 ||
      n_adj < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * w;
  cudaError_t e = cudaFuncSetAttribute(
      intersect_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + ROWS - 1) / ROWS, batch);
  intersect_count_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      adj, adj_stride, n_adj, mask, idx, counts, n, w, group);
  return static_cast<int>(cudaGetLastError());
}
