// Fused check/partition kernel, packed activity kind.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_check/kernel.py:_kernel
// (fused_check_pallas with act_kind="packed", dispatched by
// fused_check/ops.py:fused_check_packed).  One AND+popcount pass over
// the (n, w) adjacency against the L' mask gives the counts c; from them
// the Q-violation flag any(q & c == |L'|) and the packed words
// full = p & c == |L'|, part = p & 0 < c < |L'|, nz = c > 0, plus the
// counts themselves when asked (the cstack refill).
//
// Design: grid (ceil(n / 256), lanes), 256 threads.  A block counts its
// 256 rows into shared memory (`group` lanes per row, a power of two up
// to a warp, so narrow rows do not idle a warp and wide rows read
// coalesced), then thread t derives row t's flags and one __ballot_sync
// per warp gives packed word (row / 32) directly in bitset.from_bool
// order.  The violation flag is ORed across blocks with atomicOr into a
// word the wrapper zeroes.  Rows >= n are inactive and their bits never
// leave the kernel (the reference pads rows and slices the words back).
// What bounds it: the adjacency read, n*w*4 bytes per lane (bytes); at
// the engine's sizes a launch is dominated by its fixed latency.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void fused_check_kernel(const uint32_t* adj, long long adj_stride,
                                   const uint32_t* mask, const int* n_mask,
                                   const uint32_t* q, const uint32_t* p,
                                   int* viol, uint32_t* full, uint32_t* part,
                                   uint32_t* nz, int* counts, int n, int w,
                                   int group) {
  extern __shared__ __align__(16) char smem[];
  uint32_t* m = reinterpret_cast<uint32_t*>(smem);
  int* c = reinterpret_cast<int*>(smem + 4 * ((w + 3) / 4 * 4));
  const int b = blockIdx.y;
  const int nw = (n + 31) / 32;
  const uint32_t* A = adj + adj_stride * b;
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < w; i += blockDim.x) m[i] = mask[b * w + i];
  __syncthreads();

  // counts of this block's rows
  const int G = group;
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int ngrp = blockDim.x / G;
  for (int r = grp; r < ROWS; r += ngrp) {   // ROWS % ngrp == 0: uniform
    const int row = row0 + r;
    uint32_t sum = 0;
    if (row < n) {
      const uint32_t* a = A + static_cast<long>(row) * w;
      for (int k = gl; k < w; k += G) sum += __popc(a[k] & m[k]);
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    if (gl == 0) c[r] = static_cast<int>(sum);
  }
  __syncthreads();

  // flags of row threadIdx.x, packed per warp
  const int nlp = n_mask[b];
  int any_viol = 0;
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int row = row0 + r;
    const bool valid = row < n;
    const int cnt = valid ? c[r] : 0;
    const int word = row >> 5;
    const bool qb = valid && ((q[b * nw + word] >> (row & 31)) & 1u);
    const bool pb = valid && ((p[b * nw + word] >> (row & 31)) & 1u);
    const bool eq = cnt == nlp;
    any_viol |= qb && eq;
    const unsigned fw = __ballot_sync(FULL, pb && eq);
    const unsigned pw = __ballot_sync(FULL, pb && cnt > 0 && cnt < nlp);
    const unsigned zw = __ballot_sync(FULL, valid && cnt > 0);
    if ((threadIdx.x & 31) == 0 && word < nw) {
      full[b * nw + word] = fw;
      part[b * nw + word] = pw;
      nz[b * nw + word] = zw;
    }
    if (counts != nullptr && valid) counts[static_cast<long>(b) * n + row] = cnt;
  }
  if (__syncthreads_or(any_viol) && threadIdx.x == 0) atomicOr(viol + b, 1);
}

}  // namespace

extern "C" int rt_fused_check(const uint32_t* adj, long long adj_stride,
                              const uint32_t* mask, const int* n_mask,
                              const uint32_t* q, const uint32_t* p,
                              int* viol, uint32_t* full, uint32_t* part,
                              uint32_t* nz, int* counts, int batch, int n,
                              int w, int threads, int group, void* stream) {
  if (threads % 32 != 0 || ROWS % threads != 0 || group < 1 || group > 32 ||
      (threads / group) < 1 || ROWS % (threads / group) != 0 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * ((w + 3) / 4 * 4) + 4 * ROWS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + ROWS - 1) / ROWS, batch);
  fused_check_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      adj, adj_stride, mask, n_mask, q, p, viol, full, part, nz, counts, n, w,
      group);
  return static_cast<int>(cudaGetLastError());
}
