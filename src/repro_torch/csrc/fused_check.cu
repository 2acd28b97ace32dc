// Fused check/partition kernel, every activity kind.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_check/kernel.py:_kernel
// (fused_check_pallas, dispatched by fused_check/ops.py:fused_check,
// fused_check_packed and fused_check_prefix2) and the gathered wrappers
// over it (fused_check_gathered, fused_check_gathered_prefix2), which read
// the rows adj[idx]: here row(i) = idx[b, i] under JAX's gather rule,
// read in place, with the flags in position order.  One AND+popcount pass
// over the rows against the L' mask gives the counts c; from them the
// Q-violation flag any(q & c == |L'|), full = p & c == |L'|,
// part = p & 0 < c < |L'|, nz = c > 0 (activity-independent), plus the
// counts themselves when asked.
//
// Activity kinds (template parameter):
//   PACKED  q, p (b, ceil(n/32)) words in; full/part/nz words out (the
//           dense engine's stacks);
//   DENSE   q, p (b, n) int32 > 0 in; full/part/nz (b, n) bool bytes out;
//   PREFIX2 one (q_hi, p_hi) int32 pair per lane against the static split:
//           q = i < split && i < q_hi, p = i >= split && i - split < p_hi
//           (the compact engine's [Q ++ P'] layout, kernel.py:119-122);
//           bool bytes out.
//
// Design: grid (ceil(n / 256), lanes), 256 threads.  A block counts its
// 256 rows into shared memory (`group` lanes per row, a power of two up
// to a warp, so narrow rows do not idle a warp and wide rows read
// coalesced), then thread t derives row t's flags: in the packed kind one
// __ballot_sync per warp gives word (row / 32) in bitset.from_bool order,
// in the other kinds each thread writes its row's bytes.  The violation
// flag is ORed across blocks with atomicOr into a word the wrapper
// zeroes.  Rows >= n are inactive and their bits never leave the kernel
// (the reference pads rows and slices the words back).
// What bounds it: the rows read, n * w * 4 bytes per lane (bytes); at
// the engine's sizes a launch is dominated by its fixed latency.
#include <cstdint>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

enum Kind { PACKED = 0, DENSE = 1, PREFIX2 = 2 };
constexpr int ROWS = 256;

template <int KIND>
__global__ void fused_check_kernel(const uint32_t* adj, long long adj_stride,
                                   int n_adj, const uint32_t* mask,
                                   const int* n_mask, const int* idx,
                                   const int* q, const int* p, int split,
                                   int* viol, void* full, void* part,
                                   void* nz, int* counts, int n, int w,
                                   int group) {
  extern __shared__ __align__(16) char smem[];
  uint32_t* m = reinterpret_cast<uint32_t*>(smem);
  int* c = reinterpret_cast<int*>(smem + 4 * ((w + 3) / 4 * 4));
  const int b = blockIdx.y;
  const int nw = (n + 31) / 32;
  const uint32_t* A = adj + adj_stride * b;
  const int* I = idx == nullptr ? nullptr : idx + static_cast<long long>(b) * n;
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < w; i += blockDim.x) m[i] = mask[b * w + i];
  __syncthreads();

  // counts of this block's rows
  const int G = group;
  const int gl = threadIdx.x & (G - 1);
  const int ngrp = blockDim.x / G;
  for (int r = threadIdx.x / G; r < ROWS; r += ngrp) {  // uniform per warp
    const int pos = row0 + r;
    const bool live = pos < n;
    const int row = live ? rows::gather(I, pos, n_adj) : 0;
    const uint32_t sum = rows::group_count(
        A + static_cast<long long>(row) * w, m, w, gl, G, live);
    if (gl == 0) c[r] = static_cast<int>(sum);
  }
  __syncthreads();

  // flags of row threadIdx.x
  const int nlp = n_mask[b];
  int any_viol = 0;
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int row = row0 + r;
    const bool valid = row < n;
    const int cnt = valid ? c[r] : 0;
    const long long at = static_cast<long long>(b) * n + row;
    bool qb, pb;
    if (KIND == PACKED) {
      const int word = row >> 5;
      qb = valid && ((static_cast<uint32_t>(q[b * nw + word]) >> (row & 31)) &
                     1u);
      pb = valid && ((static_cast<uint32_t>(p[b * nw + word]) >> (row & 31)) &
                     1u);
    } else if (KIND == DENSE) {
      qb = valid && q[at] > 0;
      pb = valid && p[at] > 0;
    } else {
      qb = valid && row < split && row < q[b];
      pb = valid && row >= split && row - split < p[b];
    }
    const bool eq = cnt == nlp;
    any_viol |= qb && eq;
    const bool fb = pb && eq;
    const bool pt = pb && cnt > 0 && cnt < nlp;
    const bool zb = valid && cnt > 0;
    if (KIND == PACKED) {
      const int word = row >> 5;
      const unsigned fw = __ballot_sync(rows::FULL, fb);
      const unsigned pw = __ballot_sync(rows::FULL, pt);
      const unsigned zw = __ballot_sync(rows::FULL, zb);
      if ((threadIdx.x & 31) == 0 && word < nw) {
        static_cast<uint32_t*>(full)[b * nw + word] = fw;
        static_cast<uint32_t*>(part)[b * nw + word] = pw;
        static_cast<uint32_t*>(nz)[b * nw + word] = zw;
      }
    } else if (valid) {
      static_cast<uint8_t*>(full)[at] = fb;
      static_cast<uint8_t*>(part)[at] = pt;
      static_cast<uint8_t*>(nz)[at] = zb;
    }
    if (counts != nullptr && valid) counts[at] = cnt;
  }
  if (__syncthreads_or(any_viol) && threadIdx.x == 0) atomicOr(viol + b, 1);
}

}  // namespace

extern "C" int rt_fused_check(const uint32_t* adj, long long adj_stride,
                              int n_adj, const uint32_t* mask,
                              const int* n_mask, const int* idx, const int* q,
                              const int* p, int kind, int split, int* viol,
                              void* full, void* part, void* nz, int* counts,
                              int batch, int n, int w, int threads, int group,
                              void* stream) {
  if (threads < 32 || threads % 32 != 0 || ROWS % threads != 0 ||
      group < 1 || group > 32 || ROWS % (threads / group) != 0 ||
      batch < 1 || n < 1 || n_adj < 1 || w < 1 || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * ((w + 3) / 4 * 4) + 4 * ROWS;
  auto kern = kind == PACKED  ? fused_check_kernel<PACKED>
              : kind == DENSE ? fused_check_kernel<DENSE>
                              : fused_check_kernel<PREFIX2>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + ROWS - 1) / ROWS, batch);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      adj, adj_stride, n_adj, mask, n_mask, idx, q, p, split, viol, full,
      part, nz, counts, n, w, group);
  return static_cast<int>(cudaGetLastError());
}
