// Intersect-count kernel (K5): counts[b, i] = popcount(adj[row(i)] & mask[b]).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/intersect_count/kernel.py:_kernel
// (intersect_count_pallas, dispatched by intersect_count/ops.py), and
// with an index vector the gathered form the compact engine reads
// (intersect_count/ref.py:intersect_count_gathered_ref): row(i) = idx[b, i]
// under JAX's gather rule, so the rows adj[idx] are read in place and
// never copied.
//
// Design (the row tiles of rows.cuh, as K1 and K4): grid (ceil(n / rows),
// lanes), a CTA a tile of `rows` positions (32 by default,
// dispatch.plan_rows, so 2 lanes x 512 rows are 32 CTAs), `group` threads
// a row, 16-byte loads where w % 4 == 0 and the operands are aligned, the
// mask slice in registers (no shared-memory copy, no barrier) and every
// load of a thread's rows in flight before it counts any; rows wider than
// a chunk are walked in chunks (past the residency gate).  Each group's
// lane 0 writes its rows' counts.  K5 has no flag and no minimum, so there
// is no fold across CTAs and no scratch: a call is this one kernel.
// Static shared memory only (none), so no attribute is ever set.  The
// adjacency is shared by every lane (adj_stride 0) or per lane.
// What bounds it: the rows read, n * w * 4 bytes per lane (bytes); at the
// engine's sizes (n <= 1024, w <= 128) the launch latency and one round
// of loads, a few microseconds.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

// kernels/intersect_count/ops.py:_ARGS, field for field (8 bytes each)
struct CountArgs {
  const uint32_t* adj;
  const uint32_t* mask;
  const int* idx;
  int* counts;
  void* stream;
  long long adj_stride, n_adj, n, w, lanes;
  long long rows, threads, group, units, chunk, nchunks, vec;
};

template <bool VEC, int CHUNK>
__global__ void __launch_bounds__(rows::MAX_THREADS)
    intersect_count_kernel(const CountArgs a) {
  const int b = blockIdx.y;
  const int n = static_cast<int>(a.n);
  const int R = static_cast<int>(a.rows);
  const int row0 = blockIdx.x * R;
  const rows::Tile t = rows::tile(static_cast<int>(a.group), R,
                                  static_cast<int>(a.units),
                                  static_cast<int>(a.nchunks));
  const uint32_t* A = a.adj + a.adj_stride * b;
  const uint32_t* M = a.mask + a.w * b;
  const int* I = a.idx == nullptr ? nullptr : a.idx + a.n * b;
  int rr[rows::RMAX];
#pragma unroll
  for (int j = 0; j < rows::RMAX; ++j) {
    const int pos = row0 + rows::local_row(t, j);
    rr[j] = j < t.rpg && pos < n
                ? rows::gather(I, pos, static_cast<int>(a.n_adj)) : -1;
  }
  uint32_t acc[rows::RMAX];
  rows::group_counts<VEC, CHUNK>(A, M, a.w, t, rr, acc);
  if (t.gl == 0) {
#pragma unroll
    for (int j = 0; j < rows::RMAX; ++j)
      if (rr[j] >= 0)
        a.counts[a.n * b + row0 + rows::local_row(t, j)] =
            static_cast<int>(acc[j]);
  }
}

using Kernel = void (*)(const CountArgs);

template <bool VEC>
Kernel pick_chunk(long long chunk) {
  switch (chunk) {
    case 1: return intersect_count_kernel<VEC, 1>;
    case 2: return intersect_count_kernel<VEC, 2>;
    case 4: return intersect_count_kernel<VEC, 4>;
    case 8: return intersect_count_kernel<VEC, 8>;
    default: return nullptr;
  }
}

bool plan_ok(const CountArgs& a) {
  const long long R = a.rows, T = a.threads, G = a.group;
  const bool pow2 = G >= 1 && G <= 32 && (G & (G - 1)) == 0;
  return a.lanes >= 1 && a.lanes <= rows::MAX_LANES && a.n >= 1 &&
         a.n_adj >= 1 && a.w >= 1 && a.n < (1ll << 31) && R >= 32 &&
         R % 32 == 0 && R <= rows::MAX_ROWS && T >= 32 && T % 32 == 0 &&
         T <= rows::MAX_THREADS && pow2 && T % G == 0 &&
         R % (T / G) == 0 && R / (T / G) <= rows::RMAX &&
         a.units == (a.vec ? a.w / 4 : a.w) &&
         (!a.vec || rows::aligned16(a.adj, a.mask, a.w, a.adj_stride)) &&
         a.nchunks >= 1 && a.chunk * a.nchunks * G >= a.units &&
         (a.n + R - 1) / R < (1ll << 31);
}

}  // namespace

// One launch of K5 over every lane; `args` points at a CountArgs (read
// with memcpy: the caller's buffer need not be aligned).
extern "C" int rt_intersect_count(const void* args) {
  CountArgs a;
  std::memcpy(&a, args, sizeof a);
  if (!plan_ok(a) || a.counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = a.vec ? pick_chunk<true>(a.chunk)
                            : pick_chunk<false>(a.chunk);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.n + a.rows - 1) / a.rows),
                  static_cast<unsigned>(a.lanes));
  kern<<<grid, static_cast<unsigned>(a.threads), 0,
         static_cast<cudaStream_t>(a.stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
