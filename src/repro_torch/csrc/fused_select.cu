// Fused candidate selection (K4): the first active row minimising
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
// SEQUENTIAL grid (kernel.py:100-103).  Here the rows are spread over the
// SMs as rows.cuh's tiles: grid (ceil(n / rows), lanes), `group` threads a
// row, the mask slice in registers, all of a thread's loads in flight at
// once.  Only rows that can be active are read: a row's activity is
// tested before its index or its words are loaded (a packed word of 0
// skips its 32 rows), and in the prefix kind a tile wholly at or past p
// returns at once.  Each active row becomes the 64-bit key
// (count << 32) | position; the smallest key is the first minimum, as
// jnp.argmin picks it.  A warp-shuffle min and one pass over the warps'
// minima in shared memory give the CTA's key; the lane's CTAs then fold
// theirs with a 64-bit atomicMax of ~key into the lane's scratch slot
// {~key, ticket} (0 = empty), and the lane's last CTA writes (idx, val)
// and leaves the slot zeroed (rows::fold_key).  A minimum does not depend
// on the order in which CTAs arrive, so the result is deterministic and
// bit-exact; a call is this one kernel.  Static shared memory only (the
// warps' minima), so no attribute is ever set.
// What bounds it: the active rows read, p * w * 4 bytes per lane (bytes);
// at the engines' sizes the launch latency and one round of loads.
#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

enum Kind { DENSE = 0, PACKED = 1, PREFIX = 2 };
using rows::NONE;

// kernels/fused_select/ops.py:_ARGS, field for field (8 bytes each)
struct SelectArgs {
  const uint32_t* adj;
  const uint32_t* mask;
  const int* idx;
  const int* act;
  int* out_idx;
  int* out_val;
  unsigned long long* scratch;  // {~key, ticket} per lane, zero between
  void* stream;                 // launches
  long long adj_stride, n_adj, n, w, kind, lanes;
  long long rows, threads, group, units, chunk, nchunks, vec;
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(rows::FULL, k, off);
    k = o < k ? o : k;
  }
  return k;
}

template <int KIND, bool VEC, int CHUNK>
__global__ void __launch_bounds__(rows::MAX_THREADS)
    fused_select_kernel(const SelectArgs a) {
  __shared__ unsigned long long red[rows::MAX_THREADS / 32];
  const int b = blockIdx.y;
  const int n = static_cast<int>(a.n);
  const int R = static_cast<int>(a.rows);
  const int row0 = blockIdx.x * R;
  const long long nw = (n + 31) / 32;
  const int bound = KIND == PREFIX ? a.act[b] : n;
  unsigned long long best = NONE;
  if (row0 < bound) {           // uniform over the CTA
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
      bool on = j < t.rpg && pos < n;
      if (on) {
        if (KIND == DENSE)
          on = a.act[a.n * b + pos] > 0;
        else if (KIND == PACKED)
          on = (static_cast<uint32_t>(a.act[b * nw + (pos >> 5)]) >>
                (pos & 31)) & 1u;
        else
          on = pos < bound;
      }
      rr[j] = on ? rows::gather(I, pos, static_cast<int>(a.n_adj)) : -1;
    }
    uint32_t acc[rows::RMAX];
    rows::group_counts<VEC, CHUNK>(A, M, a.w, t, rr, acc);
    if (t.gl == 0) {
#pragma unroll
      for (int j = 0; j < rows::RMAX; ++j) {
        const unsigned long long key =
            rr[j] >= 0 ? (static_cast<unsigned long long>(acc[j]) << 32) |
                             static_cast<uint32_t>(row0 + rows::local_row(t, j))
                       : NONE;
        best = key < best ? key : best;
      }
    }
    best = warp_min(best);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : NONE;
      best = warp_min(best);
    }
  }
  if (threadIdx.x == 0 && rows::fold_key(a.scratch + 2 * b, best)) {
    a.out_idx[b] = best == NONE ? -1 : static_cast<int>(best & 0xFFFFFFFFu);
    a.out_val[b] = best == NONE ? INT_MAX : static_cast<int>(best >> 32);
  }
}

using Kernel = void (*)(const SelectArgs);

template <int KIND, bool VEC>
Kernel pick_chunk(long long chunk) {
  switch (chunk) {
    case 1: return fused_select_kernel<KIND, VEC, 1>;
    case 2: return fused_select_kernel<KIND, VEC, 2>;
    case 4: return fused_select_kernel<KIND, VEC, 4>;
    case 8: return fused_select_kernel<KIND, VEC, 8>;
    default: return nullptr;
  }
}

template <int KIND>
Kernel pick_vec(const SelectArgs& a) {
  return a.vec ? pick_chunk<KIND, true>(a.chunk)
               : pick_chunk<KIND, false>(a.chunk);
}

bool plan_ok(const SelectArgs& a) {
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

// One launch of K4 over every lane; `args` points at a SelectArgs (read
// with memcpy: the caller's buffer need not be aligned).
extern "C" int rt_fused_select(const void* args) {
  SelectArgs a;
  std::memcpy(&a, args, sizeof a);
  if (!plan_ok(a) || a.kind < 0 || a.kind > 2 || a.scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = a.kind == DENSE    ? pick_vec<DENSE>(a)
                      : a.kind == PACKED ? pick_vec<PACKED>(a)
                                         : pick_vec<PREFIX>(a);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.n + a.rows - 1) / a.rows),
                  static_cast<unsigned>(a.lanes));
  kern<<<grid, static_cast<unsigned>(a.threads), 0,
         static_cast<cudaStream_t>(a.stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
