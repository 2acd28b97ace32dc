// Fused check/partition kernel (K1), every activity kind.
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
// part = p & 0 < c < |L'|, nz = c > 0 (activity-independent, so every
// row is counted), plus the counts themselves when asked.
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
// Design (the row tiles of rows.cuh): grid (ceil(n / rows), lanes), a CTA
// a tile of `rows` positions (32 by default, dispatch.plan_rows), `group`
// threads a row with the mask slice in registers and every load of the
// thread's rows in flight at once.  The group leaders put the tile's
// counts in shared memory (4 B a row), one barrier, then thread t derives
// row t's flags: in the packed kind one __ballot_sync per warp gives word
// (row / 32) in bitset.from_bool order, in the other kinds each thread
// writes its row's bytes.  The violation flag is ORed over the CTA
// (__syncthreads_or) and then over the lane's CTAs through the scratch
// slot {flag, ticket} (rows::fold_flag): the lane's last CTA writes the
// bool output straight and leaves the slot zeroed, so a call is this one
// kernel, with no fill before it and no compare after it.  The dynamic
// shared-memory attribute is never set: a CTA uses 1 KB of static shared
// memory.  Rows >= n are inactive and their bits never leave the kernel
// (the reference pads rows and slices the words back).
// What bounds it: at the engines' sizes the launch latency and one round
// of loads; the rows read, n * w * 4 bytes per lane (bytes), only at
// widths far past the residency gate.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

enum Kind { PACKED = 0, DENSE = 1, PREFIX2 = 2 };

// kernels/fused_check/ops.py:_ARGS, field for field (8 bytes each)
struct CheckArgs {
  const uint32_t* adj;
  const uint32_t* mask;
  const int* n_mask;
  const int* idx;
  const int* q;
  const int* p;
  uint8_t* viol;
  void* full;
  void* part;
  void* nz;
  int* counts;
  int* scratch;       // {flag, ticket} per lane, zero between launches
  void* stream;
  long long adj_stride, n_adj, n, w, kind, split, lanes;
  long long rows, threads, group, units, chunk, nchunks, vec;
};

template <int KIND, bool VEC, int CHUNK>
__global__ void __launch_bounds__(rows::MAX_THREADS)
    fused_check_kernel(const CheckArgs a) {
  __shared__ int cnt[rows::MAX_ROWS];
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

  // counts of this tile's rows
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
      if (j < t.rpg) cnt[rows::local_row(t, j)] = static_cast<int>(acc[j]);
  }
  __syncthreads();

  // flags of row threadIdx.x (threads >= rows: whole warps, idle here)
  const int nlp = a.n_mask[b];
  const long long nw = (n + 31) / 32;
  bool any_viol = false;
  if (threadIdx.x < R) {
    const int row = row0 + threadIdx.x;
    const bool valid = row < n;
    const int c = valid ? cnt[threadIdx.x] : 0;
    const long long at = a.n * b + row;
    bool qb, pb;
    if (KIND == PACKED) {
      const int word = row >> 5;
      qb = valid && ((static_cast<uint32_t>(a.q[b * nw + word]) >>
                      (row & 31)) & 1u);
      pb = valid && ((static_cast<uint32_t>(a.p[b * nw + word]) >>
                      (row & 31)) & 1u);
    } else if (KIND == DENSE) {
      qb = valid && a.q[at] > 0;
      pb = valid && a.p[at] > 0;
    } else {
      const int split = static_cast<int>(a.split);
      qb = valid && row < split && row < a.q[b];
      pb = valid && row >= split && row - split < a.p[b];
    }
    const bool eq = c == nlp;
    any_viol = qb && eq;
    const bool fb = pb && eq;
    const bool pt = pb && c > 0 && c < nlp;
    const bool zb = valid && c > 0;
    if (KIND == PACKED) {
      const int word = row >> 5;
      const unsigned fw = __ballot_sync(rows::FULL, fb);
      const unsigned pw = __ballot_sync(rows::FULL, pt);
      const unsigned zw = __ballot_sync(rows::FULL, zb);
      if ((threadIdx.x & 31) == 0 && word < nw) {
        static_cast<uint32_t*>(a.full)[b * nw + word] = fw;
        static_cast<uint32_t*>(a.part)[b * nw + word] = pw;
        static_cast<uint32_t*>(a.nz)[b * nw + word] = zw;
      }
    } else if (valid) {
      static_cast<uint8_t*>(a.full)[at] = fb;
      static_cast<uint8_t*>(a.part)[at] = pt;
      static_cast<uint8_t*>(a.nz)[at] = zb;
    }
    if (a.counts != nullptr && valid) a.counts[at] = c;
  }
  const bool viol = __syncthreads_or(any_viol);
  if (threadIdx.x == 0) rows::fold_flag(a.scratch + 2 * b, viol, a.viol + b);
}

using Kernel = void (*)(const CheckArgs);

template <int KIND, bool VEC>
Kernel pick_chunk(long long chunk) {
  switch (chunk) {
    case 1: return fused_check_kernel<KIND, VEC, 1>;
    case 2: return fused_check_kernel<KIND, VEC, 2>;
    case 4: return fused_check_kernel<KIND, VEC, 4>;
    case 8: return fused_check_kernel<KIND, VEC, 8>;
    default: return nullptr;
  }
}

template <int KIND>
Kernel pick_vec(const CheckArgs& a) {
  return a.vec ? pick_chunk<KIND, true>(a.chunk)
               : pick_chunk<KIND, false>(a.chunk);
}

bool plan_ok(const CheckArgs& a) {
  const long long R = a.rows, T = a.threads, G = a.group;
  const bool pow2 = G >= 1 && G <= 32 && (G & (G - 1)) == 0;
  return a.lanes >= 1 && a.lanes <= rows::MAX_LANES && a.n >= 1 &&
         a.n_adj >= 1 && a.w >= 1 && a.n < (1ll << 31) && R >= 32 &&
         R % 32 == 0 && R <= rows::MAX_ROWS && T >= 32 && T % 32 == 0 &&
         T <= rows::MAX_THREADS && T >= R && pow2 && T % G == 0 &&
         R % (T / G) == 0 && R / (T / G) <= rows::RMAX &&
         a.units == (a.vec ? a.w / 4 : a.w) &&
         (!a.vec || rows::aligned16(a.adj, a.mask, a.w, a.adj_stride)) &&
         a.nchunks >= 1 && a.chunk * a.nchunks * G >= a.units &&
         (a.n + R - 1) / R < (1ll << 31);
}

}  // namespace

// One launch of K1 over every lane; `args` points at a CheckArgs (read
// with memcpy: the caller's buffer need not be aligned).
extern "C" int rt_fused_check(const void* args) {
  CheckArgs a;
  std::memcpy(&a, args, sizeof a);
  if (!plan_ok(a) || a.kind < 0 || a.kind > 2 || a.scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = a.kind == PACKED ? pick_vec<PACKED>(a)
                      : a.kind == DENSE ? pick_vec<DENSE>(a)
                                        : pick_vec<PREFIX2>(a);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.n + a.rows - 1) / a.rows),
                  static_cast<unsigned>(a.lanes));
  kern<<<grid, static_cast<unsigned>(a.threads), 0,
         static_cast<cudaStream_t>(a.stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
