// Row helpers shared by the AND+popcount kernels (fused_check.cu,
// fused_select.cu, intersect_count.cu).
//
// The row-tile design of K1 (fused_check.cu), K4 (fused_select.cu) and K5
// (intersect_count.cu):
//
//   * Tiles.  A CTA owns `rows` consecutive row positions of one lane
//     (grid (ceil(n / rows), lanes)); `rows` is a multiple of 32, so a
//     tile starts on a packed word and one warp's ballot writes whole
//     words.  dispatch.plan_rows picks it (32 rows by default: 32 CTAs at
//     2 lanes x 512 rows instead of 4) and the thread count.
//   * Groups.  `group` threads (a power of two up to a warp) reduce one
//     row; lane gl of a group loads units gl, gl + group, ... of the row,
//     a unit being 16 bytes (uint4) where w % 4 == 0 and the operands are
//     16-byte aligned, else one word.  Group gi of a CTA's ng groups owns
//     the tile's rows gi, gi + ng, ... (rpg <= RMAX of them), so the
//     groups of a warp read neighbouring rows.
//   * Loads in flight.  A thread keeps its slice of the L' mask in
//     registers (`chunk` units of it; a row of more than chunk x group
//     units is walked in chunks, the mask slice reloaded per chunk) and
//     issues the loads of all its rows of a chunk before it counts any
//     of them (at most LOADS units at once), so a tile costs one round of
//     dependent global loads, not one per row.  No shared-memory copy of
//     the mask and no barrier before counting.
//   * The fold across CTAs (fold_flag, fold_key; K1 and K4 only).  Each
//     CTA folds its own result, then one thread ORs it (K1) or
//     max-combines its inverted key (K4) into the lane's slot of a scratch
//     buffer and takes a ticket (atomicAdd after __threadfence); the
//     lane's last CTA reads the slot back, writes the output, and resets
//     the slot and the ticket to 0.  The scratch is a zeroed int32 buffer
//     the wrapper allocates once per (device, stream) (dispatch.row_scratch)
//     and the kernels leave zeroed after every launch, so a call is one
//     kernel and allocates nothing.  Launches on one stream run in order;
//     another stream has its own buffer.  OR and max do not depend on the
//     order in which CTAs arrive, so the outputs are deterministic.  K5
//     writes each row's count where it is counted and needs no fold.
//
// What bounds K1, K4 and K5 now: at the engines' sizes (<= 2 x 1024 rows
// of <= 128 words) the launch latency and the one round of loads, a few
// microseconds; the rows read (bytes) only far past the residency gate.
#pragma once

#include <cstdint>

namespace rows {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int RMAX = 8;          // rows a thread group owns in a tile, at most
constexpr int LOADS = 8;         // units a thread keeps in flight
constexpr int MAX_THREADS = 512;
constexpr int MAX_ROWS = 256;    // rows a CTA, at most
constexpr int MAX_LANES = 65535; // grid.y

// Row of position i: i itself, or idx[i] under JAX's gather rule (a
// negative index wraps once, then it is clamped into [0, n_adj)).
__device__ __forceinline__ int gather(const int* idx, long long i,
                                      int n_adj) {
  if (idx == nullptr) return static_cast<int>(i);
  int r = idx[i];
  if (r < 0) r += n_adj;
  return r < 0 ? 0 : (r >= n_adj ? n_adj - 1 : r);
}

// ---- the row-tile pass of K1, K4 and K5 ----------------------------------

template <bool VEC>
struct Units;

template <>
struct Units<true> {             // 16 bytes a load
  using T = uint4;
  static __device__ __forceinline__ T load(const uint32_t* p, int u) {
    return __ldg(reinterpret_cast<const uint4*>(p) + u);
  }
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ uint32_t count(T a, T m) {
    return __popc(a.x & m.x) + __popc(a.y & m.y) + __popc(a.z & m.z) +
           __popc(a.w & m.w);
  }
};

template <>
struct Units<false> {            // one word a load
  using T = uint32_t;
  static __device__ __forceinline__ T load(const uint32_t* p, int u) {
    return __ldg(p + u);
  }
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ uint32_t count(T a, T m) {
    return __popc(a & m);
  }
};

// This thread's place in its tile.
struct Tile {
  int G;        // threads a row
  int gl;       // lane in the group
  int gi;       // group in the CTA
  int ng;       // groups in the CTA
  int rpg;      // rows of the group (<= RMAX)
  int units;    // units a row
  int nchunks;  // chunks of `chunk` units a thread walks a row in
};

__device__ __forceinline__ Tile tile(int group, int rows_cta, int units,
                                     int nchunks) {
  Tile t;
  t.G = group;
  t.gl = threadIdx.x & (group - 1);
  t.gi = threadIdx.x / group;
  t.ng = blockDim.x / group;
  t.rpg = rows_cta / t.ng;
  t.units = units;
  t.nchunks = nchunks;
  return t;
}

// Tile-local row of the group's j-th row.
__device__ __forceinline__ int local_row(const Tile& t, int j) {
  return t.gi + j * t.ng;
}

// acc[j] = popcount(adj row rr[j] & mask) for the group's rows j < rpg,
// summed over the group (every lane of it gets the sum); rr[j] < 0: the
// row is not read and counts 0.  Every thread of a warp runs the same
// loops (rpg, G and nchunks are uniform over the CTA), so the shuffles
// are safe.
template <bool VEC, int CHUNK>
__device__ __forceinline__ void group_counts(const uint32_t* A,
                                             const uint32_t* M, long long w,
                                             const Tile& t,
                                             const int (&rr)[RMAX],
                                             uint32_t (&acc)[RMAX]) {
  using U = Units<VEC>;
  constexpr int RB = LOADS / CHUNK;  // rows a batch of loads
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0;
  for (int c = 0; c < t.nchunks; ++c) {
    typename U::T mk[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int u = (c * CHUNK + k) * t.G + t.gl;
      mk[k] = u < t.units ? U::load(M, u) : U::zero();
    }
#pragma unroll
    for (int j0 = 0; j0 < RMAX; j0 += RB) {
      if (j0 >= t.rpg) break;
      typename U::T v[RB][CHUNK];
#pragma unroll
      for (int jj = 0; jj < RB; ++jj) {
        const int r = rr[j0 + jj];
        const uint32_t* row = A + static_cast<long long>(r < 0 ? 0 : r) * w;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const int u = (c * CHUNK + k) * t.G + t.gl;
          v[jj][k] = (r >= 0 && u < t.units) ? U::load(row, u) : U::zero();
        }
      }
#pragma unroll
      for (int jj = 0; jj < RB; ++jj)
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          acc[j0 + jj] += U::count(v[jj][k], mk[k]);
    }
  }
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j >= t.rpg) break;
    for (int off = t.G >> 1; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(FULL, acc[j], off);
  }
}

// Whether 16-byte units may be read: every row and mask starts on 16 bytes.
inline bool aligned16(const uint32_t* adj, const uint32_t* mask,
                      long long w, long long adj_stride) {
  return w % 4 == 0 && adj_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(adj) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(mask) % 16 == 0;
}

// ---- the fold across a lane's CTAs (one thread of each CTA) ----------------

// K1: OR `flag` into the lane's scratch word; the lane's last CTA writes
// the bool and resets the word and the ticket.  slot = {flag, ticket}.
__device__ __forceinline__ void fold_flag(int* slot, bool flag,
                                          uint8_t* out) {
  if (flag) atomicOr(slot, 1);
  __threadfence();
  const unsigned t = atomicAdd(reinterpret_cast<unsigned*>(slot + 1), 1u);
  if (t == gridDim.x - 1) {
    __threadfence();
    *out = atomicExch(slot, 0) != 0;
    atomicExch(slot + 1, 0);
  }
}

constexpr unsigned long long NONE = ~0ull;

// K4: the smallest key of the lane, kept inverted (max of ~key) so that
// 0 is the empty slot; the lane's last CTA returns the key (NONE when no
// CTA had one) and resets the slot and the ticket.  slot = {~key, ticket}.
// Returns false on every CTA but the last.
__device__ __forceinline__ bool fold_key(unsigned long long* slot,
                                         unsigned long long& key) {
  if (key != NONE) atomicMax(slot, ~key);
  __threadfence();
  const unsigned long long t = atomicAdd(slot + 1, 1ull);
  if (t != gridDim.x - 1) return false;
  __threadfence();
  key = ~atomicExch(slot, 0ull);
  atomicExch(slot + 1, 0ull);
  return true;
}

}  // namespace rows
