// One dense-engine lane advanced IN PLACE by up to `spc` guarded engine
// steps: the __device__ body shared by the single-lane kernel
// (resident_step.cu) and the pool kernel (resident_pool.cu), and the host
// launcher both use.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/resident_step/kernel.py:resident_kernel
// (and, through the pool entry, resident_pool/kernel.py:
// resident_pool_kernel), with the same semantics bit for bit: the step of
// src/repro/core/engine_dense.py iterated under the run loop's guard
// `~done & (steps - start < budget)`, the three order modes, the write
// order of `_apply_delta` (including child == lvl_safe at the last
// level), `cstack[child]` written on descent in every order mode, and
// uint32 wraparound in the fingerprint `cs`.
//
// Design for Hopper.
//   * In place.  The TPU kernel is functional because XLA makes it so; the
//     port's run loops own the packed state, so a launch advances the
//     stacks it is handed and copies nothing.  The functional entries
//     clone once on the host, then launch in place.
//   * The stacks live in device memory (one lane's cstack alone is
//     4*(n_u+2)*n_u bytes, 1 MB at n_u = 512, past a block's 227 KB).  The
//     current level's rows (L, P, Q, R and its cstack row) stay in shared
//     memory across the steps of a segment: every write goes through to
//     device memory at once, so the state at the segment's end is exact,
//     and rows are read back only at the segment's start and on
//     backtrack.  A descent swaps double buffers (L/L', P/P', R/R', the
//     cstack row and the new counts); Q is updated in place.
//   * The adjacency is staged in shared memory by one TMA bulk copy
//     (cp.async.bulk + an mbarrier), issued first and waited for only at
//     the first step that reads it, so it overlaps loading the cursor and
//     the level's rows and, in 'deg' mode, the first selection.
//   * One lane per thread row: warp w owns 32-row chunks w, w + nwarps,
//     ...; lane l counts row 32k + l alone (AND + popcount over the row's
//     16-byte chunks, starting at chunk l mod n so the 8 lanes of a
//     shared-memory phase hit 8 bank quads) and the warp's ballots give
//     the full / part / nz words at once.  The same lane always handles
//     the same row, lane 0 of the owning warp the same mask word, thread
//     w the same V-side word, so most hand-offs between steps need no
//     barrier at all.
//   * Barriers per step (block-wide): a candidate step 3 (selection
//     argmin, |L'| with L's checksum, and one OR of viol / has_part / P'
//     nonempty joined with R's checksum; 2 when forced), backtrack and
//     root-task init 1 (P nonempty after a reload), plus one per launch.
//     The old body took ~20 per candidate step.  Each reduction is one
//     redux per 32-bit word within the warp, one barrier, and a second
//     redux over the per-warp partials (one per lane); sites alternate so
//     no trailing barrier is needed.
//   * Adjacencies that do not fit one CTA (1024 x 4096: 512 KB) are split
//     over a thread-block cluster of the fewest CTAs whose shared memory
//     holds them (resident_step/ops.py:resident_cluster).  Rank r owns
//     rows [r*rl, (r+1)*rl): their counts, flags, mask words and cstack
//     entries, read and written by r alone.  L and L' are whole in every
//     CTA (L' = L & A[x], the A[x] row read through distributed shared
//     memory), and V-side rows are written by every CTA (identical
//     values), so each CTA only ever reads back what it wrote itself.
//     The argmin and the OR / checksum reduction cross the cluster: each
//     CTA's partial goes to its own slot and, after barrier.cluster, every
//     thread combines the slots of all ranks.
//   * An adjacency that fits no cluster of 8 is read from device memory
//     (L2) by one CTA (STAGED = false).
//   * Threads: one warp per 32 rows of the CTA's slice, 128 to 512
//     (resident_step/ops.py:lane_threads): 512 at 512 x 2048, 256 a CTA
//     in the 1024 x 4096 cluster, the fastest of 128 / 256 / 512 in
//     chip_smoke.py's sweep (PERF.md section 6).
// What bounds it: per step one AND + popcount pass over the lane's rows
// of the adjacency (two in 'deg_nocache'): n_u*w_v popcounts at 16 per
// clock per SM, and as many shared-memory bytes; then latency (barriers,
// the write-through of the child's rows).  One CTA (or cluster) per lane
// leaves most SMs idle for small pools.
#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace rt {

namespace cg = cooperative_groups;
typedef unsigned long long u64;

enum : int {
  S_LVL = 0, S_FORCED, S_TPOS, S_STEPS, S_NODES, S_NMAX, S_MAXFAIL, S_CS,
  S_OUTN, S_NTASKS, S_START, S_BUDGET, SCAL_SLOTS = 16
};
enum : int { MODE_DEG = 0, MODE_NOCACHE = 1, MODE_INPUT = 2 };
constexpr int INF = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_DEVICES = 16;

// The launch arguments, built once per run loop on the host
// (kernels/resident_step/ops.py:LaneArgs mirrors it field for field).
struct LaneArgs {
  int* scal;                 // (lanes, 16) cursor block, advanced in place
  const uint32_t* adj;       // (NU, WV), per lane when ctx_batched
  const int* order;
  const int* rank;
  const int* rc;
  const uint32_t* lroot;
  const int* tasks;          // (lanes, t_len)
  uint32_t* lmask;           // (lanes, D, WV)
  int* cstack;               // (lanes, D, NU)
  uint32_t* pmask;           // (lanes, D, WU)
  uint32_t* qmask;
  uint32_t* rmask;
  int* xstack;               // (lanes, D)
  uint32_t* outl;            // (lanes, C, WV)
  uint32_t* outr;            // (lanes, C, WU)
  int* board;                // (lanes, 2) scoreboard, or null
  int* flag;                 // host-mapped word set to `seq` when a lane is
  //                            still active after the launch, or null
  int nu, wu, wv, depth, cap, t_len, m_real, order_mode, spc;
  int ctx_batched, lanes, threads, cluster, staged, smem_bytes;
};

// Shared-memory layout of a CTA owning rl rows (byte offsets; mirrored by
// kernels/resident_step/ops.py:_smem_base):
//   [0, 640)      u64 red[5][16]   per-warp partials of the 5 reduction sites
//   [640, 680)    u64 cta[5]       the CTA's partial per site (cluster reads)
//   [680, 688)    u64 mbar         the adjacency copy's barrier
//   [704, ...)    words Lb[2*wv] Pb[2*wl] Q[wl] Rb[2*wl] NZ[wl], int Cb[2*rl]
//   (16-aligned)  A[rl*wv] when staged
constexpr int SITES = 5;
constexpr int HEAD_BYTES = 704;
enum : int { SITE_SEL = 0, SITE_CNT, SITE_FLAGS, SITE_MISC };  // MISC: 3, 4

__host__ __device__ inline int smem_base_bytes(int rl, int wv) {
  const int wl = (rl + 31) / 32;
  const int b = HEAD_BYTES + 4 * (2 * wv + 6 * wl + 2 * rl);
  return (b + 15) / 16 * 16;
}

struct Smem {
  u64* red;
  u64* cta;
  uint64_t* mbar;
  uint32_t *Lb, *Pb, *Q, *Rb, *NZ;
  int* Cb;
  uint32_t* A;
};

__device__ inline Smem smem_layout(char* base, int rl, int wv) {
  const int wl = (rl + 31) / 32;
  Smem s;
  s.red = reinterpret_cast<u64*>(base);
  s.cta = s.red + SITES * MAX_WARPS;
  s.mbar = reinterpret_cast<uint64_t*>(s.cta + SITES);
  uint32_t* w = reinterpret_cast<uint32_t*>(base + HEAD_BYTES);
  s.Lb = w; w += 2 * wv;
  s.Pb = w; w += 2 * wl;
  s.Q = w; w += wl;
  s.Rb = w; w += 2 * wl;
  s.NZ = w; w += wl;
  s.Cb = reinterpret_cast<int*>(w);
  s.A = reinterpret_cast<uint32_t*>(base + smem_base_bytes(rl, wv));
  return s;
}

// ---- reductions (every thread of every CTA of the cluster calls them) ---

enum : int { OP_MIN = 0, OP_ADD = 1, OP_ORADD = 2 };

// A reduced value is a (hi, lo) pair of 32-bit words.  OP_MIN: the pair
// as one u64 (hi first).  OP_ADD: both words summed mod 2**32.  OP_ORADD:
// hi summed mod 2**32, lo OR'd.  One warp combines with the redux
// instructions (one each, no shuffle tree).
template <int OP>
__device__ __forceinline__ u64 warp_combine(u64 v) {
  uint32_t hi = static_cast<uint32_t>(v >> 32);
  uint32_t lo = static_cast<uint32_t>(v);
  if (OP == OP_MIN) {
    const uint32_t h = __reduce_min_sync(FULL, hi);
    lo = __reduce_min_sync(FULL, hi == h ? lo : 0xFFFFFFFFu);
    hi = h;
  } else {
    hi = __reduce_add_sync(FULL, hi);
    lo = OP == OP_ADD ? __reduce_add_sync(FULL, lo)
                      : __reduce_or_sync(FULL, lo);
  }
  return (static_cast<u64>(hi) << 32) | lo;
}

template <int OP>
__device__ __forceinline__ u64 identity() {
  return OP == OP_MIN ? ~0ull : 0ull;
}

// One barrier (and one barrier.cluster in a cluster): each warp's partial
// to its slot, then every warp combines the slots (one per lane), and in
// a cluster the CTAs' partials the same way (one remote read per lane).
// A site's slots are written again only after another barrier has
// passed, which the step order guarantees (see the note at the top).
template <int OP>
__device__ u64 reduce(u64 v, const Smem& s, int site, int cl) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  v = warp_combine<OP>(v);
  u64* r = s.red + site * MAX_WARPS;
  if (lane == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_combine<OP>(lane < nw ? r[lane] : identity<OP>());
  if (cl == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) s.cta[site] = v;
  cluster.sync();
  return warp_combine<OP>(
      lane < cl ? *cluster.map_shared_rank(s.cta + site, lane)
                : identity<OP>());
}

// ---- helpers ------------------------------------------------------------

// word w of the packed singleton {x}; empty for x < 0 (C's `/` and `%`
// truncate toward zero, so -1 would otherwise hit bit -1 of word 0)
__device__ __forceinline__ uint32_t singleton_word(int x, int w) {
  if (x < 0) return 0u;
  return (w == (x >> 5)) ? (1u << (x & 31)) : 0u;
}

// bitset.checksum's per-word term
__device__ __forceinline__ uint32_t checksum_term(uint32_t word, int w) {
  uint32_t mult = static_cast<uint32_t>(w) * 0x9E3779B9u + 0x85EBCA6Bu;
  uint32_t h = word * mult;
  h ^= h >> 15;
  h *= 0x2545F491u;
  h ^= h >> 13;
  return h;
}

// popcount(a & m) over one row of wv words.  The calling lane starts at
// chunk `lane mod n` and wraps, so the lanes of a warp (each on its own
// row) read different bank quads.  vec: 16-byte chunks (wv % 4 == 0 and
// a, m 16-byte aligned), else single words.
__device__ __forceinline__ int row_count(const uint32_t* a, const uint32_t* m,
                                         int wv, int lane, bool vec) {
  int c = 0;
  if (vec) {
    const int n = wv >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
    int j = lane % n;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const uint4 x = a4[j], y = m4[j];
      c += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
           __popc(x.w & y.w);
      j = j + 1 == n ? 0 : j + 1;
    }
  } else {
    int j = lane % wv;
    for (int t = 0; t < wv; ++t) {
      c += __popc(a[j] & m[j]);
      j = j + 1 == wv ? 0 : j + 1;
    }
  }
  return c;
}

// one lane's operands inside the (lanes, ...) arrays
struct Lane {
  int* scal;
  const uint32_t* adj;
  const int* order;
  const int* rank;
  const int* rc;
  const uint32_t* lroot;
  const int* tasks;
  uint32_t* lmask;
  int* cstack;
  uint32_t* pmask;
  uint32_t* qmask;
  uint32_t* rmask;
  int* xstack;
  uint32_t* outl;
  uint32_t* outr;
};

__device__ inline Lane lane_operands(const LaneArgs& a, int b) {
  const long D = a.depth, nu = a.nu, wu = a.wu, wv = a.wv, C = a.cap;
  const long cb = a.ctx_batched ? b : 0;
  Lane l;
  l.scal = a.scal + static_cast<long>(b) * SCAL_SLOTS;
  l.adj = a.adj + cb * nu * wv;
  l.order = a.order + cb * nu;
  l.rank = a.rank + cb * nu;
  l.rc = a.rc + cb * nu;
  l.lroot = a.lroot + cb * wv;
  l.tasks = a.tasks + static_cast<long>(b) * a.t_len;
  l.lmask = a.lmask + b * D * wv;
  l.cstack = a.cstack + b * D * nu;
  l.pmask = a.pmask + b * D * wu;
  l.qmask = a.qmask + b * D * wu;
  l.rmask = a.rmask + b * D * wu;
  l.xstack = a.xstack + b * D;
  l.outl = a.outl + b * C * wv;
  l.outr = a.outr + b * C * wu;
  return l;
}

// ---- the segment ---------------------------------------------------------

// Lane b, cluster rank `rank` of `cl`.  STAGED: the adjacency (this CTA's
// rows of it) lives in shared memory.
template <bool STAGED>
__device__ void lane_segment(const LaneArgs& a, const int b, const int cl,
                             const int rank, const int seq, char* raw) {
  const Lane g = lane_operands(a, b);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int nu = a.nu, wu = a.wu, wv = a.wv, D = a.depth, C = a.cap;
  const int rl = nu / cl, wl = (rl + 31) >> 5;
  const int row0 = rank * rl, word0 = rank * wl;
  const Smem s = smem_layout(raw, rl, wv);

  // stage this CTA's rows of the adjacency: one bulk copy, waited for at
  // the first step that reads it
  bool adj_ready = !STAGED;
  const uint32_t* A = STAGED ? s.A : g.adj;
  if (STAGED) {
    const uint32_t* src = g.adj + static_cast<long>(row0) * wv;
    const uint32_t bytes = 4u * static_cast<uint32_t>(rl) * wv;
    if (bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      if (tid == 0) {
        hopper::mbar_init(s.mbar, 1);
        hopper::mbar_fence_init();
        hopper::mbar_expect_tx(s.mbar, bytes);
        hopper::bulk_load(s.A, src, bytes, s.mbar);
      }
    } else {
      for (long i = tid; i < static_cast<long>(rl) * wv; i += nt)
        s.A[i] = src[i];
      adj_ready = true;     // published by the prologue's barrier
    }
  }
  const bool vec = (wv & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(A) & 15) == 0;

  // the cursor, in registers (every thread of every CTA holds the same)
  int lvl = g.scal[S_LVL], forced_x = g.scal[S_FORCED];
  int tpos = g.scal[S_TPOS], steps = g.scal[S_STEPS];
  int nodes = g.scal[S_NODES], n_max = g.scal[S_NMAX];
  int max_fail = g.scal[S_MAXFAIL], out_n = g.scal[S_OUTN];
  uint32_t cs = static_cast<uint32_t>(g.scal[S_CS]);
  const int n_tasks = g.scal[S_NTASKS], start = g.scal[S_START];
  const int budget = g.scal[S_BUDGET];
  const int steps0 = steps;
  int cur = 0;          // which half of each double buffer is current
  int misc = 0;         // alternates the two MISC reduction sites

  // rows of level `lev` from device memory into the current buffers; the
  // backtrack's x (>= 0) joins Q there and in device memory.  Returns
  // this thread's "P nonempty" bit.
  auto load_level = [&](int lev, int x) -> uint32_t {
    const long lr = lev < D - 1 ? lev : D - 1;
    uint32_t* L = s.Lb + cur * wv;
    for (int w = tid; w < wv; w += nt) L[w] = g.lmask[lr * wv + w];
    int* Cc = s.Cb + cur * rl;
    uint32_t bits = 0;
    for (int kk = warp; kk < wl; kk += nw) {
      const int i = 32 * kk + lane;
      if (i < rl) Cc[i] = g.cstack[lr * nu + row0 + i];
      if (lane == 0) {
        const int k = word0 + kk;
        const uint32_t p = g.pmask[lr * wu + k];
        s.Pb[cur * wl + kk] = p;
        s.Rb[cur * wl + kk] = g.rmask[lr * wu + k];
        uint32_t q = g.qmask[lr * wu + k];
        if (x >= 0 && (x >> 5) == k) {
          q |= 1u << (x & 31);
          g.qmask[lr * wu + k] = q;
        }
        s.Q[kk] = q;
        bits |= p != 0u;
      }
    }
    return bits;
  };

  uint32_t pbits = lvl >= 0 ? load_level(lvl, -1) : 0u;
  if (STAGED && cl > 1) {       // every slice staged before A[x] is read
    __syncthreads();            // the barrier's init, seen by every waiter
    hopper::mbar_wait(s.mbar, 0);
    adj_ready = true;
  }
  bool p_nonempty = reduce<OP_ORADD>(pbits, s, SITE_MISC + misc, cl) & 1u;
  misc ^= 1;

  for (int it = 0; it < a.spc; ++it) {
    const bool done = lvl < 0 && tpos >= n_tasks;
    if (done || !(steps - start < budget)) break;   // uniform
    __syncwarp();

    if (lvl < 0) {
      // ---- initialise the next root task -------------------------------
      const int ti = tpos < a.t_len - 1 ? tpos : a.t_len - 1;
      const int idx = g.tasks[ti];
      const int ci = idx < 0 ? 0 : (idx > nu - 1 ? nu - 1 : idx);
      const int x = g.order[ci];
      uint32_t* L = s.Lb + cur * wv;
      for (int w = tid; w < wv; w += nt) {
        const uint32_t v = g.lroot[w];
        L[w] = v;
        g.lmask[w] = v;
      }
      int* Cc = s.Cb + cur * rl;
      uint32_t bits = 0;
      for (int kk = warp; kk < wl; kk += nw) {
        const int i = 32 * kk + lane;
        const bool valid = i < rl;
        const int rk = valid ? g.rank[row0 + i] : 0;
        if (valid) {
          const int v = g.rc[row0 + i];
          Cc[i] = v;
          g.cstack[row0 + i] = v;
        }
        const uint32_t pw = __ballot_sync(FULL, valid && rk > idx &&
                                                    rk < a.m_real);
        const uint32_t qw = __ballot_sync(FULL, valid && rk < idx);
        if (lane == 0) {
          const int k = word0 + kk;
          s.Pb[cur * wl + kk] = pw;
          s.Q[kk] = qw;
          s.Rb[cur * wl + kk] = 0u;
          g.pmask[k] = pw;
          g.qmask[k] = qw;
          g.rmask[k] = 0u;
          bits |= pw != 0u;
        }
      }
      p_nonempty = reduce<OP_ORADD>(bits, s, SITE_MISC + misc, cl) & 1u;
      misc ^= 1;
      lvl = 0;
      forced_x = x;
      tpos += 1;
      steps += 1;
    } else if (!p_nonempty && forced_x < 0) {
      // ---- backtrack: x moves to Q at the parent level ----------------
      const int nl = lvl - 1;
      if (nl >= 0) {
        int x = lane == 0 ? g.xstack[nl < D - 1 ? nl : D - 1] : 0;
        x = __shfl_sync(FULL, x, 0);
        const uint32_t bits = load_level(nl, x > 0 ? x : 0);
        p_nonempty = reduce<OP_ORADD>(bits, s, SITE_MISC + misc, cl) & 1u;
        misc ^= 1;
      }
      lvl = nl;
      steps += 1;
    } else {
      // ---- process a candidate ----------------------------------------
      const bool forced = forced_x >= 0;
      const int lrow = lvl < D - 1 ? lvl : D - 1;
      const uint32_t* L = s.Lb + cur * wv;
      uint32_t* Lp = s.Lb + (cur ^ 1) * wv;
      uint32_t* P = s.Pb + cur * wl;
      uint32_t* Pn = s.Pb + (cur ^ 1) * wl;
      const uint32_t* R = s.Rb + cur * wl;
      uint32_t* Rn = s.Rb + (cur ^ 1) * wl;
      const int* Cc = s.Cb + cur * rl;
      int* Cn = s.Cb + (cur ^ 1) * rl;

      // step 1: candidate selection (first minimum over P's members; a
      // candidate step that is not forced has P nonempty)
      int x = forced_x;
      if (!forced) {
        if (STAGED && !adj_ready && a.order_mode == MODE_NOCACHE) {
          hopper::mbar_wait(s.mbar, 0);
          adj_ready = true;
        }
        u64 best = ~0ull;
        for (int kk = warp; kk < wl; kk += nw) {
          const uint32_t pw = P[kk];
          const int i = 32 * kk + lane;
          if (!((pw >> lane) & 1u)) continue;
          int v = 0;
          if (a.order_mode == MODE_DEG)
            v = Cc[i];
          else if (a.order_mode == MODE_NOCACHE)
            v = row_count(A + static_cast<long>(i) * wv, L, wv, lane, vec);
          const u64 key = (static_cast<u64>(static_cast<uint32_t>(v)) << 32)
                          | static_cast<uint32_t>(row0 + i);
          best = key < best ? key : best;
        }
        best = reduce<OP_MIN>(best, s, SITE_SEL, cl);
        x = best == ~0ull ? -1 : static_cast<int>(best & 0xFFFFFFFFull);
      }
      const int xm = x > 0 ? x : 0;
      const int xrow = x < 0 ? 0 : (x > nu - 1 ? nu - 1 : x);

      // step 2: L' = L & N(x), |L'| and L''s checksum
      if (STAGED && !adj_ready) {
        hopper::mbar_wait(s.mbar, 0);
        adj_ready = true;
      }
      const uint32_t* Ax;
      if (!STAGED) {
        Ax = g.adj + static_cast<long>(xrow) * wv;
      } else if (cl == 1) {
        Ax = s.A + static_cast<long>(xrow) * wv;
      } else {
        const int owner = xrow / rl;
        Ax = cg::this_cluster().map_shared_rank(s.A, owner) +
             static_cast<long>(xrow - owner * rl) * wv;
      }
      uint32_t pc = 0, hl = 0;
      for (int w = tid; w < wv; w += nt) {
        const uint32_t v = L[w] & Ax[w];
        Lp[w] = v;
        pc += __popc(v);
        hl += checksum_term(v, w);
      }
      // every CTA holds the whole of L', so this sum stays in the CTA
      const u64 r2 = reduce<OP_ADD>((static_cast<u64>(pc) << 32) | hl, s,
                                    SITE_CNT, 1);
      const int nLp = static_cast<int>(r2 >> 32);
      const uint32_t hL = static_cast<uint32_t>(r2);
      const bool nonempty = nLp > 0;

      // steps 3+4: one counts pass -> check, partition, Q' filter, cache
      uint32_t bits = 0, hr = 0;
      for (int kk = warp; kk < wl; kk += nw) {
        const int i = 32 * kk + lane;
        const bool valid = i < rl;
        const int c = valid ? row_count(A + static_cast<long>(i) * wv, Lp, wv,
                                        lane, vec) : 0;
        if (valid) Cn[i] = c;
        const int k = word0 + kk;
        const uint32_t pa = P[kk] & ~singleton_word(xm, k);
        const bool qb = valid && ((s.Q[kk] >> lane) & 1u);
        const bool pb = valid && ((pa >> lane) & 1u);
        const bool eq = c == nLp;
        const bool partb = pb && c > 0 && c < nLp;
        bits |= (qb && eq) ? 1u : 0u;
        const uint32_t fw = __ballot_sync(FULL, pb && eq);
        const uint32_t pw = __ballot_sync(FULL, partb);
        const uint32_t zw = __ballot_sync(FULL, valid && c > 0);
        if (lane == 0) {
          const uint32_t rw = R[kk] | singleton_word(x, k) | fw;
          Rn[kk] = rw;
          Pn[kk] = pw;
          s.NZ[kk] = zw;
          hr += checksum_term(rw, k);
          bits |= (pw != 0u ? 2u : 0u) | (pa != 0u ? 4u : 0u);
        }
      }
      const u64 r3 = reduce<OP_ORADD>((static_cast<u64>(hr) << 32) | bits,
                                      s, SITE_FLAGS, cl);
      const bool viol = (r3 & 1u) && nonempty;
      const bool has_part = (r3 & 2u) != 0;
      const bool pa_any = (r3 & 4u) != 0;
      const uint32_t hR = static_cast<uint32_t>(r3 >> 32);
      const bool is_max = nonempty && !viol;
      const bool has_child = is_max && has_part;
      const int child = lvl + 1 < D - 1 ? lvl + 1 : D - 1;
      const int q_idx = has_child ? child : lrow;
      const bool write = is_max && out_n < C;
      const int wrow = out_n < C - 1 ? out_n : C - 1;

      // apply the delta, written through (write order = _apply_delta)
      for (int w = tid; w < wv; w += nt) {
        const uint32_t v = Lp[w];
        if (has_child) g.lmask[static_cast<long>(child) * wv + w] = v;
        if (write) g.outl[static_cast<long>(wrow) * wv + w] = v;
      }
      for (int kk = warp; kk < wl; kk += nw) {
        const int i = 32 * kk + lane;
        if (has_child && i < rl)
          g.cstack[static_cast<long>(child) * nu + row0 + i] = Cn[i];
        if (lane == 0) {
          const int k = word0 + kk;
          const uint32_t pa = P[kk] & ~singleton_word(xm, k);
          const uint32_t q = s.Q[kk];
          // pmask[lvl_safe] then pmask[child]: the order matters when
          // child == lvl_safe (lvl == depth - 1)
          const uint32_t pfin = forced ? 0u : pa;
          g.pmask[static_cast<long>(lrow) * wu + k] = pfin;
          if (has_child) g.pmask[static_cast<long>(child) * wu + k] = Pn[kk];
          const uint32_t qn = has_child ? (q & s.NZ[kk])
                                        : (q | singleton_word(xm, k));
          g.qmask[static_cast<long>(q_idx) * wu + k] = qn;
          s.Q[kk] = qn;
          if (has_child) g.rmask[static_cast<long>(child) * wu + k] = Rn[kk];
          if (write) g.outr[static_cast<long>(wrow) * wu + k] = Rn[kk];
          if (!has_child) P[kk] = pfin;
        }
      }
      if (has_child && lane == 0) g.xstack[lrow] = x;
      if (is_max) {       // uniform
        uint32_t z = (hL * 0x85EBCA6Bu) ^ (hR * 0xC2B2AE35u);
        z ^= z >> 16;
        z *= 0x7FEB352Du;
        cs += z ^ (z >> 15);
      }
      if (has_child) {
        cur ^= 1;
        p_nonempty = has_part;
      } else {
        p_nonempty = !forced && pa_any;
      }
      lvl = has_child ? lvl + 1 : lvl;
      forced_x = -1;
      nodes += 1;
      n_max += is_max ? 1 : 0;
      max_fail += viol ? 1 : 0;
      out_n += write ? 1 : 0;
      steps += 1;
    }
  }

  if (STAGED && !adj_ready) hopper::mbar_wait(s.mbar, 0);  // no copy in flight
  if (rank == 0 && tid == 0) {
    int* sc = g.scal;
    sc[S_LVL] = lvl;
    sc[S_FORCED] = forced_x;
    sc[S_TPOS] = tpos;
    sc[S_STEPS] = steps;
    sc[S_NODES] = nodes;
    sc[S_NMAX] = n_max;
    sc[S_MAXFAIL] = max_fail;
    sc[S_CS] = static_cast<int>(cs);
    sc[S_OUTN] = out_n;
    const bool done = lvl < 0 && tpos >= n_tasks;
    if (a.board) {
      a.board[2 * b] = done ? 1 : 0;
      a.board[2 * b + 1] = a.spc - (steps - steps0);
    }
    if (a.flag && !done && steps - start < budget)
      *reinterpret_cast<volatile int*>(a.flag) = seq;
  }
  if (cl > 1) cg::this_cluster().sync();   // peers may still read our smem
}

// ---- host side: argument check and launch ---------------------------------

inline int lane_rows(const LaneArgs& a) { return a.nu / a.cluster; }

inline int lane_smem_need(const LaneArgs& a) {
  const int rl = lane_rows(a);
  return smem_base_bytes(rl, a.wv) + (a.staged ? 4 * rl * a.wv : 0);
}

inline int check_args(const LaneArgs& a) {
  const int cl = a.cluster;
  const bool cl_ok = cl == 1 || cl == 2 || cl == 4 || cl == 8;
  if (!cl_ok || a.nu % cl != 0 || (cl > 1 && (lane_rows(a) % 32 != 0 ||
                                                !a.staged)) ||
      a.threads % 32 != 0 || a.threads < 32 || a.threads > MAX_THREADS ||
      a.lanes < 1 || a.spc < 0 || a.smem_bytes < lane_smem_need(a))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// `blocks` lanes of `cl` CTAs each.  The dynamic shared-memory attribute
// is set once per process, device and size (`set_bytes` is the caller's
// static record of it).
template <class Kernel>
inline int launch_lanes(Kernel kernel, const LaneArgs& a, int blocks,
                        int seq, void* stream, int* set_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (set_bytes[dev] < a.smem_bytes) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             a.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set_bytes[dev] = a.smem_bytes;
  }
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(blocks * a.cluster);
  c.blockDim = dim3(a.threads);
  c.dynamicSmemBytes = a.smem_bytes;
  c.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (a.cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    c.attrs = attr;
    c.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&c, kernel, a, seq);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
