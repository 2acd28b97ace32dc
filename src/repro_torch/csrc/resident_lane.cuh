// One dense-engine lane advanced by up to `spc` guarded engine steps: the
// __device__ body shared by the single-lane kernel (resident_step.cu,
// grid = 1) and the pool kernel (resident_pool.cu, grid = lanes).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/resident_step/kernel.py:resident_kernel
// (and, through the pool entry, resident_pool/kernel.py:
// resident_pool_kernel), with the same semantics bit for bit: the step of
// src/repro/core/engine_dense.py iterated under the run loop's guard
// `~done & (steps - start < budget)`, the three order modes, the write
// order of `_apply_delta`, `cstack[child]` written on descent in every
// order mode, and uint32 wraparound in the fingerprint.
//
// Design for Hopper.  The TPU kernel kept the whole lane state in VMEM.
// One H100 block has at most 227 KB of shared memory while one lane's
// counts cache alone is 4*(n_u+2)*n_u bytes (1 MB at n_u = 512), so here:
//   * one block (CTA) per lane, the paper's thread-block-per-task layout;
//   * the mask stacks, cstack, xstack and the collect buffers live in
//     device memory (their hot rows stay in L2); the block first copies
//     its lane's input state to the fresh output buffers (launches are
//     functional) and then updates the output in place;
//   * shared memory holds the working rows of the current level (L, L',
//     P, P', Q, R, full/part/nz words, R'), the counts row c2 (n_u int32),
//     the 16 scalar slots and the reduction scratch; the adjacency is
//     staged there too when n_u*w_v*4 bytes fit (128 KB at 512 x 2048),
//     else every counts pass reads it from device memory / L2.
// What bounds it: per step, one or two AND+popcount passes over the
// n_u x w_v adjacency plus a handful of block-wide reductions, i.e.
// latency (barriers, L2 round trips) at the serving sizes, and per launch
// the copy of the lane state (bytes).  One CTA per lane leaves most SMs
// idle for small pools; that is the price of the simple layout.  The
// entries launch 512 threads under __launch_bounds__(512, 1), which caps
// the body at 128 registers a thread.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

enum : int {
  S_LVL = 0, S_FORCED, S_TPOS, S_STEPS, S_NODES, S_NMAX, S_MAXFAIL, S_CS,
  S_OUTN, S_NTASKS, S_START, S_BUDGET, SCAL_SLOTS = 16
};
enum : int { MODE_DEG = 0, MODE_NOCACHE = 1, MODE_INPUT = 2 };
constexpr int INF = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Dims {
  int nu, wu, wv, depth, cap, t_len, m_real, order_mode, spc;
  int group, stage_adj, ctx_batched;
};

// read-only inputs of one lane (context + input state)
struct LaneIn {
  const int* scal;
  const uint32_t* adj;
  const int* order;
  const int* rank;
  const int* rc;
  const uint32_t* lroot;
  const int* tasks;
  const uint32_t* lmask;
  const int* cstack;
  const uint32_t* pmask;
  const uint32_t* qmask;
  const uint32_t* rmask;
  const int* xstack;
  const uint32_t* outl;
  const uint32_t* outr;
};

// the lane's fresh output state, updated in place
struct LaneOut {
  int* scal;
  uint32_t* lmask;
  int* cstack;
  uint32_t* pmask;
  uint32_t* qmask;
  uint32_t* rmask;
  int* xstack;
  uint32_t* outl;
  uint32_t* outr;
};

// Shared-memory layout (byte offsets; mirrored by
// kernels/resident_step/ops.py:resident_smem_base):
//   [0, 272)         unsigned long long red[34] reduction scratch
//   [272, 400)       int scal[16], misc[16]
//   words            L[wv] Lp[wv] pm[wu] pa[wu] q[wu] r[wu] full[wu]
//                    part[wu] nz[wu] R[wu], then c[nu]
//   (16-aligned)     adj[nu*wv] when staged
struct Smem {
  unsigned long long* red;
  int* scal;
  int* misc;
  uint32_t *L, *Lp, *pm, *pa, *q, *r, *full, *part, *nz, *R;
  int* c;
  uint32_t* adj;
};

__host__ __device__ inline int smem_base_bytes(int nu, int wu, int wv) {
  int words = 2 * wv + 8 * wu + nu;
  int b = 272 + 4 * 32 + 4 * words;
  return (b + 15) / 16 * 16;
}

__device__ inline Smem smem_layout(char* base, const Dims& d) {
  Smem s;
  s.red = reinterpret_cast<unsigned long long*>(base);
  s.scal = reinterpret_cast<int*>(base + 272);
  s.misc = s.scal + 16;
  uint32_t* w = reinterpret_cast<uint32_t*>(base + 400);
  s.L = w; w += d.wv;
  s.Lp = w; w += d.wv;
  s.pm = w; w += d.wu;
  s.pa = w; w += d.wu;
  s.q = w; w += d.wu;
  s.r = w; w += d.wu;
  s.full = w; w += d.wu;
  s.part = w; w += d.wu;
  s.nz = w; w += d.wu;
  s.R = w; w += d.wu;
  s.c = reinterpret_cast<int*>(w);
  s.adj = reinterpret_cast<uint32_t*>(base + smem_base_bytes(d.nu, d.wu, d.wv));
  return s;
}

// ---- block-wide reductions (every thread must call them) ---------------

__device__ inline unsigned long long block_min_u64(unsigned long long v,
                                                   unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : ~0ull;
    for (int off = 16; off > 0; off >>= 1) {
      unsigned long long o = __shfl_xor_sync(FULL, v, off);
      v = o < v ? o : v;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// uint32 sum with 2**32 wraparound
__device__ inline uint32_t block_sum_u32(uint32_t v, unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? static_cast<uint32_t>(red[lane]) : 0u;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = static_cast<uint32_t>(red[32]);
  __syncthreads();
  return v;
}

// ---- helpers ------------------------------------------------------------

// word w of the packed singleton {x}; empty for x < 0 (C's `/` and `%`
// truncate toward zero, so -1 would otherwise hit bit -1 of word 0)
__device__ inline uint32_t singleton_word(int x, int w) {
  if (x < 0) return 0u;
  return (w == (x >> 5)) ? (1u << (x & 31)) : 0u;
}

__device__ inline bool bit_of(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// bitset.checksum's per-word term
__device__ inline uint32_t checksum_term(uint32_t word, int w) {
  uint32_t mult = static_cast<uint32_t>(w) * 0x9E3779B9u + 0x85EBCA6Bu;
  uint32_t h = word * mult;
  h ^= h >> 15;
  h *= 0x2545F491u;
  h ^= h >> 13;
  return h;
}

// copy n 32-bit words, 16 bytes at a time where both sides allow it
__device__ inline void copy_words(uint32_t* dst, const uint32_t* src, long n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  long head = 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  if (((a ^ b) & 15) == 0) {
    head = ((16 - (a & 15)) & 15) / 4;
    if (head > n) head = n;
    for (long i = tid; i < head; i += nt) dst[i] = src[i];
    const long nvec = (n - head) / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    long i = tid;
    for (; i + 3L * nt < nvec; i += 4L * nt) {
      uint4 v0 = s4[i], v1 = s4[i + nt], v2 = s4[i + 2L * nt],
            v3 = s4[i + 3L * nt];
      d4[i] = v0;
      d4[i + nt] = v1;
      d4[i + 2L * nt] = v2;
      d4[i + 3L * nt] = v3;
    }
    for (; i < nvec; i += nt) d4[i] = s4[i];
    for (long j = head + nvec * 4 + tid; j < n; j += nt) dst[j] = src[j];
  } else {
    for (long i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

// c[i] = popcount(A[i] & m) for every row i < nu: `group` lanes share a
// row (a power of two <= 32, so a group never straddles a warp), all
// lanes run the same trip count so the shuffles see a full warp
__device__ inline void counts_pass(const uint32_t* A, const uint32_t* m,
                                   int* c, const Dims& d) {
  const int G = d.group;
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const int ngrp = blockDim.x / G;
  const int rounds = (d.nu + ngrp - 1) / ngrp;
  for (int k = 0; k < rounds; ++k) {
    const int row = k * ngrp + grp;
    uint32_t sum = 0;
    if (row < d.nu) {
      const uint32_t* a = A + static_cast<long>(row) * d.wv;
      for (int w = gl; w < d.wv; w += G) sum += __popc(a[w] & m[w]);
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    if (gl == 0 && row < d.nu) c[row] = static_cast<int>(sum);
  }
}

// x_sel of the 'deg' and 'deg_nocache' modes: first index minimising
// vals[i] over members of P (0 when P is empty: every key is INF)
__device__ inline int masked_argmin(const int* vals, const uint32_t* pm,
                                    const Dims& d, unsigned long long* red) {
  unsigned long long best = ~0ull;
  for (int i = threadIdx.x; i < d.nu; i += blockDim.x) {
    const unsigned long long v =
        bit_of(pm, i) ? static_cast<unsigned long long>(
                            static_cast<unsigned>(vals[i]))
                      : static_cast<unsigned long long>(INF);
    const unsigned long long key = (v << 32) | static_cast<unsigned>(i);
    best = key < best ? key : best;
  }
  best = block_min_u64(best, red);
  return static_cast<int>(best & 0xFFFFFFFFull);
}

// ---- the segment ---------------------------------------------------------

__device__ inline void lane_segment(const LaneIn& in, const LaneOut& out,
                                    const Dims& d, char* smem_raw) {
  Smem sm = smem_layout(smem_raw, d);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nu = d.nu, wu = d.wu, wv = d.wv, D = d.depth, C = d.cap;

  // functional launch: input state -> fresh output buffers
  copy_words(out.lmask, in.lmask, static_cast<long>(D) * wv);
  copy_words(reinterpret_cast<uint32_t*>(out.cstack),
             reinterpret_cast<const uint32_t*>(in.cstack),
             static_cast<long>(D) * nu);
  copy_words(out.pmask, in.pmask, static_cast<long>(D) * wu);
  copy_words(out.qmask, in.qmask, static_cast<long>(D) * wu);
  copy_words(out.rmask, in.rmask, static_cast<long>(D) * wu);
  copy_words(reinterpret_cast<uint32_t*>(out.xstack),
             reinterpret_cast<const uint32_t*>(in.xstack), D);
  copy_words(out.outl, in.outl, static_cast<long>(C) * wv);
  copy_words(out.outr, in.outr, static_cast<long>(C) * wu);
  const uint32_t* A = in.adj;
  if (d.stage_adj) {
    copy_words(sm.adj, in.adj, static_cast<long>(nu) * wv);
    A = sm.adj;
  }
  if (tid < SCAL_SLOTS) sm.scal[tid] = in.scal[tid];
  __syncthreads();

  for (int k = 0; k < d.spc; ++k) {
    const int lvl = sm.scal[S_LVL];
    const int forced_x = sm.scal[S_FORCED];
    const int tpos = sm.scal[S_TPOS];
    const int steps = sm.scal[S_STEPS];
    const bool done = (lvl < 0) && (tpos >= sm.scal[S_NTASKS]);
    const bool act = !done && (steps - sm.scal[S_START] < sm.scal[S_BUDGET]);
    if (!act) break;      // uniform: an inactive lane stays inactive
    const int lvl_safe = lvl > 0 ? lvl : 0;
    for (int w = tid; w < wu; w += nt)
      sm.pm[w] = out.pmask[static_cast<long>(lvl_safe) * wu + w];
    __syncthreads();
    int nonzero = 0;
    for (int w = tid; w < wu; w += nt) nonzero |= sm.pm[w] != 0u;
    const bool p_empty = !__syncthreads_or(nonzero);
    const int kase = lvl < 0 ? 1 : ((p_empty && forced_x < 0) ? 0 : 2);

    if (kase == 0) {
      // ---- backtrack: x moves to Q at the parent level ----------------
      if (tid == 0) {
        const int nl = lvl - 1;
        const int safe = nl > 0 ? nl : 0;
        int x = out.xstack[safe];
        x = x > 0 ? x : 0;
        if (nl >= 0)
          out.qmask[static_cast<long>(safe) * wu + (x >> 5)] |= 1u << (x & 31);
        sm.scal[S_LVL] = nl;
        sm.scal[S_STEPS] = steps + 1;
      }
    } else if (kase == 1) {
      // ---- initialise the next root task ------------------------------
      const int ti = tpos < d.t_len - 1 ? tpos : d.t_len - 1;
      const int idx = in.tasks[ti];
      const int ci = idx < 0 ? 0 : (idx > nu - 1 ? nu - 1 : idx);
      const int x = in.order[ci];
      for (int w = tid; w < wv; w += nt) out.lmask[w] = in.lroot[w];
      for (int i = tid; i < nu; i += nt) out.cstack[i] = in.rc[i];
      const int nround = (nu + 31) / 32 * 32;
      for (int i0 = 0; i0 < nround; i0 += nt) {
        const int i = i0 + tid;
        const bool valid = i < nu;
        const int rk = valid ? in.rank[i] : 0;
        const unsigned pw =
            __ballot_sync(FULL, valid && rk > idx && rk < d.m_real);
        const unsigned qw = __ballot_sync(FULL, valid && rk < idx);
        if ((tid & 31) == 0 && i < nround && (i >> 5) < wu) {
          out.pmask[i >> 5] = pw;
          out.qmask[i >> 5] = qw;
          out.rmask[i >> 5] = 0u;
        }
      }
      if (tid == 0) {
        sm.scal[S_LVL] = 0;
        sm.scal[S_FORCED] = x;
        sm.scal[S_TPOS] = tpos + 1;
        sm.scal[S_STEPS] = steps + 1;
      }
    } else {
      // ---- process a candidate ----------------------------------------
      const long lrow = static_cast<long>(lvl_safe);
      for (int w = tid; w < wv; w += nt) sm.L[w] = out.lmask[lrow * wv + w];
      for (int w = tid; w < wu; w += nt) {
        sm.q[w] = out.qmask[lrow * wu + w];
        sm.r[w] = out.rmask[lrow * wu + w];
      }
      __syncthreads();
      const bool forced = forced_x >= 0;

      // step 1: candidate selection
      int x_sel;
      if (d.order_mode == MODE_DEG) {
        x_sel = masked_argmin(out.cstack + lrow * nu, sm.pm, d, sm.red);
      } else if (d.order_mode == MODE_NOCACHE) {
        counts_pass(A, sm.L, sm.c, d);
        __syncthreads();
        x_sel = masked_argmin(sm.c, sm.pm, d, sm.red);
      } else {
        unsigned long long first = ~0ull;
        for (int i = tid; i < nu; i += nt)
          if (bit_of(sm.pm, i)) {
            const unsigned long long key = static_cast<unsigned>(i);
            first = key < first ? key : first;
          }
        first = block_min_u64(first, sm.red);
        x_sel = first == ~0ull ? -1 : static_cast<int>(first);
      }
      const int x = forced ? forced_x : x_sel;
      const int xm = x > 0 ? x : 0;
      const int xrow = x < 0 ? 0 : (x > nu - 1 ? nu - 1 : x);

      // step 2: L' = L & N(x), |L'|
      uint32_t pc = 0;
      for (int w = tid; w < wv; w += nt) {
        const uint32_t v = sm.L[w] & A[static_cast<long>(xrow) * wv + w];
        sm.Lp[w] = v;
        pc += __popc(v);
      }
      for (int w = tid; w < wu; w += nt)
        sm.pa[w] = sm.pm[w] & ~singleton_word(xm, w);
      const int nLp = static_cast<int>(block_sum_u32(pc, sm.red));
      const bool nonempty = nLp > 0;

      // steps 3+4: one counts pass -> check, partition, Q' filter, cache
      counts_pass(A, sm.Lp, sm.c, d);
      __syncthreads();
      int viol_l = 0, part_l = 0;
      const int nround = (nu + 31) / 32 * 32;
      for (int i0 = 0; i0 < nround; i0 += nt) {
        const int i = i0 + tid;
        const bool valid = i < nu;
        const int c = valid ? sm.c[i] : 0;
        const bool qb = valid && bit_of(sm.q, i);
        const bool pb = valid && bit_of(sm.pa, i);
        const bool eq = c == nLp;
        const bool partb = pb && c > 0 && c < nLp;
        viol_l |= qb && eq;
        part_l |= partb;
        const unsigned fw = __ballot_sync(FULL, pb && eq);
        const unsigned pw = __ballot_sync(FULL, partb);
        const unsigned zw = __ballot_sync(FULL, valid && c > 0);
        if ((tid & 31) == 0 && i < nround && (i >> 5) < wu) {
          sm.full[i >> 5] = fw;
          sm.part[i >> 5] = pw;
          sm.nz[i >> 5] = zw;
        }
      }
      const bool viol = __syncthreads_or(viol_l) && nonempty;
      const bool has_part = __syncthreads_or(part_l);
      const bool is_max = nonempty && !viol;
      const bool has_child = is_max && has_part;
      const int child = lvl + 1 < D - 1 ? lvl + 1 : D - 1;
      const int nl = has_child ? lvl + 1 : lvl;
      for (int w = tid; w < wu; w += nt)
        sm.R[w] = sm.r[w] | singleton_word(x, w) | sm.full[w];
      __syncthreads();

      // apply the delta (write order = _apply_delta)
      const long crow = static_cast<long>(child);
      if (has_child) {
        for (int w = tid; w < wv; w += nt) out.lmask[crow * wv + w] = sm.Lp[w];
        for (int i = tid; i < nu; i += nt) out.cstack[crow * nu + i] = sm.c[i];
      }
      const int q_idx = has_child ? child : lvl_safe;
      for (int w = tid; w < wu; w += nt) {
        // same thread writes pmask[lvl_safe] then pmask[child]: the order
        // matters when child == lvl_safe (lvl == depth - 1)
        out.pmask[lrow * wu + w] = forced ? 0u : sm.pa[w];
        if (has_child) out.pmask[crow * wu + w] = sm.part[w];
        out.qmask[static_cast<long>(q_idx) * wu + w] =
            has_child ? (sm.q[w] & sm.nz[w]) : (sm.q[w] | singleton_word(xm, w));
        if (has_child) out.rmask[crow * wu + w] = sm.R[w];
      }
      const int out_n = sm.scal[S_OUTN];
      const bool write = is_max && out_n < C;
      if (write) {
        const long wrow = static_cast<long>(out_n < C - 1 ? out_n : C - 1);
        for (int w = tid; w < wv; w += nt) out.outl[wrow * wv + w] = sm.Lp[w];
        for (int w = tid; w < wu; w += nt) out.outr[wrow * wu + w] = sm.R[w];
      }
      uint32_t cs_inc = 0;
      if (is_max) {       // uniform
        uint32_t hl = 0, hr = 0;
        for (int w = tid; w < wv; w += nt) hl += checksum_term(sm.Lp[w], w);
        for (int w = tid; w < wu; w += nt) hr += checksum_term(sm.R[w], w);
        hl = block_sum_u32(hl, sm.red);
        hr = block_sum_u32(hr, sm.red);
        uint32_t z = (hl * 0x85EBCA6Bu) ^ (hr * 0xC2B2AE35u);
        z ^= z >> 16;
        z *= 0x7FEB352Du;
        cs_inc = z ^ (z >> 15);
      }
      if (tid == 0) {
        if (has_child) out.xstack[lvl_safe] = x;
        sm.scal[S_CS] = static_cast<int>(
            static_cast<uint32_t>(sm.scal[S_CS]) + cs_inc);
        sm.scal[S_LVL] = nl;
        sm.scal[S_FORCED] = -1;
        sm.scal[S_NODES] += 1;
        sm.scal[S_NMAX] += is_max ? 1 : 0;
        sm.scal[S_MAXFAIL] += viol ? 1 : 0;
        sm.scal[S_OUTN] = out_n + (write ? 1 : 0);
        sm.scal[S_STEPS] = steps + 1;
      }
    }
    __syncthreads();
  }
  if (tid < SCAL_SLOTS) out.scal[tid] = sm.scal[tid];
}

// lane b's pointers into the (lanes, ...) operands
__device__ inline void lane_pointers(int b, const Dims& d,
                                     const LaneIn& in0, const LaneOut& out0,
                                     LaneIn& in, LaneOut& out) {
  const long D = d.depth, nu = d.nu, wu = d.wu, wv = d.wv, C = d.cap;
  in = in0;
  out = out0;
  in.scal += b * SCAL_SLOTS;
  out.scal += b * SCAL_SLOTS;
  if (d.ctx_batched) {
    in.adj += b * nu * wv;
    in.order += b * nu;
    in.rank += b * nu;
    in.rc += b * nu;
    in.lroot += b * wv;
  }
  in.tasks += b * static_cast<long>(d.t_len);
  in.lmask += b * D * wv;
  out.lmask += b * D * wv;
  in.cstack += b * D * nu;
  out.cstack += b * D * nu;
  in.pmask += b * D * wu;
  out.pmask += b * D * wu;
  in.qmask += b * D * wu;
  out.qmask += b * D * wu;
  in.rmask += b * D * wu;
  out.rmask += b * D * wu;
  in.xstack += b * D;
  out.xstack += b * D;
  in.outl += b * C * wv;
  out.outl += b * C * wv;
  in.outr += b * C * wu;
  out.outr += b * C * wu;
}

}  // namespace rt
