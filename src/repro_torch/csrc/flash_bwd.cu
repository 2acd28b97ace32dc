// Flash-attention backward (K7 dq, K7 dkv): the gradients of
// o = softmax(q k^T * scale) v with respect to q, k and v, from do, the
// forward's row logsumexp lse and dD = rowsum(do * o).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel.py:_dq_kernel   (K7 dq)
//   src/repro/kernels/flash_attention/kernel.py:_dkv_kernel  (K7 dkv)
// (flash_bwd_pallas, dispatched by flash_attention/ops.py's custom_vjp).
// It computes what they compute, not their tiling.  Per live (q, k) pair
// (mask (kpos < sk) & (qpos < sq) & (kpos <= qpos if causal)):
//   s  = q k^T * scale                       fp32
//   p  = exp(s - lse)  (0 off the mask: lse of a padded row never reaches
//                       the result, so no inf or NaN enters a product)
//   dp = do v^T                              fp32
//   ds = p * (dp - dD) * scale
//   dq = sum_k ds k      (ds rounded to k's dtype first)
//   dv = sum_q p^T do    (p rounded to do's dtype first)
//   dk = sum_q ds^T q    (ds rounded to q's dtype first)
// dk and dv sum over the G query heads of a KV group.  Padded rows of dq
// and keys past sk get 0.
// Layouts (contiguous, padded past the real lengths sq / sk):
//   q, do, dq (B, KV, G, Sqp, HD); k, v, dk, dv (B, KV, Skp, HD);
//   lse, dD (B, KV, G, Sqp) fp32.
//
// Design.  The TPU grids run their reduction axes in order and carry the
// accumulators in VMEM: dq over (.., nq, nk), dk/dv over (.., nk, G, nq).
// On Hopper:
//  * bf16: one fused kernel computes dq, dk and dv in one pass, so S and
//    dP are computed once per live pair (10 hd FLOPs a pair: S, dP, dV,
//    dK, dQ).  One block per (b, kv, 128-key tile), heaviest causal key
//    tiles first, loops over the G query heads of its group and, for
//    each, over the 64-row q tiles from the diagonal on.  Two warpgroups,
//    each owning 64 keys.  K and V are loaded once by TMA; Q, dO, lse and
//    dD tiles stream through a STAGES-deep ring of shared-memory buffers
//    tracked by full / empty mbarriers: one thread issues every copy, the
//    tile of iteration i + STAGES as soon as both warpgroups release
//    iteration i, so the next tiles' copies overlap this tile's products.
//    All five products are wgmma (bf16 in, fp32 accumulate), A and B from
//    shared memory:
//      S^T = K Q^T, dP^T = V dO^T   64 keys x 64 q rows a warpgroup;
//      dV += P^T dO, dK += dS^T Q   P^T and dS^T rounded to bf16 and
//                                   staged in shared memory, B (dO, Q)
//                                   transposed by its descriptor;
//      dQ  = dS K                   the dS^T tile read transposed, one
//                                   iteration later (in the same batch as
//                                   the next dV, dK), so neither
//                                   warpgroup waits for the other's dS^T.
//    dK and dV stay in registers for the whole loop and are written once
//    in bf16: deterministic.  dQ is split over the warpgroups (by head
//    dim at hd 128, by key at hd <= 64) and each partial tile is added
//    into an fp32 accumulator in device memory (red.global.add.v2.f32),
//    so dq's summation order varies from run to run (the wrapper casts
//    the accumulator to bf16).  The mask is evaluated only on tiles that
//    cross the diagonal or the ragged sq / sk edge; the TMA tensor maps
//    end at sq and sk, so rows past them arrive as zeros.
//    Registers bound the layout: dK and dV alone take 128 fp32 a thread
//    at hd 128.  A third, producer warpgroup (setmaxnreg 24 / 240) makes
//    ptxas budget the whole kernel at 168 registers a thread: it then
//    spills and serializes every wgmma.  With two warpgroups the budget
//    is 255 and nothing spills; P^T and dS^T go through shared memory
//    rather than register A fragments for the same reason.
//  * fp32 (the tight comparisons): CUDA cores, dq and dkv as two kernels,
//    no atomics: dq one block per 64-row q tile looping over 64-key
//    tiles, dkv one block per 64-key tile looping over G and the 64-row q
//    tiles from its diagonal on, holding dK and dV in registers; both
//    grids put the heads fastest, so every head's heaviest causal tiles
//    go out first.  Every output is one fmaf chain in the order the plain
//    version's fp32 products sum (S and dP over the head dim, dQ over the
//    keys, dK and dV over the G heads, then the q rows), so the results
//    are bit-identical to a thread that loops over the outputs one at a
//    time, and agree with the plain version to its own rounding.  That
//    order is what the fp32 limits hold: the plain version sits further
//    from its float64 evaluation than the limits (chip_smoke.py logs
//    both, and the plain version's 3xTF32 emulation beside them), so a
//    kernel that sums in another order, as 3xTF32 products on the tensor
//    cores would, misses them.  These kernels are an interim design
//    until the fp32 limits' yardstick is settled.
//    Shared memory bounds a loop that loads an operand an FMA: each
//    thread computes a 4 x 4 micro-tile of S and dP from 16-byte loads
//    along the head dim (four A rows shared by half a warp, B rows
//    conflict-free at a pitch of hd + 4 floats), and a 4-row x hd / 16
//    micro-tile of dQ, dK, dV from a transposed dS / P tile.  Tiles
//    arrive by cp.async (dq: two K / V buffers, the next tile's copies in
//    flight while this one is used; dkv: one Q / dO buffer, since two
//    64-row ones do not fit beside K and V).
// What bounds them: at the training shapes (hd 128, S 4096) the causal
// work, 10 hd FLOPs a live pair against 989 TFLOP/s bf16 (fused), and
// 14 hd FLOPs a live pair against the 67 TFLOP/s FP32 CUDA-core peak
// (dq, dkv): operations, not bytes.
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using flash::key_end;
using flash::live;
using flash::pack_bf16;
using hopper::encode_tiled;
using hopper::map_rows;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16: one fused wgmma / TMA kernel
// ---------------------------------------------------------------------------

constexpr int BK = 128;          // keys per block (two warpgroups x 64)
constexpr int BQ = 64;           // q rows per tile
constexpr int STAGES = 2;        // Q / dO / lse / dD ring depth
constexpr int NDS = 3;           // dS^T buffers (dQ runs one iteration late)
constexpr int THREADS = 256;     // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Fused {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle, bytes
  static constexpr int AE = SW / 2;        // bf16 per swizzled row
  static constexpr int NB = HD / AE;       // column blocks of a tile
  static constexpr int KPA = SW / 32;      // k16 steps per column block
  // dQ split over the warpgroups: by key at hd <= 64 (each adds all HD
  // columns over its own 64 keys), by head dim at 128 (each adds 64
  // columns over all 128 keys)
  static constexpr bool KEY_SPLIT = HD < 128;
  static constexpr int NQ = KEY_SPLIT ? HD : HD / 2;   // dQ width
  static constexpr int KT = BK * HD * 2;   // K or V tile bytes
  static constexpr int QT = BQ * HD * 2;   // Q or dO tile bytes
  static constexpr int DS = BK * BQ * 2;   // P^T or dS^T tile bytes
  //                                          (128 B rows: 64 q columns)
  static constexpr int VEC = BQ * 4;       // lse or dD tile bytes
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KT;
  static constexpr int OFF_Q = 2 * KT;
  static constexpr int OFF_O = OFF_Q + STAGES * QT;
  static constexpr int OFF_S = OFF_O + STAGES * QT;   // dS^T, NDS buffers
  static constexpr int OFF_P = OFF_S + NDS * DS;      // P^T
  static constexpr int OFF_L = OFF_P + DS;
  static constexpr int OFF_D = OFF_L + STAGES * VEC;
  static constexpr int OFF_B = OFF_D + STAGES * VEC;
  static constexpr int BYTES = OFF_B + (1 + 2 * STAGES + NDS) * 8;
  static constexpr int SMEM = BYTES + 1024;   // + alignment of the base
  static_assert(KT % 1024 == 0 && QT % 1024 == 0, "1024-byte tiles");
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tlse,
                       const __grid_constant__ CUtensorMap tdd,
                       float* __restrict__ dq, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int G, int Sqp, int Slp,
                       int Skp, int sq, int sk, float scale, int causal) {
  using F = Fused<HD>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary (pointer arithmetic on
  // smem_raw keeps the shared window: 32-bit shared loads and stores)
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sm + F::OFF_B);
  uint64_t* full = kv_bar + 1;             // [STAGES]: tile landed
  uint64_t* empty = full + STAGES;         // [STAGES]: tile consumed
  uint64_t* ds_bar = empty + STAGES;       // [NDS]: dS^T tile written

  const int hk = blockIdx.x;               // b * KV + kv
  const int k0 = blockIdx.y * BK;          // key tile 0 (heaviest) first
  const int nq = (sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;    // q rows below k0 see no key
  const int qend = (k0 < sk && qt0 < nq) ? nq : qt0;   // q tiles qt0..qend-1
  const int n_iter = G * (qend - qt0);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    for (int b = 0; b < NDS; ++b) mbar_init(&ds_bar[b], THREADS);
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform in the compiler's eyes (a shuffle from lane 0), so that
  // the descriptors built on it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int per_g = qend - qt0;
  // thread 0 issues every TMA copy: Q, dO, lse and dD of iteration i into
  // stage i % STAGES, completing on full[stage]
  const bool issuer = threadIdx.x == 0;
  auto load_tile = [&](int i) {
    const int s = i % STAGES;
    const int h = hk * G + i / per_g;
    const int q0 = (qt0 + i % per_g) * BQ;
    mbar_expect_tx(&full[s], 2 * F::QT + 2 * F::VEC);
    for (int cb = 0; cb < F::NB; ++cb) {
      tma_load_3d(sm + F::OFF_Q + s * F::QT + cb * BQ * F::SW, &tq, &full[s],
                  cb * F::AE, q0, h);
      tma_load_3d(sm + F::OFF_O + s * F::QT + cb * BQ * F::SW, &tdo,
                  &full[s], cb * F::AE, q0, h);
    }
    tma_load_1d(sm + F::OFF_L + s * F::VEC, &tlse, &full[s], h * Slp + q0);
    tma_load_1d(sm + F::OFF_D + s * F::VEC, &tdd, &full[s], h * Slp + q0);
  };
  if (issuer && n_iter > 0) {
    mbar_expect_tx(kv_bar, 2 * F::KT);
    for (int cb = 0; cb < F::NB; ++cb) {
      tma_load_3d(sm + F::OFF_K + cb * BK * F::SW, &tk, kv_bar, cb * F::AE,
                  k0, hk);
      tma_load_3d(sm + F::OFF_V + cb * BK * F::SW, &tv, kv_bar, cb * F::AE,
                  k0, hk);
    }
    for (int i = 0; i < STAGES && i < n_iter; ++i) load_tile(i);
  }

  {
    // warpgroup wg owns keys kw .. kw + 63
    const int t = threadIdx.x & 127;
    const int wq = t >> 5, lane = t & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int kw = k0 + wg * 64;
    const uint32_t sK = smem_u32(sm + F::OFF_K);
    const uint32_t sV = smem_u32(sm + F::OFF_V);
    const float sl2 = scale * LOG2E;

    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

    // dQ partial of an iteration into the fp32 accumulator (rows past sq
    // hold 0)
    float dqa[F::NQ / 2];
    auto flush_dq = [&](int i) {
      const int h = hk * G + i / per_g;
      const int q0 = (qt0 + i % per_g) * BQ;
      const int cbase = F::KEY_SPLIT ? 0 : wg * F::NQ;
      const int qrow = static_cast<int>(
          opaque(static_cast<uint32_t>(q0 + 16 * wq + gid)));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qrow + 8 * r;
        if (qpos < sq) {
          float* row = dq + (static_cast<long long>(h) * Sqp + qpos) * HD +
                       cbase + 2 * tig;
#pragma unroll
          for (int j = 0; j < F::NQ / 8; ++j)
            red_add_v2(row + 8 * j, dqa[4 * j + 2 * r],
                       dqa[4 * j + 2 * r + 1]);
        }
      }
    };

    // dQ partial = dS K over this warpgroup's share from dS^T buffer b:
    // A = dS (64 q x keys) from the dS^T rows (MN-major), B = K rows
    // (MN-major)
    auto issue_dq = [&](int b) {
      constexpr int DQ_STEPS = F::KEY_SPLIT ? 4 : 8;
      const int r0 = F::KEY_SPLIT ? wg * 64 : 0;
      const uint64_t ds_ = desc(
          smem_u32(sm + F::OFF_S + b * F::DS) + r0 * 128, 128, F::DS, 1024);
      const uint64_t dk_ = desc(
          sK + (F::KEY_SPLIT ? 0 : wg * BK * F::SW) + r0 * F::SW, F::SW,
          BK * F::SW, 8 * F::SW);
#pragma unroll
      for (int kk = 0; kk < DQ_STEPS; ++kk)
        wgmma_ss<1, 1>(dqa, ds_ + ((kk * 16 * 128) >> 4),
                       dk_ + ((kk * 16 * F::SW) >> 4), kk > 0);
    };

    if (n_iter > 0) mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int q0 = (qt0 + it % per_g) * BQ;
      const uint32_t sQ = smem_u32(sm + F::OFF_Q + s * F::QT);
      const uint32_t sO = smem_u32(sm + F::OFF_O + s * F::QT);
      mbar_wait(&full[s], (it / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 q rows); the k index
      // (head dim) runs along the rows of all four tiles
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      {
        const uint64_t dk_ = desc(sK + wg * 64 * F::SW, F::SW, 16,
                                  8 * F::SW);
        const uint64_t dv_ = desc(sV + wg * 64 * F::SW, F::SW, 16,
                                  8 * F::SW);
        const uint64_t dq_ = desc(sQ, F::SW, 16, 8 * F::SW);
        const uint64_t do_ = desc(sO, F::SW, 16, 8 * F::SW);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = (kk % F::KPA) * 32;       // inside a column block
          const int kb = (kk / F::KPA) * BK * F::SW + c;
          const int qb = (kk / F::KPA) * BQ * F::SW + c;
          wgmma_ss<0, 0>(st, dk_ + (kb >> 4), dq_ + (qb >> 4), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = (kk % F::KPA) * 32;
          const int kb = (kk / F::KPA) * BK * F::SW + c;
          const int qb = (kk / F::KPA) * BQ * F::SW + c;
          wgmma_ss<0, 0>(dpt, dv_ + (kb >> 4), do_ + (qb >> 4), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // what follows is computed from here on, not hoisted above the
      // products while their accumulators are live
      const int qx = static_cast<int>(opaque(static_cast<uint32_t>(q0)));
      const int key = static_cast<int>(
          opaque(static_cast<uint32_t>(kw + 16 * wq + gid)));

      // P^T into st, dS^T into dpt; columns are q rows (lse, dD per
      // column), rows this thread's keys.  The mask is evaluated only on
      // tiles that cross the diagonal or the sq / sk edge.
      const float* Ls = reinterpret_cast<const float*>(
          sm + F::OFF_L + s * F::VEC);
      const float* Ds = reinterpret_cast<const float*>(
          sm + F::OFF_D + s * F::VEC);
      auto pds = [&](auto mask_on) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = 8 * j + 2 * tig;           // column in the tile
          const float2 l2 = *reinterpret_cast<const float2*>(Ls + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(Ds + qc);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float l = (c ? l2.y : l2.x) * LOG2E;
            const float dd = c ? d2.y : d2.x;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = 4 * j + 2 * i + c;
              float p;
              asm("ex2.approx.ftz.f32 %0, %1;\n"
                  : "=f"(p) : "f"(fmaf(st[r], sl2, -l)));
              float ds = p * (dpt[r] - dd) * scale;
              if (decltype(mask_on)::value &&
                  !live(qx + qc + c, key + 8 * i, sq, sk, causal)) {
                p = 0.f;
                ds = 0.f;
              }
              st[r] = p;
              dpt[r] = ds;
            }
          }
        }
      };
      if ((causal && kw + 63 > qx) || qx + BQ > sq || kw + 64 > sk)
        pds(std::true_type{});
      else
        pds(std::false_type{});

      // bf16 pairs (q, q + 1) into the P^T and dS^T tiles, the A operands
      // of dV += P^T dO, dK += dS^T Q and dQ = dS K: row = key of the
      // block, 64 q columns of 128 B, 128-byte swizzle (16-byte chunk ^
      // row % 8; rows key and key + 8 share row % 8 = gid)
      uint8_t* const sP_row = sm + F::OFF_P;
      uint8_t* const sS_row = sm + F::OFF_S + (it % NDS) * F::DS;
      {
        const uint32_t x = opaque(static_cast<uint32_t>(gid));
        const int rbyte = (wg * 64 + 16 * wq + gid) * 128 + tig * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t chunk = (j ^ x) << 4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i;
            const int off = rbyte + i * 8 * 128 + chunk;
            *reinterpret_cast<uint32_t*>(sP_row + off) =
                pack_bf16(st[r], st[r + 1]);
            *reinterpret_cast<uint32_t*>(sS_row + off) =
                pack_bf16(dpt[r], dpt[r + 1]);
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(&ds_bar[it % NDS]);   // read by dQ one iteration later
      named_bar_sync(1 + wg, 128);      // this warpgroup's rows

      // dV += P^T dO, dK += dS^T Q (A: this warpgroup's 64 rows of P^T,
      // dS^T, K-major; B: the dO, Q tile, MN-major), and the previous
      // iteration's dQ partial, in one batch.  At it = 0 that product
      // reads an unwritten buffer and its result is dropped: the batch
      // stays the same at every iteration.
      if (it > 0)
        mbar_wait(&ds_bar[(it - 1) % NDS], ((it - 1) / NDS) & 1);
#pragma unroll
      for (int i = 0; i < F::NQ / 2; ++i) dqa[i] = 0.f;
      {
        const uint64_t dp_ = desc(smem_u32(sP_row) + wg * 64 * 128, 128,
                                  16, 1024);
        const uint64_t dsk_ = desc(smem_u32(sS_row) + wg * 64 * 128, 128,
                                   16, 1024);
        const uint64_t do_ = desc(sO, F::SW, BQ * F::SW, 8 * F::SW);
        const uint64_t dq_ = desc(sQ, F::SW, BQ * F::SW, 8 * F::SW);
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(dva, dp_ + ((kk * 32) >> 4),
                         do_ + ((kk * 16 * F::SW) >> 4), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(dka, dsk_ + ((kk * 32) >> 4),
                         dq_ + ((kk * 16 * F::SW) >> 4), 1);
        issue_dq((it + NDS - 1) % NDS);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_arrive(&empty[s]);           // Q, dO, lse, dD consumed
      if (it > 0) flush_dq(it - 1);

      // refill stage s for iteration it + STAGES once both warpgroups
      // have released it
      if (issuer && it + STAGES < n_iter) {
        mbar_wait(&empty[s], (it / STAGES) & 1);
        load_tile(it + STAGES);
      }
    }
    if (n_iter > 0) {                     // the last iteration's dQ
      mbar_wait(&ds_bar[(n_iter - 1) % NDS], ((n_iter - 1) / NDS) & 1);
#pragma unroll
      for (int i = 0; i < F::NQ / 2; ++i) dqa[i] = 0.f;
      fence_regs(dqa);
      wgmma_fence();
      issue_dq((n_iter - 1) % NDS);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      flush_dq(n_iter - 1);
    }
    // dK, dV rows of this thread's keys, once, in bf16 (keys past sk
    // accumulated exact zeros); dka and dva are touched only by the
    // products until here
    fence_regs(dva);
    fence_regs(dka);
    const long long kbase = static_cast<long long>(hk) * Skp * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kw + 16 * wq + gid + 8 * i;
      if (key < Skp) {
        uint32_t* rk = reinterpret_cast<uint32_t*>(
            dk + kbase + static_cast<long long>(key) * HD);
        uint32_t* rv = reinterpret_cast<uint32_t*>(
            dv + kbase + static_cast<long long>(key) * HD);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int r = 4 * j + 2 * i;
          rk[4 * j + tig] = pack_bf16(dka[r], dka[r + 1]);
          rv[4 * j + tig] = pack_bf16(dva[r], dva[r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register micro-tiles, cp.async staging
// ---------------------------------------------------------------------------

constexpr int T32 = 256;        // eight warps
constexpr int NJ = 4;           // B rows a thread in S, dP (S^T, dP^T):
//                                 g + 16 j, j < NJ
constexpr int DQ_BQ = 64;       // dq: q rows per block
constexpr int DQ_BK = 16 * NJ;  // dq: keys per tile
constexpr int KV_BK = 64;       // dkv: keys per block
constexpr int KV_BQ = 16 * NJ;  // dkv: q rows per tile
constexpr int XP = 64 + 4;      // pitch of the transposed dS / P tiles

// cp.async: 16 (or 4) bytes from device into shared memory, zero-filled
// and reading nothing when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the last committed) is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + N) of a (.., HD) fp32 matrix into a tile of pitch
// HD + 4, by cp.async; rows at or past `rows` are zero
template <int HD, int N>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int rows) {
  constexpr int CH = HD / 4;               // 16-byte chunks a row
  for (int i = threadIdx.x; i < N * CH; i += T32) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * (HD + 4) + c,
               src + (ok ? static_cast<long long>(r0 + r) * HD + c : 0), ok);
  }
}

// Each thread's share of an output row of HD columns, as HD / 16 columns
// in 16-byte chunks where there are four or more: lane group g (0 .. 15)
// takes chunks g and g + 16 (hd 128) or chunk g (hd 64), else HD / 16
// adjacent columns.  A warp's loads of one row then cover distinct
// chunks (no bank conflict).
template <int HD>
struct Cols {
  static constexpr int N = HD / 16;
  __device__ __forceinline__ static int at(int g, int j) {
    return N >= 4 ? (j / 4) * 64 + 4 * g + j % 4 : N * g + j;
  }
  // the N values of row `row` of a tile of pitch ld at this thread's
  // columns
  __device__ __forceinline__ static void load(float (&x)[N], const float* t,
                                              int ld, int row, int g) {
    if constexpr (N >= 4) {
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(t + row * ld + at(g, j));
        x[j] = v.x;
        x[j + 1] = v.y;
        x[j + 2] = v.z;
        x[j + 3] = v.w;
      }
    } else if constexpr (N == 2) {
      const float2 v =
          *reinterpret_cast<const float2*>(t + row * ld + at(g, 0));
      x[0] = v.x;
      x[1] = v.y;
    } else {
      x[0] = t[row * ld + at(g, 0)];
    }
  }
};

// Two score products of a thread's 4 x NJ micro-tile, contracting over HD
// in order (d = 0, 1, ..: one fmaf chain an output, as the plain
// version's fp32 products sum): s[i][j] = A1[ra + i] . B1[nb + 16 j] and
// t[i][j] = A2[ra + i] . B2[nb + 16 j] over rows of tiles of pitch HD + 4,
// read 4 columns at a time.  The four A rows are shared by 16 lanes
// (broadcast), the B rows nb + 16 j of the 16 lanes are distinct.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[4][NJ], float (&t)[4][NJ],
                                       const float* A1, const float* B1,
                                       const float* A2, const float* B2,
                                       int ra, int nb) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a1[4], a2[4], b1[NJ], b2[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a1[i] = *reinterpret_cast<const float4*>(A1 + (ra + i) * LD + d);
      a2[i] = *reinterpret_cast<const float4*>(A2 + (ra + i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      b1[j] = *reinterpret_cast<const float4*>(B1 + (nb + 16 * j) * LD + d);
      b2[j] = *reinterpret_cast<const float4*>(B2 + (nb + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(a1[i].x, b1[j].x, s[i][j]);
        s[i][j] = fmaf(a1[i].y, b1[j].y, s[i][j]);
        s[i][j] = fmaf(a1[i].z, b1[j].z, s[i][j]);
        s[i][j] = fmaf(a1[i].w, b1[j].w, s[i][j]);
        t[i][j] = fmaf(a2[i].x, b2[j].x, t[i][j]);
        t[i][j] = fmaf(a2[i].y, b2[j].y, t[i][j]);
        t[i][j] = fmaf(a2[i].z, b2[j].z, t[i][j]);
        t[i][j] = fmaf(a2[i].w, b2[j].w, t[i][j]);
      }
  }
}

// dq: one block per (head, 64-row q tile), heaviest causal tiles first.
// Q and dO are staged once; 64-key K / V tiles stream through two
// buffers, tile t + 1's copies in flight while tile t is used.  Per tile:
// S = Q K^T and dP = dO V^T, thread (rows 4 rg .. + 3, keys g + 16 j);
// dS into a transposed tile; dQ += dS K, thread (rows 4 rg .. + 3,
// HD / 16 of the columns).  Every output is one fmaf chain
// in the plain version's order (S over d, dQ over keys), so the results
// are those of a thread that loops over them one at a time.
template <int HD>
__global__ void __launch_bounds__(T32, 1)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dD, float* __restrict__ dq,
                    int G, int Sqp, int Skp, int sq, int sk, float scale,
                    int causal) {
  constexpr int LD = HD + 4;
  using C = Cols<HD>;
  extern __shared__ __align__(16) char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [DQ_BQ][LD]
  float* Os = Qs + DQ_BQ * LD;                  // [DQ_BQ][LD]  (dO)
  float* Ks = Os + DQ_BQ * LD;                  // [2][DQ_BK][LD]
  float* Vs = Ks + 2 * DQ_BK * LD;              // [2][DQ_BK][LD]
  float* St = Vs + 2 * DQ_BK * LD;              // [DQ_BK][XP]  (dS^T)

  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x;
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const long long kbase = static_cast<long long>(h / G) * Skp * HD;
  const int q0 = qt * DQ_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = 2 * warp + (lane >> 4);  // rows 4 rg .. 4 rg + 3
  const int g = lane & 15;                // keys g + 16 j; column group
  const int row0 = q0 + 4 * rg;
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    const long long at = static_cast<long long>(h) * Sqp + row;
    lr[i] = row < sq ? lse[at] : 0.f;
    dr[i] = row < sq ? dD[at] : 0.f;
  }

  const int nkt = (key_end(q0, DQ_BQ, sq, sk, causal) + DQ_BK - 1) / DQ_BK;
  stage_tile<HD, DQ_BQ>(Qs, q + qbase, q0, sq);
  stage_tile<HD, DQ_BQ>(Os, dO + qbase, q0, sq);
  if (nkt > 0) {
    stage_tile<HD, DQ_BK>(Ks, k + kbase, 0, sk);
    stage_tile<HD, DQ_BK>(Vs, v + kbase, 0, sk);
  }
  cp_async_commit();

  float acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C::N; ++j) acc[i][j] = 0.f;
  // the warp's last live row: a key tile past it (causal), or a warp
  // whose rows are all past sq, has nothing to add (its dS would be 0)
  const int wrow = q0 + 8 * warp;
  const int wlast = min(wrow + 7, sq - 1);

  for (int t = 0; t < nkt; ++t) {
    const int kb = t * DQ_BK;
    if (t + 1 < nkt) {
      const int b = (t + 1) & 1;
      stage_tile<HD, DQ_BK>(Ks + b * DQ_BK * LD, k + kbase, kb + DQ_BK, sk);
      stage_tile<HD, DQ_BK>(Vs + b * DQ_BK * LD, v + kbase, kb + DQ_BK, sk);
    }
    cp_async_commit();
    cp_async_wait1();                    // tile t (and Q, dO) landed
    __syncthreads();
    const float* Kt = Ks + (t & 1) * DQ_BK * LD;
    const float* Vt = Vs + (t & 1) * DQ_BK * LD;
    const bool busy = wrow < sq && !(causal && kb > wlast);
    if (busy) {
      float s[4][NJ], dp[4][NJ];
      scores<HD>(s, dp, Qs, Kt, Os, Vt, 4 * rg, g);
      // dS = P (dP - dD) scale with P = exp(S scale - lse) on the mask
      // and 0 off it, written as dS^T (key-major) for the dQ product
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float ds4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool on = live(row0 + i, kb + g + 16 * j, sq, sk, causal);
          const float p = on ? expf(s[i][j] * scale - lr[i]) : 0.f;
          ds4[i] = on ? p * (dp[i][j] - dr[i]) * scale : 0.f;
        }
        *reinterpret_cast<float4*>(St + (g + 16 * j) * XP + 4 * rg) =
            make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
      }
    }
    __syncwarp();                        // dS^T rows of this warp written
    if (busy) {
      // dQ += dS K over the tile's keys, in order
#pragma unroll 4
      for (int c = 0; c < DQ_BK; ++c) {
        const float4 d4 = *reinterpret_cast<const float4*>(St + c * XP +
                                                           4 * rg);
        float kc[C::N];
        C::load(kc, Kt, LD, c, g);
        const float dsr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::N; ++j)
            acc[i][j] = fmaf(dsr[i], kc[j], acc[i][j]);
      }
    }
    __syncthreads();                     // buffers t & 1 and St free
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row < Sqp) {
      float* out = dq + qbase + static_cast<long long>(row) * HD;
#pragma unroll
      for (int j = 0; j < C::N; ++j) out[C::at(g, j)] = acc[i][j];
    }
  }
}

// dkv: one block per (b, kv, 64-key tile), heaviest causal tiles first.
// K and V are staged once; the 64-row Q, dO, lse and dD tiles of the G
// query heads of the group, from the block's diagonal on, follow one
// another (a second buffer does not fit beside 64-row tiles).  Per tile:
// S^T = K Q^T and dP^T = V dO^T, thread (keys 4 kg .. + 3, q rows
// g + 16 j); P and dS into q-major tiles;
// dV += P^T dO and dK += dS^T Q, thread (keys 4 kg .. + 3, HD / 16 of the
// columns), held in registers over the whole loop and written once (no
// atomics).  Every output is one fmaf chain in the plain version's order
// (S^T over d; dV, dK over the G heads, then q rows).
template <int HD>
__global__ void __launch_bounds__(T32, 1)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD, float* __restrict__ dk,
                     float* __restrict__ dv, int G, int Sqp, int Skp, int sq,
                     int sk, float scale, int causal) {
  constexpr int LD = HD + 4;
  using C = Cols<HD>;
  extern __shared__ __align__(16) char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [KV_BK][LD]
  float* Vs = Ks + KV_BK * LD;                  // [KV_BK][LD]
  float* Qs = Vs + KV_BK * LD;                  // [KV_BQ][LD]
  float* Os = Qs + KV_BQ * LD;                  // [KV_BQ][LD]  (dO)
  float* Pt = Os + KV_BQ * LD;                  // [KV_BQ][XP]  (P, q-major)
  float* St = Pt + KV_BQ * XP;                  // [KV_BQ][XP]  (dS)
  float* Ls = St + KV_BQ * XP;                  // [KV_BQ]
  float* Ds = Ls + KV_BQ;                       // [KV_BQ]

  const int k0 = blockIdx.y * KV_BK;
  const int hk = blockIdx.x;
  const long long kbase = static_cast<long long>(hk) * Skp * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = 2 * warp + (lane >> 4);  // keys 4 kg .. 4 kg + 3
  const int g = lane & 15;                // q rows g + 16 j; column group
  const int key0 = k0 + 4 * kg;
  const int nq = (sq + KV_BQ - 1) / KV_BQ;
  const int qt0 = causal ? k0 / KV_BQ : 0;   // q rows below k0 see no key
  const int per_g = (k0 < sk && qt0 < nq) ? nq - qt0 : 0;
  const int n_iter = G * per_g;

  // Q, dO, lse and dD of iteration it: head hk * G + it / per_g, q tile
  // qt0 + it % per_g
  auto stage_q = [&](int it) {
    const int h = hk * G + it / per_g;
    const int qb = (qt0 + it % per_g) * KV_BQ;
    const long long qbase = static_cast<long long>(h) * Sqp * HD;
    stage_tile<HD, KV_BQ>(Qs, q + qbase, qb, sq);
    stage_tile<HD, KV_BQ>(Os, dO + qbase, qb, sq);
    for (int i = threadIdx.x; i < 2 * KV_BQ; i += T32) {
      const int r = i % KV_BQ;
      const bool ok = qb + r < sq;
      const float* src = (i < KV_BQ ? lse : dD) +
                         (ok ? static_cast<long long>(h) * Sqp + qb + r : 0);
      cp_async4((i < KV_BQ ? Ls : Ds) + r, src, ok);
    }
  };
  if (n_iter > 0) {
    stage_tile<HD, KV_BK>(Ks, k + kbase, k0, sk);
    stage_tile<HD, KV_BK>(Vs, v + kbase, k0, sk);
    stage_q(0);
  }
  cp_async_commit();

  float dka[4][C::N], dva[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C::N; ++j) dka[i][j] = dva[i][j] = 0.f;
  const int wkey = k0 + 8 * warp;        // the warp's first key

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait0();                    // iteration it's tiles landed
    __syncthreads();
    const int qb = (qt0 + it % per_g) * KV_BQ;
    // a warp whose keys are all past sk, or (causal) all past the tile's
    // last row, has nothing to add (its P and dS would be 0)
    const bool busy = wkey < sk && !(causal && wkey > qb + KV_BQ - 1);
    if (busy) {
      float st[4][NJ], dpt[4][NJ];
      scores<HD>(st, dpt, Ks, Qs, Vs, Os, 4 * kg, g);
      // P and dS of (q row g + 16 j, keys 4 kg ..), written q-major
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = g + 16 * j;
        float p4[4], ds4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool on = live(qb + qc, key0 + i, sq, sk, causal);
          const float p = on ? expf(st[i][j] * scale - Ls[qc]) : 0.f;
          p4[i] = p;
          ds4[i] = on ? p * (dpt[i][j] - Ds[qc]) * scale : 0.f;
        }
        *reinterpret_cast<float4*>(Pt + qc * XP + 4 * kg) =
            make_float4(p4[0], p4[1], p4[2], p4[3]);
        *reinterpret_cast<float4*>(St + qc * XP + 4 * kg) =
            make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
      }
    }
    __syncwarp();                        // this warp's keys' P, dS written
    if (busy) {
      // dV += P^T dO, dK += dS^T Q over the tile's q rows, in order
#pragma unroll 2
      for (int c = 0; c < KV_BQ; ++c) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pt + c * XP +
                                                           4 * kg);
        const float4 s4 = *reinterpret_cast<const float4*>(St + c * XP +
                                                           4 * kg);
        float oc[C::N], qc[C::N];
        C::load(oc, Os, LD, c, g);
        C::load(qc, Qs, LD, c, g);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::N; ++j) {
            dva[i][j] = fmaf(pr[i], oc[j], dva[i][j]);
            dka[i][j] = fmaf(sr[i], qc[j], dka[i][j]);
          }
      }
    }
    __syncthreads();                     // the tiles, Pt, St free
    if (it + 1 < n_iter) {
      stage_q(it + 1);
      cp_async_commit();
    }
  }
  // dK, dV of this thread's keys, once (keys past sk hold 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + i;
    if (key < Skp) {
      const long long off = kbase + static_cast<long long>(key) * HD;
#pragma unroll
      for (int j = 0; j < C::N; ++j) {
        dk[off + C::at(g, j)] = dka[i][j];
        dv[off + C::at(g, j)] = dva[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *dD;
  void *dq, *dk, *dv;
  int heads, G, Sqp, Skp, sq, sk;
  float scale;
  int causal;
  int Slp;     // row pitch of lse, dD (the fused kernel; else Sqp)
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  // heads fastest: the heaviest q tiles of every head go out first
  const dim3 grid(a.heads, (a.Sqp + DQ_BQ - 1) / DQ_BQ);
  const int smem = 4 * ((2 * DQ_BQ + 4 * DQ_BK) * (HD + 4) + DQ_BK * XP);
  auto kern = flash_dq_f32_kernel<HD>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, T32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.dD, static_cast<float*>(a.dq), a.G, a.Sqp, a.Skp, a.sq, a.sk, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  // KV heads fastest: the heaviest key tiles of every group go out first
  const dim3 grid(a.heads / a.G, (a.Skp + KV_BK - 1) / KV_BK);
  const int smem =
      4 * ((2 * KV_BK + 2 * KV_BQ) * (HD + 4) + 2 * KV_BQ * XP + 2 * KV_BQ);
  auto kern = flash_dkv_f32_kernel<HD>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, T32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.dD, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.G, a.Sqp,
      a.Skp, a.sq, a.sk, a.scale, a.causal);
  return cudaGetLastError();
}

// an fp32 vector of n values read in boxes of `box` (lse, dD as one run
// of heads * Slp values: a box that runs past a head's sq reads the pad or
// the next head, which only masked pairs see).  A box must start on a
// 16-byte boundary, so the row pitch Slp is a multiple of 4.
bool map_vec(CUtensorMap* m, const float* base, long long n, int box) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};      // unused at rank 1
  const cuuint32_t boxd[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t one[1] = {1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<float*>(base), dims, strides, boxd, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_fused(const Args& a, cudaStream_t stream) {
  using F = Fused<HD>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int hkv = a.heads / a.G;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  if (!map_rows(&tq, a.q, HD, a.sq, a.Sqp, a.heads, BQ, F::SW) ||
      !map_rows(&tdo, a.dO, HD, a.sq, a.Sqp, a.heads, BQ, F::SW) ||
      !map_rows(&tk, a.k, HD, a.sk, a.Skp, hkv, BK, F::SW) ||
      !map_rows(&tv, a.v, HD, a.sk, a.Skp, hkv, BK, F::SW) ||
      !map_vec(&tl, a.lse, static_cast<long long>(a.heads) * a.Slp, BQ) ||
      !map_vec(&td, a.dD, static_cast<long long>(a.heads) * a.Slp, BQ))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_fused_kernel<HD>;
  cudaError_t e = set_smem(kern, F::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, (a.Skp + BK - 1) / BK);
  kern<<<grid, THREADS, F::SMEM, stream>>>(
      tq, tk, tv, tdo, tl, td, static_cast<float*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.G, a.Sqp, a.Slp,
      a.Skp, a.sq, a.sk, a.scale, a.causal);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.heads >= 1 && a.G >= 1 && a.heads % a.G == 0 && a.Sqp >= 1 &&
         a.Skp >= 1 && a.sq >= 1 && a.sq <= a.Sqp && a.sk >= 1 &&
         a.sk <= a.Skp;
}

}  // namespace

// fp32: K7 dq (dtype must be 0, fp32)
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dO, const float* lse,
                               const float* dD, void* dq, int dtype,
                               int heads, int G, int Sqp, int Skp, int sq,
                               int sk, int hd, float scale, int causal,
                               void* stream) {
  const Args a{q, k, v, dO, lse, dD, dq, nullptr, nullptr,
               heads, G, Sqp, Skp, sq, sk, scale, causal, Sqp};
  if (dtype != 0 || !valid(a) || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_dq<16>(a, s));
    case 32: return static_cast<int>(launch_dq<32>(a, s));
    case 64: return static_cast<int>(launch_dq<64>(a, s));
    case 128: return static_cast<int>(launch_dq<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32: K7 dkv (dtype must be 0, fp32)
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse,
                                const float* dD, void* dk, void* dv,
                                int dtype, int heads, int G, int Sqp, int Skp,
                                int sq, int sk, int hd, float scale,
                                int causal, void* stream) {
  const Args a{q, k, v, dO, lse, dD, nullptr, dk, dv,
               heads, G, Sqp, Skp, sq, sk, scale, causal, Sqp};
  if (dtype != 0 || !valid(a) || heads / G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_dkv<16>(a, s));
    case 32: return static_cast<int>(launch_dkv<32>(a, s));
    case 64: return static_cast<int>(launch_dkv<64>(a, s));
    case 128: return static_cast<int>(launch_dkv<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of the fused kernel at head dim hd (0 if not taken)
extern "C" int rt_flash_bwd_fused_smem(int hd) {
  switch (hd) {
    case 16: return Fused<16>::SMEM;
    case 32: return Fused<32>::SMEM;
    case 64: return Fused<64>::SMEM;
    case 128: return Fused<128>::SMEM;
    default: return 0;
  }
}

// bf16: the fused kernel.  dq_acc is an fp32 (B, KV, G, Sqp, HD)
// accumulator the caller has zeroed; dk, dv bf16; lse and dD rows have a
// pitch of Slp >= Sqp values, a multiple of 4.
extern "C" int rt_flash_bwd_fused(const void* q, const void* k, const void* v,
                                  const void* dO, const float* lse,
                                  const float* dD, float* dq_acc, void* dk,
                                  void* dv, int Slp, int heads, int G,
                                  int Sqp, int Skp, int sq, int sk, int hd,
                                  float scale, int causal, void* stream) {
  const Args a{q, k, v, dO, lse, dD, dq_acc, dk, dv,
               heads, G, Sqp, Skp, sq, sk, scale, causal, Slp};
  if (!valid(a) || Slp < Sqp || Slp % 4 || (a.Skp + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_fused<16>(a, s));
    case 32: return static_cast<int>(launch_fused<32>(a, s));
    case 64: return static_cast<int>(launch_fused<64>(a, s));
    case 128: return static_cast<int>(launch_fused<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
