// Flash-attention forward (K7 fwd): o = softmax(q k^T * scale) v per
// (batch, kv head, group member), with the row logsumexp lse.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:_fwd_kernel
// (flash_fwd_pallas, dispatched by flash_attention/ops.py).  It computes
// what that kernel computes, not its tiling: fp32 scores, the mask
// (kpos < sk) & (qpos < sq) & (kpos <= qpos if causal) with -1e30, an
// online max and sum over key tiles, p rounded to the input dtype before
// the p v product, o = acc / max(l, 1e-30) in q's dtype, lse = m + log(l).
// Layouts (contiguous, padded past the real lengths sq / sk):
//   q, o (B, KV, G, Sqp, HD); k, v (B, KV, Skp, HD); lse (B, KV, G, Sqp).
//
// What bounds it: at the prefill shapes (hd 128, S >= 4096) the causal
// work, 4 hd FLOPs a live (q, k) pair (S and P V), against 989 TFLOP/s
// bf16: operations, not bytes (q, k, v and o move once, ~5x below).
// Beside the products, the exponentials: one ex2 a pair, 16 a clock on
// an SM, take half as long as the products at hd 128, so the design
// keeps the special-function unit busy while the tensor cores are.
//
// Design.  The TPU grid (B, KV, G, nq, nk) runs its key axis in order and
// carries m / l / acc in VMEM between grid steps.  Hopper blocks run in no
// order, so one block owns 128 query rows of one head and loops over the
// key tiles itself; m, l and the O accumulator stay in registers.
//  * bf16: two warpgroups, each owning 64 of the rows (two consecutive
//    64-row tiles of one head: with 128-key tiles this does the same
//    causal tile work as giving them the same rows of two heads of a KV
//    group, and it takes any G).  Q comes in one TMA load; 128-key K and
//    V tiles stream through a 3-deep ring of shared-memory stages tracked
//    by full / empty mbarriers.  Thread 0 issues the first three tiles;
//    the warpgroup that releases tile i second (a shared counter per
//    stage decides which) waits for all eight warps on empty and issues
//    tile i + 3, so no warpgroup waits for a thread of the other to come
//    round to it.  Both products are wgmma (bf16 in, fp32 accumulate):
//      S = Q K^T  64 q rows x 128 keys a warpgroup, A and B from shared
//                 memory (both K-major);
//      O += P V   P from registers: the S accumulator, exp'd and rounded
//                 to bf16 pairs, is the A operand as it lies (the
//                 accumulator layout of 16 columns is the A fragment of a
//                 k16 step), so P never touches shared memory; V is the
//                 MN-major B operand, transposed by its descriptor.
//    Each warpgroup issues S of tile i + 1 with P V of tile i in one
//    batch and runs the softmax of tile i + 1 while P V is on the tensor
//    cores; the two warpgroups fill each other's gaps.  Softmax in base
//    2: on tiles that need no mask the row max is taken over the raw
//    scores and scale * log2(e) is folded into the exponent's multiply-
//    add; lse goes back to natural log.  A warp whose rows' maxima all
//    stayed put skips rescaling O (a factor of exactly 1).  The mask is
//    evaluated only on tiles that cross the diagonal or the ragged sq /
//    sk edge; the TMA tensor maps end at sq and sk, so rows past them
//    arrive as zeros.  Key tiles wholly above the diagonal, and past sk,
//    are never visited; a block of padded rows visits none.  The heaviest
//    causal blocks start first.  No producer warp: S (64), O (64) and P
//    (32) take 160 registers a thread, and with a third warpgroup, or a
//    ninth warp, ptxas's budget falls below what the kernel needs and it
//    serializes every wgmma (flash_bwd.cu).  Head dims 16, 32, 64, 112 and
//    128.  A tile's rows are column blocks of min(2 hd, 128) bytes, each
//    a TMA box; a head dim that is not a whole number of blocks (112) is
//    padded in shared memory only: the TMA boxes read the columns past hd
//    as zeros, S skips the all-zero k step and P V runs at n = 128, its
//    last 16 columns never written (Fwd::HP).  hd 112 thus keeps the
//    128-byte swizzle of hd 128 and its wgmma shapes (seven 16-column
//    blocks under the 32-byte swizzle ran 1.3x slower: PERF.md section 6).
//  * fp32 (the tight comparisons): CUDA cores, fp32 throughout, one
//    block of 256 threads per 64 query rows of one head, heads fastest in
//    the grid.  What bounds it: 4 hd FLOPs a live pair against the 67
//    TFLOP/s FP32 CUDA-core peak (operations), and beside the FMAs the
//    shared-memory words that feed them: an SM delivers 32 words a clock
//    from shared memory against 128 FMAs, so a loop that loads more than a
//    quarter of a word an FMA is held below the FP32 rate by shared memory
//    (one load an FMA: near a quarter of it).  Each thread therefore
//    computes register micro-tiles: 4 rows x 4 keys of S from 16-byte
//    loads along the head dim (half a word an FMA), then 4 rows x hd / 16
//    columns of O (3/8 of a word an FMA at hd 128); P goes through shared
//    memory between the two products.  K / V tiles of 64 keys arrive by
//    cp.async into two buffers, the next tile's copies in flight under
//    this tile's products.  The online softmax keeps its 32-key steps (a
//    64-key tile is two), and every output keeps the rounding sequence of
//    the earlier design that gave each query row four threads, so the
//    results are bit-identical to it (see flash_fwd_f32_kernel).  The
//    shared-memory attribute is set once a process and device
//    (flash::smem_once), not per launch.
#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

using flash::NEG;
using flash::key_end;
using flash::live;
using flash::pack_bf16;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16: wgmma / TMA
// ---------------------------------------------------------------------------

constexpr int BQ = 128;          // q rows per block (two warpgroups x 64)
constexpr int BK = 128;          // keys per tile
constexpr int THREADS = 256;     // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Fwd {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle, bytes
  static constexpr int AE = SW / 2;        // bf16 per swizzled row
  // the head dim in shared memory: whole column blocks, the TMA boxes
  // reading the columns past HD as zeros (hd 112: 128)
  static constexpr int HP = (HD + AE - 1) / AE * AE;
  static constexpr int NB = HP / AE;       // column blocks of a tile
  static constexpr int KPA = SW / 32;      // k16 steps per column block
  static constexpr int STAGES = 3;         // K / V ring depth
  static constexpr int QT = 64 * HP * 2;   // one warpgroup's Q tile, bytes
  static constexpr int KT = BK * HP * 2;   // K or V tile bytes
  static constexpr int OFF_Q = 0;          // two Q tiles
  static constexpr int OFF_K = 2 * QT;     // STAGES K tiles
  static constexpr int OFF_V = OFF_K + STAGES * KT;
  static constexpr int OFF_B = OFF_V + STAGES * KT;
  static constexpr int BYTES = OFF_B + (1 + 2 * STAGES) * 8 + STAGES * 4;
  static constexpr int SMEM = BYTES + 1024;   // + alignment of the base
  static_assert(QT % 1024 == 0 && KT % 1024 == 0, "1024-byte tiles");
  static_assert(HD % 16 == 0, "whole k16 steps");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int G,
                       int Sqp, int sq, int sk, float scale, int causal) {
  using F = Fwd<HD>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary (pointer arithmetic on
  // smem_raw keeps the shared window: 32-bit shared loads and stores)
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + F::OFF_B);
  uint64_t* full = q_bar + 1;              // [STAGES]: K, V tile landed
  uint64_t* empty = full + F::STAGES;      // [STAGES]: K, V tile consumed
  // [STAGES]: warpgroups done with the stage's tile, counted (the second
  // to finish refills the stage)
  uint32_t* done = reinterpret_cast<uint32_t*>(empty + F::STAGES);

  const int h = blockIdx.x;                // (b * KV + kv) * G + g
  const int hk = h / G;                    // b * KV + kv
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int n_tiles = (key_end(q0, BQ, sq, sk, causal) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform in the compiler's eyes (a shuffle from lane 0), so that
  // the descriptors built on it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // TMA copies of K and V of key tile i into stage i % STAGES, completing
  // on full[stage]: thread 0 issues Q and the first STAGES tiles; tile
  // i + STAGES is issued by the warpgroup that releases tile i last
  auto load_kv = [&](int i) {
    const int s = i % F::STAGES;
    mbar_expect_tx(&full[s], 2 * F::KT);
    for (int cb = 0; cb < F::NB; ++cb) {
      tma_load_3d(sm + F::OFF_K + s * F::KT + cb * BK * F::SW, &tk, &full[s],
                  cb * F::AE, i * BK, hk);
      tma_load_3d(sm + F::OFF_V + s * F::KT + cb * BK * F::SW, &tv, &full[s],
                  cb * F::AE, i * BK, hk);
    }
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(q_bar, 2 * F::QT);
    for (int w = 0; w < 2; ++w)
      for (int cb = 0; cb < F::NB; ++cb)
        tma_load_3d(sm + F::OFF_Q + w * F::QT + cb * 64 * F::SW, &tq, q_bar,
                    cb * F::AE, q0 + 64 * w, h);
    for (int i = 0; i < F::STAGES && i < n_tiles; ++i) load_kv(i);
  }

  // warpgroup wg owns rows qw .. qw + 63; this thread rows qw + 16 wq +
  // gid + 8 i (i = 0, 1), columns 8 j + 2 tig + c of every 8-wide block
  const int t = threadIdx.x & 127;
  const int wq = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qw = q0 + 64 * wg;
  const float sl2 = scale * LOG2E;
  const uint32_t sQ = smem_u32(sm + F::OFF_Q + wg * F::QT);

  float sacc[64];                // S of one tile, then exp2(S - m) in place
  uint32_t pa[8][4];             // P of one tile: bf16 pairs, A of P V
  float oacc[F::HP / 2];          // O: HP columns, the last HP - HD zero
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < F::HP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG, NEG};       // running row max, base-2 units
  float l[2] = {0.f, 0.f};       // running row sum, this thread's columns

  // S = Q K^T of tile it into sacc (64 q rows x 128 keys); the k index
  // (head dim) runs along the rows of both tiles, up to HD (the padded
  // columns are zero)
  auto issue_s = [&](int it) {
    const uint64_t dq_ = desc(sQ, F::SW, 16, 8 * F::SW);
    const uint64_t dk_ = desc(
        smem_u32(sm + F::OFF_K + (it % F::STAGES) * F::KT), F::SW, 16,
        8 * F::SW);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = (kk % F::KPA) * 32;         // inside a column block
      const int qb = (kk / F::KPA) * 64 * F::SW + c;
      const int kb = (kk / F::KPA) * BK * F::SW + c;
      wgmma_ss<0, 0>(sacc, dq_ + (qb >> 4), dk_ + (kb >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it: A = P (registers, 16 keys a step), B = the V
  // tile's 16 key rows (MN-major: head dim along the row)
  auto issue_pv = [&](int it) {
    const uint64_t dv_ = desc(
        smem_u32(sm + F::OFF_V + (it % F::STAGES) * F::KT), F::SW,
        BK * F::SW, 8 * F::SW);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      wgmma_rs<1>(oacc, pa[u], dv_ + ((u * 16 * F::SW) >> 4), 1);
    wgmma_commit();
  };
  auto fence_operands = [&]() {
    fence_regs(sacc);
    fence_regs(oacc);
#pragma unroll
    for (int u = 0; u < 8; ++u) fence_regs(pa[u]);
  };
  // the softmax of tile it on sacc: the running max and sum, exp2(s * sl2
  // - m) left in sacc, and the factor that rescales the rows' earlier
  // sums in corr.  Tiles that cross the diagonal or the sq / sk edge scale
  // the scores first and mask them; the others take the row max of the
  // raw scores (of their negatives if scale < 0) and fold the scaling
  // into the exponent.
  auto softmax = [&](int it, float (&corr)[2]) {
    // computed from here on, not hoisted above the product while its
    // accumulator is live
    const int key0 = static_cast<int>(
        opaque(static_cast<uint32_t>(it * BK + 2 * tig)));
    const int row0 = static_cast<int>(
        opaque(static_cast<uint32_t>(qw + 16 * wq + gid)));
    float ps[2] = {0.f, 0.f};
    auto body = [&](auto mask_on, auto neg_scale) {
      constexpr bool MASK = decltype(mask_on)::value;
      constexpr bool NEGS = decltype(neg_scale)::value;
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            if (MASK) {
              sacc[r] = live(row0 + 8 * i, key0 + 8 * j + c, sq, sk, causal)
                            ? sacc[r] * sl2 : NEG;
              mx[i] = fmaxf(mx[i], sacc[r]);
            } else {
              mx[i] = fmaxf(mx[i], NEGS ? -sacc[r] : sacc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], MASK ? mx[i] : mx[i] * fabsf(sl2));
        corr[i] = ex2(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const int i = (r >> 1) & 1;             // row gid + 8 i
        sacc[r] = MASK ? ex2(sacc[r] - m[i]) : ex2(fmaf(sacc[r], sl2, -m[i]));
        ps[i] += sacc[r];
      }
    };
    const int k_first = it * BK;
    if ((causal && k_first + BK - 1 > qw) || k_first + BK > sk ||
        qw + 64 > sq)
      body(std::true_type{}, std::false_type{});
    else if (sl2 >= 0.f)
      body(std::false_type{}, std::false_type{});
    else
      body(std::false_type{}, std::true_type{});
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ps[i];
  };
  // O rescaled (skipped by a warp whose rows' maxima all stayed put: a
  // factor of exactly 1) and P, the bf16 pairs of sacc, as the A
  // fragments of P V
  auto rescale_o = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < F::HP / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) oacc[4 * j + r] *= corr[r >> 1];
    }
  };
  auto to_p = [&](const float (&corr)[2]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[u][r] = pack_bf16(sacc[8 * u + 2 * r], sacc[8 * u + 2 * r + 1]);
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))
      rescale_o(corr);
  };

  // The pipeline: S of tile it + 1 is issued with P V of tile it, and its
  // softmax runs while P V is on the tensor cores.  The loop runs every
  // tile but the last, so that every batch has the same two products.
  if (n_tiles > 0) {
    float corr[2];
    mbar_wait(q_bar, 0);
    mbar_wait(&full[0], 0);
    fence_operands();
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax(0, corr);
    to_p(corr);
    for (int it = 0; it + 1 < n_tiles; ++it) {
      mbar_wait(&full[(it + 1) % F::STAGES], ((it + 1) / F::STAGES) & 1);
      fence_operands();
      wgmma_fence();
      issue_s(it + 1);
      issue_pv(it);
      wgmma_wait<1>();
      fence_regs(sacc);
      softmax(it + 1, corr);
      wgmma_wait<0>();
      fence_operands();
      // tile it consumed: every warp arrives on empty; the warpgroup that
      // finishes second waits for all eight and refills the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % F::STAGES]);
      if (t == 0 && it + F::STAGES < n_tiles &&
          (atomicAdd(&done[it % F::STAGES], 1u) & 1)) {
        mbar_wait(&empty[it % F::STAGES], (it / F::STAGES) & 1);
        load_kv(it + F::STAGES);
      }
      to_p(corr);
    }
    fence_operands();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_operands();
  }

  // finish: the row sums over the 4 threads of a row, then o and lse (rows
  // past sq hold values of the masked tiles: never read)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    const int row = qw + 16 * wq + gid + 8 * i;
    if (row < Sqp) {
      const float inv = 1.f / l[i];
      uint32_t* o32 = reinterpret_cast<uint32_t*>(
          o + (static_cast<long long>(h) * Sqp + row) * HD);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        o32[4 * j + tig] = pack_bf16(oacc[4 * j + 2 * i] * inv,
                                     oacc[4 * j + 2 * i + 1] * inv);
      if (tig == 0)
        lse[static_cast<long long>(h) * Sqp + row] = m[i] * LN2 + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register micro-tiles, cp.async staging
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;         // q rows per block
constexpr int BK32 = 32;         // keys per softmax step: the running max
//                                  and sum move every 32 keys
constexpr int KT32 = 2 * BK32;   // keys per staged K / V tile: two steps
constexpr int T32 = 256;         // eight warps
constexpr int XP32 = BQ32 + 4;   // pitch of the key-major P tile

template <int HD>
struct Fwd32 {
  static constexpr int LQ = HD + 4;                    // Q, K row pitch
  static constexpr int OFF_K = BQ32 * LQ;              // [2][KT32][LQ]
  static constexpr int OFF_V = OFF_K + 2 * KT32 * LQ;  // [2][KT32][HD]
  static constexpr int OFF_P = OFF_V + 2 * KT32 * HD;  // [KT32][XP32]
  static constexpr int OFF_S = OFF_P + KT32 * XP32;    // [2 steps][BQ32]
  static constexpr int SMEM = 4 * (OFF_S + 2 * BQ32);  // bytes
  static_assert(HD >= 16 && HD % 16 == 0, "head dims 16 .. 128");
  static_assert(HD <= 128, "the O micro-tile: HD / 16 columns a thread");
};

// K and V rows [k0, k0 + KT32) into one buffer by cp.async (K at pitch
// LQ, V at pitch HD), rows at or past sk zero
template <int HD>
__device__ __forceinline__ void stage_kv(float* Kb, float* Vb,
                                         const float* k, const float* v,
                                         int k0, int sk) {
  constexpr int CH = HD / 4;               // 16-byte chunks a row
  for (int i = threadIdx.x; i < KT32 * CH; i += T32) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < sk;
    const long long off = ok ? static_cast<long long>(k0 + r) * HD + c : 0;
    flash::cp_async16(Kb + r * (HD + 4) + c, k + off, ok);
    flash::cp_async16(Vb + r * HD + c, v + off, ok);
  }
}

// One block per (head, 64-row q tile), the heads fastest in the grid (the
// G query heads of a KV group run side by side and share K / V in L2) and
// the heaviest causal tiles first.  Q is staged once; 64-key K / V tiles
// (two softmax steps) stream through two buffers by cp.async, tile t + 1's
// copies in flight while tile t is used.  Thread (warp w, lane) owns rows
// 4 rg .. 4 rg + 3 (rg = 2 w + lane / 16) and, with g = lane % 16, keys
// g + 16 j of a tile (j < 2: step 0) and O columns Cols<HD>::at(g, .):
//  * S: a 4 x 4 micro-tile from 16-byte loads along the head dim (8 loads
//    feed 64 FMAs), one fmaf chain an output over d in order;
//  * a step's row max over the 16 lanes of the rows (xor 1 .. 8), then
//    corr = expf(m - mn) and p = expf(s - mn) per step, as before;
//  * P into a key-major tile; a step's row sum in the grouping of the
//    kernel that gave each row four threads (thread (row, sub) adds the
//    keys sub + 4 j of the step in order, then xor 1, then xor 2) by the
//    warp's (row, sub) threads from that tile, into a step-sum slot;
//  * l = l * corr + ps rounded twice (a multiply, then an add, as that
//    kernel compiled), o rescaled by corr at each step and summed over the
//    step's keys in order: a 4 x hd / 16 micro-tile, each key's four P
//    values (one 16-byte load) and hd / 16 V columns feeding hd / 4 FMAs.
// P and the step sums of a row are written and read by its own warp.
template <int HD>
__global__ void __launch_bounds__(T32, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int G, int Sqp, int Skp, int sq,
                     int sk, float scale, int causal) {
  using F = Fwd32<HD>;
  using C = flash::Cols<HD>;
  constexpr int LQ = F::LQ;
  constexpr unsigned ALL = 0xffffffffu;
  extern __shared__ __align__(16) float smem32[];
  float* Qs = smem32;                      // [BQ32][LQ]
  float* Ks = smem32 + F::OFF_K;
  float* Vs = smem32 + F::OFF_V;
  float* Ps = smem32 + F::OFF_P;           // P^T: [key][row]
  float* Ss = smem32 + F::OFF_S;           // step sums: [step][row]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ32;
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const float* kh = k + static_cast<long long>(h / G) * Skp * HD;
  const float* vh = v + static_cast<long long>(h / G) * Skp * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = 2 * warp + (lane >> 4);   // rows 4 rg .. 4 rg + 3
  const int g = lane & 15;                 // keys g + 16 j; column group
  const int srow = 8 * warp + (lane >> 2); // the row-sum pass: row, sub
  const int sub = lane & 3;
  const int kend = key_end(q0, BQ32, sq, sk, causal);
  const int nt = (kend + KT32 - 1) / KT32;

  {
    constexpr int CH = HD / 4;
    for (int i = threadIdx.x; i < BQ32 * CH; i += T32) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = q0 + r < Sqp;
      flash::cp_async16(
          Qs + r * LQ + c,
          q + qbase + (ok ? static_cast<long long>(q0 + r) * HD + c : 0), ok);
    }
  }
  if (nt > 0) stage_kv<HD>(Ks, Vs, kh, vh, 0, sk);
  flash::cp_async_commit();

  float acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 0; x < C::N; ++x) acc[i][x] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt)
      stage_kv<HD>(Ks + ((t + 1) & 1) * KT32 * LQ,
                   Vs + ((t + 1) & 1) * KT32 * HD, kh, vh, (t + 1) * KT32,
                   sk);
    flash::cp_async_commit();
    flash::cp_async_wait1();               // tile t (and Q) landed
    __syncthreads();
    const float* Kt = Ks + (t & 1) * KT32 * LQ;
    const float* Vt = Vs + (t & 1) * KT32 * HD;
    const int kb = t * KT32;
    const bool two = kb + BK32 < kend;     // step 1 is visited

    // S of rows 4 rg + i and keys kb + g + 16 j, over d in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (4 * rg + i) * LQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Kt + (g + 16 * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // scale and mask; each step's running max (exact in any order) and
    // corr; P = expf(s - max) of the key's step
    float corr[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live(row, kb + g + 16 * j, sq, sk, causal)
                      ? s[i][j] * scale : NEG;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(ALL, mx[0], off));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(ALL, mx[1], off));
      }
      const float mn0 = fmaxf(m[i], mx[0]);
      corr[0][i] = expf(m[i] - mn0);
      float mn1 = mn0;
      corr[1][i] = 1.f;
      if (two) {
        mn1 = fmaxf(mn0, mx[1]);
        corr[1][i] = expf(mn0 - mn1);
      }
      m[i] = mn1;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = expf(s[i][j] - (j < 2 ? mn0 : mn1));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (g + 16 * j) * XP32 + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();                          // the warp's rows of P written

    // each step's row sums: thread (srow, sub) adds keys sub + 4 u of the
    // step in order, then the row's four threads meet by xor 1, xor 2
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      if (st == 1 && !two) break;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < BK32 / 4; ++u)
        ps += Ps[(st * BK32 + sub + 4 * u) * XP32 + srow];
      ps += __shfl_xor_sync(ALL, ps, 1);
      ps += __shfl_xor_sync(ALL, ps, 2);
      if (sub == 0) Ss[st * BQ32 + srow] = ps;
    }
    __syncwarp();                          // the warp's step sums written

    // l and O, step by step: rescaled, then the step's keys in order
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      if (st == 1 && !two) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l[i] = __fadd_rn(__fmul_rn(l[i], corr[st][i]),
                         Ss[st * BQ32 + 4 * rg + i]);
#pragma unroll
        for (int x = 0; x < C::N; ++x) acc[i][x] *= corr[st][i];
      }
#pragma unroll 4
      for (int c = st * BK32; c < (st + 1) * BK32; ++c) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + c * XP32 +
                                                          4 * rg);
        const float pr[4] = {p.x, p.y, p.z, p.w};
        float vx[C::N];
        C::load(vx, Vt, HD, c, g);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < C::N; ++x)
            acc[i][x] = fmaf(pr[i], vx[x], acc[i][x]);
      }
    }
    __syncthreads();                       // buffer t & 1 free
  }
  flash::cp_async_wait0();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    const float li = fmaxf(l[i], 1e-30f);
    if (row < Sqp) {
      float* out = o + qbase + static_cast<long long>(row) * HD;
#pragma unroll
      for (int x = 0; x < C::N; ++x) out[C::at(g, x)] = acc[i][x] / li;
      if (g == 0) lse[static_cast<long long>(h) * Sqp + row] = m[i] + logf(li);
    }
  }
}

}  // namespace

template <int HD>
static cudaError_t launch_bf16(int heads, int G, int Sqp, int Skp, int sq,
                               int sk, float scale, int causal,
                               cudaStream_t stream, const void* q,
                               const void* k, const void* v, void* o,
                               float* lse) {
  using F = Fwd<HD>;
  if (hopper::encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!hopper::map_rows(&tq, q, HD, sq, Sqp, heads, 64, F::SW) ||
      !hopper::map_rows(&tk, k, HD, sk, Skp, heads / G, BK, F::SW) ||
      !hopper::map_rows(&tv, v, HD, sk, Skp, heads / G, BK, F::SW))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(heads, (Sqp + BQ - 1) / BQ);
  kern<<<grid, THREADS, F::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, G, Sqp, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t dispatch(int dtype, int heads, int G, int Sqp, int Skp,
                            int sq, int sk, float scale, int causal,
                            cudaStream_t stream, const void* q, const void* k,
                            const void* v, void* o, float* lse) {
  if (dtype == 1)
    return launch_bf16<HD>(heads, G, Sqp, Skp, sq, sk, scale, causal, stream,
                           q, k, v, o, lse);
  using F = Fwd32<HD>;
  if ((Sqp + BQ32 - 1) / BQ32 > 65535) return cudaErrorInvalidValue;
  auto kern = flash_fwd_f32_kernel<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t e = flash::smem_once(kern, F::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  // heads fastest: the heaviest q tiles of every head go out first
  const dim3 grid(heads, (Sqp + BQ32 - 1) / BQ32);
  kern<<<grid, T32, F::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, G, Sqp, Skp,
      sq, sk, scale, causal);
  return cudaGetLastError();
}

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int dtype, int heads, int G,
                            int Sqp, int Skp, int sq, int sk, int hd,
                            float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || heads < 1 || heads > 65535 || G < 1 ||
      heads % G != 0 || Sqp < 1 || Skp < 1 || sq < 1 || sq > Sqp || sk < 1 ||
      sk > Skp || (Sqp + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 32: return static_cast<int>(dispatch<32>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 64: return static_cast<int>(dispatch<64>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 112: return static_cast<int>(dispatch<112>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 128: return static_cast<int>(dispatch<128>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
