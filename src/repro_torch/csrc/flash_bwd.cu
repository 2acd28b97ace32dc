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
//                       exp, so no inf or NaN enters a product)
//   dp = do v^T                              fp32
//   ds = p * (dp - dD) * scale
//   dq = sum_k ds k      (ds rounded to k's dtype first)
//   dv = sum_q p^T do    (p rounded to do's dtype first)
//   dk = sum_q ds^T q    (ds rounded to q's dtype first)
// dk and dv sum over the G query heads of a KV group.  Outputs are written
// in the operands' dtype; padded rows of dq and keys past sk get 0.
// Layouts (contiguous, padded past the real lengths sq / sk):
//   q, do, dq (B, KV, G, Sqp, HD); k, v, dk, dv (B, KV, Skp, HD);
//   lse, dD (B, KV, G, Sqp) fp32.
//
// Design.  The TPU grids run their reduction axes in order and carry the
// accumulators in VMEM: dq over (.., nq, nk), dk/dv over (.., nk, G, nq).
// Hopper blocks run in no order, so each block owns its output tile and
// loops over the reduction itself, with no atomics (dk and dv are
// deterministic):
//  * dq: one block per (b, kv, g, 64-row q tile) loops over 32-key tiles
//    up to the diagonal; K and V tiles in shared memory, Q and dO as A
//    fragments in registers for the whole loop.  The heaviest causal q
//    tiles start first.
//  * dkv: one block per (b, kv, 64-key tile) loops over the G query heads
//    and, for each, over the 32-row q tiles from the diagonal on.  It
//    computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so that
//    each warp owns 16 keys: their dK and dV rows stay in registers
//    (2 x 64 fp32 a thread at hd 128), K, V and the current Q, dO tiles
//    in shared memory.  Key tile 0 (the heaviest) starts first.
//  * bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate) for all four
//    products; the p / ds accumulator fragments are rounded to bf16 and
//    re-packed in registers as the A operand of the next product, where
//    the reference rounds them.
//  * fp32 (the tight comparisons): CUDA cores, 256 threads, fp32
//    throughout.
// What bounds it: at the training shapes (hd 128, S 4096) the causal work,
// 2 hd FLOPs for each of the three (dq) or four (dkv) products of a live
// pair, i.e. 6 hd and 8 hd FLOPs a pair with the recomputed scores,
// against 989 TFLOP/s bf16: operations, not bytes.  This first version
// uses neither wgmma nor TMA nor a copy/compute pipeline.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

using flash::PAD16;
using flash::key_end;
using flash::live;
using flash::mma16816;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 64;   // dq: q rows per block (4 warps x 16)
constexpr int DQ_BK = 32;   // dq: keys per tile
constexpr int KV_BK = 64;   // dkv: keys per block (4 warps x 16)
constexpr int KV_BQ = 32;   // dkv: q rows per tile

// A fragments (row-major 16 x 16 per k-step) of rows r0, r1 = r0 + 8 of a
// (rows, HD) bf16 matrix in device memory; rows past `rows` read 0
template <int HD>
__device__ __forceinline__ void rows_to_a(const bf16* x, int rows, int r0,
                                          int tig, uint32_t (*a)[4]) {
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  const int r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = (ks * 16 + tig * 2) >> 1;
    a[ks][0] = r0 < rows ? x32[static_cast<long long>(r0) * (HD / 2) + c] : 0u;
    a[ks][1] = r1 < rows ? x32[static_cast<long long>(r1) * (HD / 2) + c] : 0u;
    a[ks][2] = r0 < rows ? x32[static_cast<long long>(r0) * (HD / 2) + c + 4] : 0u;
    a[ks][3] = r1 < rows ? x32[static_cast<long long>(r1) * (HD / 2) + c + 4] : 0u;
  }
}

// stage rows [r0, r0 + n) of a (.., HD) bf16 matrix into shared memory
// (row stride ld), 16 bytes a copy; rows at or past `rows` are zero
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           int r0, int n, int rows) {
  constexpr int CH = HD / 8;           // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      x = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// rows r0, r1 of an fp32 accumulator fragment (16 x HD) to bf16 rows
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, int rows, int r0,
                                           int tig, float (*acc)[4]) {
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = (n * 8 + tig * 2) >> 1;
    if (r0 < rows)
      o32[static_cast<long long>(r0) * (HD / 2) + c] =
          flash::pack_bf16(acc[n][0], acc[n][1]);
    if (r1 < rows)
      o32[static_cast<long long>(r1) * (HD / 2) + c] =
          flash::pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD, bf16* __restrict__ dq,
                     int G, int Sqp, int Skp, int sq, int sk, float scale,
                     int causal) {
  constexpr int LD = HD + PAD16;       // shared row stride, in bf16
  constexpr int KS = HD / 16;          // k-steps over the head dim
  constexpr int NT = DQ_BK / 8;        // n-tiles of S and dP
  constexpr int ND = HD / 8;           // n-tiles of dQ
  extern __shared__ __align__(16) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + DQ_BK * LD;
  const uint16_t* Kh = reinterpret_cast<const uint16_t*>(Ks);

  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;            // (b * KV + kv) * G + g
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const long long kbase = static_cast<long long>(h / G) * Skp * HD;
  const int q0 = qt * DQ_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 + gid;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  uint32_t qa[KS][4], oa[KS][4];       // Q and dO rows, kept for the loop
  rows_to_a<HD>(q + qbase, Sqp, r0, tig, qa);
  rows_to_a<HD>(dO + qbase, Sqp, r0, tig, oa);
  const long long lb = static_cast<long long>(h) * Sqp;
  const float lse0 = r0 < Sqp ? lse[lb + r0] : 0.f;
  const float lse1 = r1 < Sqp ? lse[lb + r1] : 0.f;
  const float dd0 = r0 < Sqp ? dD[lb + r0] : 0.f;
  const float dd1 = r1 < Sqp ? dD[lb + r1] : 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kend = key_end(q0, DQ_BQ, sq, sk, causal);
  for (int kb = 0; kb < kend; kb += DQ_BK) {
    stage_rows<HD>(Ks, LD, k + kbase, kb, DQ_BK, sk);
    stage_rows<HD>(Vs, LD, v + kbase, kb, DQ_BK, sk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: B operands (k = head dim) from K, V rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const uint32_t* krow =
          reinterpret_cast<const uint32_t*>(Ks + (j * 8 + gid) * LD);
      const uint32_t* vrow =
          reinterpret_cast<const uint32_t*>(Vs + (j * 8 + gid) * LD);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma16816(s[j], qa[ks], krow[ks * 8 + tig], krow[ks * 8 + tig + 4]);
        mma16816(dp[j], oa[ks], vrow[ks * 8 + tig], vrow[ks * 8 + tig + 4]);
      }
    }
    // p = exp(s - lse) on the mask, ds = p (dp - dD) scale, into s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = kb + j * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = live(r0, c + e, sq, sk, causal)
                             ? __expf(s[j][e] * scale - lse0) : 0.f;
        const float p1 = live(r1, c + e, sq, sk, causal)
                             ? __expf(s[j][2 + e] * scale - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dd0) * scale;
        s[j][2 + e] = p1 * (dp[j][2 + e] - dd1) * scale;
      }
    }
    // dQ += dS K: dS (bf16) straight from the fragments, K (k = key,
    // n = head dim) read as pairs of bf16
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t da[4];
      flash::acc_to_a(s, kk, da);
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + gid;
        mma16816(acc[n], da, flash::col_pair(Kh, LD, key, d),
                 flash::col_pair(Kh, LD, key + 8, d));
      }
    }
    __syncthreads();
  }
  store_rows<HD>(dq + qbase, Sqp, r0, tig, acc);
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ dD, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int G, int Sqp, int Skp, int sq,
                      int sk, float scale, int causal) {
  constexpr int LD = HD + PAD16;
  constexpr int KS = HD / 16;          // k-steps over the head dim
  constexpr int NT = KV_BQ / 8;        // n-tiles (q columns) of S^T, dP^T
  constexpr int ND = HD / 8;           // n-tiles of dK, dV
  extern __shared__ __align__(16) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [KV_BK][LD]
  bf16* Vs = Ks + KV_BK * LD;                 // [KV_BK][LD]
  bf16* Qs = Vs + KV_BK * LD;                 // [KV_BQ][LD]
  bf16* Os = Qs + KV_BQ * LD;                 // [KV_BQ][LD]  (dO)
  float* Ls = reinterpret_cast<float*>(Os + KV_BQ * LD);  // [KV_BQ]
  float* Ds = Ls + KV_BQ;                                 // [KV_BQ]
  const uint32_t* K32 = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* V32 = reinterpret_cast<const uint32_t*>(Vs);
  const uint16_t* Qh = reinterpret_cast<const uint16_t*>(Qs);
  const uint16_t* Oh = reinterpret_cast<const uint16_t*>(Os);

  const int k0 = blockIdx.x * KV_BK;
  const int hk = blockIdx.y;           // b * KV + kv
  const long long kbase = static_cast<long long>(hk) * Skp * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr0 = warp * 16 + gid;     // this thread's keys: kr0, kr0 + 8
  const int kr1 = kr0 + 8;
  const int key0 = k0 + kr0, key1 = k0 + kr1;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  if (k0 < sk) {
    stage_rows<HD>(Ks, LD, k + kbase, k0, KV_BK, sk);
    stage_rows<HD>(Vs, LD, v + kbase, k0, KV_BK, sk);
    // causal: q rows below k0 see none of these keys
    const int qstart = causal ? k0 / KV_BQ * KV_BQ : 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long qbase = static_cast<long long>(h) * Sqp * HD;
      const long long lb = static_cast<long long>(h) * Sqp;
      for (int qb = qstart; qb < sq; qb += KV_BQ) {
        __syncthreads();               // the last tile consumed
        stage_rows<HD>(Qs, LD, q + qbase, qb, KV_BQ, sq);
        stage_rows<HD>(Os, LD, dO + qbase, qb, KV_BQ, sq);
        for (int i = threadIdx.x; i < KV_BQ; i += blockDim.x) {
          Ls[i] = qb + i < sq ? lse[lb + qb + i] : 0.f;
          Ds[i] = qb + i < sq ? dD[lb + qb + i] : 0.f;
        }
        __syncthreads();
        // S^T = K Q^T, dP^T = V dO^T: A from this warp's K / V rows, B
        // (k = head dim, n = q row) from Q / dO rows
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int c = ks * 8 + tig;
          const uint32_t ka[4] = {K32[kr0 * (LD / 2) + c],
                                  K32[kr1 * (LD / 2) + c],
                                  K32[kr0 * (LD / 2) + c + 4],
                                  K32[kr1 * (LD / 2) + c + 4]};
          const uint32_t va[4] = {V32[kr0 * (LD / 2) + c],
                                  V32[kr1 * (LD / 2) + c],
                                  V32[kr0 * (LD / 2) + c + 4],
                                  V32[kr1 * (LD / 2) + c + 4]};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t* qrow =
                reinterpret_cast<const uint32_t*>(Qs + (j * 8 + gid) * LD);
            const uint32_t* orow =
                reinterpret_cast<const uint32_t*>(Os + (j * 8 + gid) * LD);
            mma16816(s[j], ka, qrow[c], qrow[c + 4]);
            mma16816(dp[j], va, orow[c], orow[c + 4]);
          }
        }
        // P^T into s, dS^T into dp; the columns are q rows
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = j * 8 + tig * 2 + e;
            const float l = Ls[qc], dd = Ds[qc];
            const float p0 = live(qb + qc, key0, sq, sk, causal)
                                 ? __expf(s[j][e] * scale - l) : 0.f;
            const float p1 = live(qb + qc, key1, sq, sk, causal)
                                 ? __expf(s[j][2 + e] * scale - l) : 0.f;
            s[j][e] = p0;
            s[j][2 + e] = p1;
            dp[j][e] = p0 * (dp[j][e] - dd) * scale;
            dp[j][2 + e] = p1 * (dp[j][2 + e] - dd) * scale;
          }
        }
        // dV += P^T dO, dK += dS^T Q: B (k = q row, n = head dim) as
        // pairs of bf16 from the dO / Q tiles
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk) {
          uint32_t pa[4], da[4];
          flash::acc_to_a(s, kk, pa);
          flash::acc_to_a(dp, kk, da);
          const int qr = kk * 16 + tig * 2;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const int d = n * 8 + gid;
            mma16816(dva[n], pa, flash::col_pair(Oh, LD, qr, d),
                     flash::col_pair(Oh, LD, qr + 8, d));
            mma16816(dka[n], da, flash::col_pair(Qh, LD, qr, d),
                     flash::col_pair(Qh, LD, qr + 8, d));
          }
        }
      }
    }
  }
  store_rows<HD>(dk + kbase, Skp, key0, tig, dka);
  store_rows<HD>(dv + kbase, Skp, key0, tig, dva);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int T32 = 256;
constexpr int DQ_BQ32 = 64;   // dq: q rows per block, four threads per row
constexpr int DQ_BK32 = 32;   // dq: keys per tile
constexpr int KV_BK32 = 32;   // dkv: keys per block, eight threads per key
constexpr int KV_BQ32 = 32;   // dkv: q rows per tile

// rows [r0, r0 + n) of a (.., HD) fp32 matrix into shared memory (row
// stride HD + 1: no bank conflicts); rows at or past `rows` are zero
template <int HD>
__device__ __forceinline__ void stage_rows32(float* dst, const float* src,
                                             int r0, int n, int rows) {
  for (int i = threadIdx.x; i < n * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        r0 + r < rows ? src[static_cast<long long>(r0 + r) * HD + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(T32)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dD, float* __restrict__ dq,
                    int G, int Sqp, int Skp, int sq, int sk, float scale,
                    int causal) {
  constexpr int LQ = HD + 1;
  constexpr int DPT = HD / 4;          // head dims per thread (d = sub + 4i)
  constexpr int KPT = DQ_BK32 / 4;     // keys per thread (c = sub + 4j)
  constexpr int LS = DQ_BK32 + 1;
  extern __shared__ __align__(16) char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [DQ_BQ32][LQ]
  float* Os = Qs + DQ_BQ32 * LQ;                // [DQ_BQ32][LQ]  (dO)
  float* Ks = Os + DQ_BQ32 * LQ;                // [DQ_BK32][LQ]
  float* Vs = Ks + DQ_BK32 * LQ;                // [DQ_BK32][LQ]
  float* Ss = Vs + DQ_BK32 * LQ;                // [DQ_BQ32][LS]  (dS)

  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const long long kbase = static_cast<long long>(h / G) * Skp * HD;
  const int q0 = qt * DQ_BQ32;
  const int rl = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int row = q0 + rl;
  const long long lb = static_cast<long long>(h) * Sqp;
  const float lr = row < Sqp ? lse[lb + row] : 0.f;
  const float dr = row < Sqp ? dD[lb + row] : 0.f;

  stage_rows32<HD>(Qs, q + qbase, q0, DQ_BQ32, Sqp);
  stage_rows32<HD>(Os, dO + qbase, q0, DQ_BQ32, Sqp);
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int kend = key_end(q0, DQ_BQ32, sq, sk, causal);
  for (int kb = 0; kb < kend; kb += DQ_BK32) {
    __syncthreads();                   // Q / dO staged, last tile consumed
    stage_rows32<HD>(Ks, k + kbase, kb, DQ_BK32, sk);
    stage_rows32<HD>(Vs, v + kbase, kb, DQ_BK32, sk);
    __syncthreads();
    float s[KPT], dp[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[rl * LQ + d], od = Os[rl * LQ + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[j] = fmaf(qd, Ks[(sub + 4 * j) * LQ + d], s[j]);
        dp[j] = fmaf(od, Vs[(sub + 4 * j) * LQ + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = live(row, kb + sub + 4 * j, sq, sk, causal)
                          ? expf(s[j] * scale - lr) : 0.f;
      Ss[rl * LS + sub + 4 * j] = p * (dp[j] - dr) * scale;
    }
    __syncwarp();                      // a row's dS: written and read in-warp
    for (int c = 0; c < DQ_BK32; ++c) {
      const float ds = Ss[rl * LS + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(ds, Ks[c * LQ + sub + 4 * i], acc[i]);
    }
  }
  if (row < Sqp) {
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[qbase + static_cast<long long>(row) * HD + sub + 4 * i] = acc[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(T32)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD, float* __restrict__ dk,
                     float* __restrict__ dv, int G, int Sqp, int Skp, int sq,
                     int sk, float scale, int causal) {
  constexpr int LQ = HD + 1;
  constexpr int DPT = HD / 8;          // head dims per thread (d = sub + 8i)
  constexpr int QPT = KV_BQ32 / 8;     // q rows per thread (c = sub + 8j)
  constexpr int LS = KV_BQ32 + 1;
  extern __shared__ __align__(16) char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [KV_BK32][LQ]
  float* Vs = Ks + KV_BK32 * LQ;                // [KV_BK32][LQ]
  float* Qs = Vs + KV_BK32 * LQ;                // [KV_BQ32][LQ]
  float* Os = Qs + KV_BQ32 * LQ;                // [KV_BQ32][LQ]  (dO)
  float* Ps = Os + KV_BQ32 * LQ;                // [KV_BK32][LS]  (P^T)
  float* Ss = Ps + KV_BK32 * LS;                // [KV_BK32][LS]  (dS^T)
  float* Ls = Ss + KV_BK32 * LS;                // [KV_BQ32]
  float* Ds = Ls + KV_BQ32;                     // [KV_BQ32]

  const int k0 = blockIdx.x * KV_BK32;
  const int hk = blockIdx.y;
  const long long kbase = static_cast<long long>(hk) * Skp * HD;
  const int kl = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int key = k0 + kl;
  float dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;

  if (k0 < sk) {
    stage_rows32<HD>(Ks, k + kbase, k0, KV_BK32, sk);
    stage_rows32<HD>(Vs, v + kbase, k0, KV_BK32, sk);
    const int qstart = causal ? k0 / KV_BQ32 * KV_BQ32 : 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long qbase = static_cast<long long>(h) * Sqp * HD;
      const long long lb = static_cast<long long>(h) * Sqp;
      for (int qb = qstart; qb < sq; qb += KV_BQ32) {
        __syncthreads();
        stage_rows32<HD>(Qs, q + qbase, qb, KV_BQ32, sq);
        stage_rows32<HD>(Os, dO + qbase, qb, KV_BQ32, sq);
        for (int i = threadIdx.x; i < KV_BQ32; i += blockDim.x) {
          Ls[i] = qb + i < sq ? lse[lb + qb + i] : 0.f;
          Ds[i] = qb + i < sq ? dD[lb + qb + i] : 0.f;
        }
        __syncthreads();
        float s[QPT], dp[QPT];
#pragma unroll
        for (int j = 0; j < QPT; ++j) s[j] = dp[j] = 0.f;
        for (int d = 0; d < HD; ++d) {
          const float kd = Ks[kl * LQ + d], vd = Vs[kl * LQ + d];
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            s[j] = fmaf(kd, Qs[(sub + 8 * j) * LQ + d], s[j]);
            dp[j] = fmaf(vd, Os[(sub + 8 * j) * LQ + d], dp[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int c = sub + 8 * j;
          const float p = live(qb + c, key, sq, sk, causal)
                              ? expf(s[j] * scale - Ls[c]) : 0.f;
          Ps[kl * LS + c] = p;
          Ss[kl * LS + c] = p * (dp[j] - Ds[c]) * scale;
        }
        __syncwarp();                  // a key's row: written and read in-warp
        for (int c = 0; c < KV_BQ32; ++c) {
          const float p = Ps[kl * LS + c], ds = Ss[kl * LS + c];
#pragma unroll
          for (int i = 0; i < DPT; ++i) {
            dva[i] = fmaf(p, Os[c * LQ + sub + 8 * i], dva[i]);
            dka[i] = fmaf(ds, Qs[c * LQ + sub + 8 * i], dka[i]);
          }
        }
      }
    }
  }
  if (key < Skp) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const long long off = kbase + static_cast<long long>(key) * HD + sub + 8 * i;
      dk[off] = dka[i];
      dv[off] = dva[i];
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
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
cudaError_t launch_dq(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((a.Sqp + DQ_BQ - 1) / DQ_BQ, a.heads);
    const int smem = 2 * DQ_BK * (HD + PAD16) * 2;
    auto kern = flash_dq_bf16_kernel<HD>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, 128, smem, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse,
        a.dD, static_cast<bf16*>(a.dq), a.G, a.Sqp, a.Skp, a.sq, a.sk,
        a.scale, a.causal);
    return cudaGetLastError();
  }
  const dim3 grid((a.Sqp + DQ_BQ32 - 1) / DQ_BQ32, a.heads);
  const int smem = 4 * ((2 * DQ_BQ32 + 2 * DQ_BK32) * (HD + 1) +
                        DQ_BQ32 * (DQ_BK32 + 1));
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
cudaError_t launch_dkv(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((a.Skp + KV_BK - 1) / KV_BK, a.heads / a.G);
    const int smem = 2 * (KV_BK + KV_BQ) * (HD + PAD16) * 2 + 2 * KV_BQ * 4;
    auto kern = flash_dkv_bf16_kernel<HD>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, 128, smem, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse,
        a.dD, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.G, a.Sqp,
        a.Skp, a.sq, a.sk, a.scale, a.causal);
    return cudaGetLastError();
  }
  const dim3 grid((a.Skp + KV_BK32 - 1) / KV_BK32, a.heads / a.G);
  const int smem = 4 * ((2 * KV_BK32 + 2 * KV_BQ32) * (HD + 1) +
                        2 * KV_BK32 * (KV_BQ32 + 1) + 2 * KV_BQ32);
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

bool valid(int dtype, const Args& a) {
  return (dtype == 0 || dtype == 1) && a.heads >= 1 && a.G >= 1 &&
         a.heads % a.G == 0 && a.Sqp >= 1 && a.Skp >= 1 && a.sq >= 1 &&
         a.sq <= a.Sqp && a.sk >= 1 && a.sk <= a.Skp;
}

}  // namespace

extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dO, const float* lse,
                               const float* dD, void* dq, int dtype,
                               int heads, int G, int Sqp, int Skp, int sq,
                               int sk, int hd, float scale, int causal,
                               void* stream) {
  const Args a{q, k, v, dO, lse, dD, dq, nullptr, nullptr,
               heads, G, Sqp, Skp, sq, sk, scale, causal};
  if (!valid(dtype, a) || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_dq<16>(dtype, a, s));
    case 32: return static_cast<int>(launch_dq<32>(dtype, a, s));
    case 64: return static_cast<int>(launch_dq<64>(dtype, a, s));
    case 128: return static_cast<int>(launch_dq<128>(dtype, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse,
                                const float* dD, void* dk, void* dv,
                                int dtype, int heads, int G, int Sqp, int Skp,
                                int sq, int sk, int hd, float scale,
                                int causal, void* stream) {
  const Args a{q, k, v, dO, lse, dD, nullptr, dk, dv,
               heads, G, Sqp, Skp, sq, sk, scale, causal};
  if (!valid(dtype, a) || heads / G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_dkv<16>(dtype, a, s));
    case 32: return static_cast<int>(launch_dkv<32>(dtype, a, s));
    case 64: return static_cast<int>(launch_dkv<64>(dtype, a, s));
    case 128: return static_cast<int>(launch_dkv<128>(dtype, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
