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
// Design.  The TPU grid (B, KV, G, nq, nk) runs its key axis in order and
// carries m / l / acc in VMEM between grid steps.  Hopper blocks run in
// no order, so one block owns one (b, kv, g, 64-row q tile) and loops over
// the key tiles itself; K and V tiles are staged in shared memory, m, l
// and the accumulator stay in registers.  Key tiles wholly above the
// diagonal, and key tiles past sk, are never visited; a q tile made only
// of padded rows visits none.  The heaviest causal q tiles start first.
//  * bf16: 4 warps, each owning 16 query rows; S = Q K^T and O += P V on
//    the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//    The S accumulator fragment is re-packed in registers as the A
//    operand of P V, so P never touches shared memory.
//  * fp32 (the tight comparisons): CUDA cores, 256 threads, four per
//    query row; scores, P and the accumulator in fp32 throughout.
// What bounds it: at the prefill shapes (hd 128, S >= 4096) the causal
// work, 4 * hd * S^2 / 2 FLOPs per head, against 989 TFLOP/s bf16:
// operations, not bytes (q, k, v, o are read or written once).  This
// first version uses neither wgmma nor TMA nor a copy/compute pipeline.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

using flash::NEG;
using flash::PAD16;
using flash::key_end;
using flash::live;
using flash::mma16816;
using flash::pack_bf16;

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ16 = 64;    // q rows per block (4 warps x 16)
constexpr int BK16 = 64;    // keys per tile

template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int G, int Sqp, int Skp, int sq, int sk, float scale,
                      int causal) {
  constexpr int LD = HD + PAD16;       // shared row stride, in bf16
  constexpr int KS = HD / 16;          // k-steps of Q K^T
  constexpr int NT = BK16 / 8;         // n-tiles of S
  constexpr int ND = HD / 8;           // n-tiles of O
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK16 * LD;
  const uint16_t* Vh = reinterpret_cast<const uint16_t*>(Vs);

  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;            // (b * KV + kv) * G + g
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const long long kbase = static_cast<long long>(h / G) * Skp * HD;
  const int q0 = qt * BQ16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 + gid;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  // Q fragments (A operand, row-major 16 x 16 per k-step), kept in
  // registers for the whole key loop
  uint32_t qa[KS][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + qbase);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = (ks * 16 + tig * 2) >> 1;
      qa[ks][0] = r0 < Sqp ? q32[static_cast<long long>(r0) * (HD / 2) + c] : 0u;
      qa[ks][1] = r1 < Sqp ? q32[static_cast<long long>(r1) * (HD / 2) + c] : 0u;
      qa[ks][2] = r0 < Sqp ? q32[static_cast<long long>(r0) * (HD / 2) + c + 4] : 0u;
      qa[ks][3] = r1 < Sqp ? q32[static_cast<long long>(r1) * (HD / 2) + c + 4] : 0u;
    }
  }
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  const int kend = key_end(q0, BQ16, sq, sk, causal);
  for (int kb = 0; kb < kend; kb += BK16) {
    // stage the K and V tiles (16 B per thread per copy; keys >= sk -> 0)
    constexpr int CH = HD / 8;         // 16-byte chunks per row
    for (int i = threadIdx.x; i < BK16 * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = kv4;
      if (kb + r < sk) {
        const long long off = kbase + static_cast<long long>(kb + r) * HD + c;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T: B operand (col-major 16 x 8) from K rows
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t* krow =
          reinterpret_cast<const uint32_t*>(Ks + (j * 8 + gid) * LD);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma16816(s[j], qa[ks], krow[ks * 8 + tig], krow[ks * 8 + tig + 4]);
    }
    // scale, mask, online max
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = kb + j * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = live(r0, c + e, sq, sk, causal) ? s[j][e] * scale : NEG;
        s[j][2 + e] = live(r1, c + e, sq, sk, causal) ? s[j][2 + e] * scale
                                                      : NEG;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - mn0);
        s[j][2 + e] = __expf(s[j][2 + e] - mn1);
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }
    // O += P V: P (bf16) straight from the S fragments, V (B operand,
    // k = key, n = head dim) read as pairs of bf16 from shared memory
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t pa[4];
      flash::acc_to_a(s, kk, pa);
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + gid;
        mma16816(oacc[n], pa, flash::col_pair(Vh, LD, key, d),
                 flash::col_pair(Vh, LD, key + 8, d));
      }
    }
    __syncthreads();
  }

  // finish: the row sums over the 4 threads of a row, then o and lse
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(o + qbase);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = (n * 8 + tig * 2) >> 1;
    if (r0 < Sqp)
      o32[static_cast<long long>(r0) * (HD / 2) + c] =
          pack_bf16(oacc[n][0] * i0, oacc[n][1] * i0);
    if (r1 < Sqp)
      o32[static_cast<long long>(r1) * (HD / 2) + c] =
          pack_bf16(oacc[n][2] * i1, oacc[n][3] * i1);
  }
  if (tig == 0) {
    const long long lb = static_cast<long long>(h) * Sqp;
    if (r0 < Sqp) lse[lb + r0] = m0 + logf(l0);
    if (r1 < Sqp) lse[lb + r1] = m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;    // q rows per block, four threads per row
constexpr int BK32 = 32;    // keys per tile
constexpr int T32 = 256;

template <int HD>
__global__ void __launch_bounds__(T32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int G, int Sqp, int Skp, int sq,
                     int sk, float scale, int causal) {
  constexpr int LQ = HD + 1;           // padded rows: no bank conflicts
  constexpr int DPT = HD / 4;          // head dims per thread (d = sub + 4i)
  constexpr int KPT = BK32 / 4;        // keys per thread (c = sub + 4j)
  extern __shared__ __align__(16) char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BQ32][LQ]
  float* Ks = Qs + BQ32 * LQ;                   // [BK32][LQ]
  float* Vs = Ks + BK32 * LQ;                   // [BK32][HD]
  float* Ps = Vs + BK32 * HD;                   // [BQ32][BK32 + 1]

  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const long long qbase = static_cast<long long>(h) * Sqp * HD;
  const long long kbase = static_cast<long long>(h / G) * Skp * HD;
  const int q0 = qt * BQ32;
  const int rl = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int row = q0 + rl;

  for (int i = threadIdx.x; i < BQ32 * HD; i += T32) {
    const int r = i / HD, c = i % HD;
    Qs[r * LQ + c] = q0 + r < Sqp
        ? q[qbase + static_cast<long long>(q0 + r) * HD + c] : 0.f;
  }
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  const int kend = key_end(q0, BQ32, sq, sk, causal);
  for (int kb = 0; kb < kend; kb += BK32) {
    __syncthreads();                   // Qs written / last tile consumed
    for (int i = threadIdx.x; i < BK32 * HD; i += T32) {
      const int r = i / HD, c = i % HD;
      float kx = 0.f, vx = 0.f;
      if (kb + r < sk) {
        const long long off = kbase + static_cast<long long>(kb + r) * HD + c;
        kx = k[off];
        vx = v[off];
      }
      Ks[r * LQ + c] = kx;
      Vs[r * HD + c] = vx;
    }
    __syncthreads();
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[rl * LQ + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] = fmaf(qd, Ks[(sub + 4 * j) * LQ + d], s[j]);
    }
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = live(row, kb + sub + 4 * j, sq, sk, causal) ? s[j] * scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - mn);
      ps += p;
      Ps[rl * (BK32 + 1) + sub + 4 * j] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    __syncwarp();                      // a row's P: written and read in-warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int c = 0; c < BK32; ++c) {
      const float p = Ps[rl * (BK32 + 1) + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[c * HD + sub + 4 * i], acc[i]);
    }
  }
  l = fmaxf(l, 1e-30f);
  if (row < Sqp) {
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      o[qbase + static_cast<long long>(row) * HD + sub + 4 * i] = acc[i] / l;
    if (sub == 0) lse[static_cast<long long>(h) * Sqp + row] = m + logf(l);
  }
}

}  // namespace

template <typename T, typename Kernel>
static cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads,
                                 int smem, cudaStream_t stream, const void* q,
                                 const void* k, const void* v, void* o,
                                 float* lse, int G, int Sqp, int Skp, int sq,
                                 int sk, float scale, int causal) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, G, Sqp, Skp, sq, sk,
      scale, causal);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t dispatch(int dtype, int heads, int G, int Sqp, int Skp,
                            int sq, int sk, float scale, int causal,
                            cudaStream_t stream, const void* q, const void* k,
                            const void* v, void* o, float* lse) {
  if (dtype == 1) {
    const dim3 grid((Sqp + BQ16 - 1) / BQ16, heads);
    const int smem = 2 * BK16 * (HD + PAD16) * 2;
    return launch_kernel<__nv_bfloat16>(flash_fwd_bf16_kernel<HD>, grid, 128,
                                        smem, stream, q, k, v, o, lse, G, Sqp,
                                        Skp, sq, sk, scale, causal);
  }
  const dim3 grid((Sqp + BQ32 - 1) / BQ32, heads);
  const int smem = 4 * (BQ32 * (HD + 1) + BK32 * (HD + 1) + BK32 * HD +
                        BQ32 * (BK32 + 1));
  return launch_kernel<float>(flash_fwd_f32_kernel<HD>, grid, T32, smem,
                              stream, q, k, v, o, lse, G, Sqp, Skp, sq, sk,
                              scale, causal);
}

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int dtype, int heads, int G,
                            int Sqp, int Skp, int sq, int sk, int hd,
                            float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || heads < 1 || heads > 65535 || G < 1 ||
      heads % G != 0 || Sqp < 1 || Skp < 1 || sq < 1 || sq > Sqp || sk < 1 ||
      sk > Skp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 32: return static_cast<int>(dispatch<32>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 64: return static_cast<int>(dispatch<64>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    case 128: return static_cast<int>(dispatch<128>(dtype, heads, G, Sqp, Skp, sq, sk, scale, causal, s, q, k, v, o, lse));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
