// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the reference's mask, the causal key range of a q tile, a pair of fp32
// values rounded to one packed bf16 pair, cp.async copies into shared
// memory, a thread's columns of an output row (the fp32 kernels), and the
// dynamic shared-memory attribute set once a process.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace flash {

constexpr float NEG = -1e30f;

__device__ __forceinline__ bool live(int qpos, int kpos, int sq, int sk,
                                     int causal) {
  return kpos < sk && qpos < sq && (!causal || kpos <= qpos);
}

// number of keys a q tile [q0, q0 + bq) must visit (0 for padded rows)
__device__ __forceinline__ int key_end(int q0, int bq, int sq, int sk,
                                       int causal) {
  if (q0 >= sq) return 0;
  return causal ? min(sk, min(q0 + bq, sq)) : sk;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

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

// Each thread's share of an output row of HD columns, as HD / 16 columns
// in 16-byte chunks where that count is a multiple of four: lane group g
// (0 .. 15) takes chunks g and g + 16 (hd 128) or chunk g (hd 64), else
// HD / 16 adjacent columns (hd 16, 32 and 112; at hd 112 seven scalar
// loads at a lane stride of 7 words, which meet no bank twice).  A warp's
// loads of one row then cover distinct chunks (no bank conflict).
template <int HD>
struct Cols {
  static constexpr int N = HD / 16;
  static constexpr bool CHUNKS = N % 4 == 0;
  __device__ __forceinline__ static int at(int g, int j) {
    return CHUNKS ? (j / 4) * 64 + 4 * g + j % 4 : N * g + j;
  }
  // the N values of row `row` of a tile of pitch ld at this thread's
  // columns
  __device__ __forceinline__ static void load(float (&x)[N], const float* t,
                                              int ld, int row, int g) {
    if constexpr (CHUNKS) {
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
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = t[row * ld + at(g, j)];
    }
  }
};

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device in a process: the attribute stays set, so later launches skip
// the call.  `done` is the caller's static flag word (bit d: device d
// done), one per kernel and size.
template <typename Kernel>
inline cudaError_t smem_once(Kernel kernel, int bytes,
                             std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit)) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace flash
