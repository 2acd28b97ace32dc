// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the reference's mask, the causal key range of a q tile, and a pair of
// fp32 values rounded to one packed bf16 pair.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

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

}  // namespace flash
