// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the reference's mask, the causal key range of a q tile, and the bf16
// tensor-core product mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Fragment layouts of m16n8k16 (row.col), per thread (gid = lane / 4,
// tig = lane % 4):
//   A (16 x 16, row-major): a0 = A[gid][2tig..], a1 = A[gid+8][2tig..],
//                           a2 = A[gid][2tig+8..], a3 = A[gid+8][2tig+8..]
//   B (16 x 8, k x n):      b0 = B[2tig..2tig+1][gid], b1 = B[2tig+8..][gid]
//   C (16 x 8):             c0,c1 = C[gid][2tig..], c2,c3 = C[gid+8][2tig..]
// so an accumulator fragment of two neighbouring n-tiles is, packed to
// bf16 pairs, the A fragment of the next product along its columns.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace flash {

constexpr float NEG = -1e30f;
constexpr int PAD16 = 8;    // bf16 row padding in shared memory

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

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// B operand whose k index runs down the rows of a row-major bf16 tile in
// shared memory (stride ld): rows k, k + 1 of column n, as one pair
__device__ __forceinline__ uint32_t col_pair(const uint16_t* t, int ld, int k,
                                             int n) {
  return static_cast<uint32_t>(t[k * ld + n]) |
         (static_cast<uint32_t>(t[(k + 1) * ld + n]) << 16);
}

// the four accumulators of n-tiles 2kk and 2kk + 1, rounded to bf16, as
// the A fragment of a product over those 16 columns
__device__ __forceinline__ void acc_to_a(float (*c)[4], int kk,
                                         uint32_t* a) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace flash
