// Host side of the flash-attention kernels' TMA copies (flash_fwd.cu,
// flash_bwd.cu): tensor maps encoded with cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point (no link against libcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows [0, rows) of `heads` (rows, HD) bf16 matrices, the matrix h at
// `base + h * pitch_rows * HD`; boxes of (box_rows, sw / 2 columns).  Rows
// at or past `rows` (the real length) read as zeros.
inline bool map_rows(CUtensorMap* m, const void* base, int HD, int rows,
                     int pitch_rows, int heads, int box_rows, int sw) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(HD) * 2,
      static_cast<cuuint64_t>(pitch_rows) * HD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sw / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
