// Single-lane resident segment kernel: grid = 1 block.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/resident_step/kernel.py:resident_kernel
// (built by make_resident_call, dispatched by resident_step/ops.py:
// resident_segment).  The lane body, its design and what bounds it are in
// resident_lane.cuh; this file is only the __global__ entry and its C
// launcher (bound with ctypes by kernels/_build.py).
#include "resident_lane.cuh"

namespace {

// 512 threads x at most 128 registers fill one SM's 65,536 registers
__global__ void __launch_bounds__(512, 1) resident_step_kernel(rt::LaneIn in, rt::LaneOut out,
                                     rt::Dims d) {
  extern __shared__ __align__(16) char smem[];
  rt::lane_segment(in, out, d, smem);
}

}  // namespace

extern "C" int rt_resident_step(
    const int* scal_in, const uint32_t* adj, const int* order,
    const int* rank, const int* rc, const uint32_t* lroot, int ctx_batched,
    const int* tasks, const uint32_t* lmask_in, const int* cstack_in,
    const uint32_t* pmask_in, const uint32_t* qmask_in,
    const uint32_t* rmask_in, const int* xstack_in, const uint32_t* outl_in,
    const uint32_t* outr_in, int* scal, uint32_t* lmask, int* cstack,
    uint32_t* pmask, uint32_t* qmask, uint32_t* rmask, int* xstack,
    uint32_t* outl, uint32_t* outr, int nu, int wu, int wv, int depth,
    int cap, int t_len, int m_real, int order_mode, int spc, int threads,
    int group, int stage_adj, int smem_bytes, void* stream) {
  rt::Dims d{nu, wu, wv, depth, cap, t_len, m_real, order_mode, spc,
             group, stage_adj, ctx_batched};
  const int need = rt::smem_base_bytes(nu, wu, wv) + (stage_adj ? 4 * nu * wv : 0);
  if (smem_bytes < need || threads % 32 != 0 || group < 1 || group > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::LaneIn in{scal_in, adj, order, rank, rc, lroot, tasks, lmask_in,
                cstack_in, pmask_in, qmask_in, rmask_in, xstack_in, outl_in,
                outr_in};
  rt::LaneOut out{scal, lmask, cstack, pmask, qmask, rmask, xstack, outl,
                  outr};
  cudaError_t e = cudaFuncSetAttribute(
      resident_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  resident_step_kernel<<<1, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(in, out, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
