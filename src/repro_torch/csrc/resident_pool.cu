// Multi-lane resident pool kernel: grid = lanes, one block per lane.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/resident_pool/kernel.py:resident_pool_kernel
// (built by make_resident_pool_call, dispatched by resident_pool/ops.py:
// resident_pool_segment).  Each block runs the lane body of
// resident_lane.cuh on its own lane (shared or per-lane context), then
// publishes the scoreboard row [done, steps_per_call - advanced].  The
// TPU grid ran its cells one after another; here every lane runs at once
// on its own SM.  What bounds it is in resident_lane.cuh.
#include "resident_lane.cuh"

namespace {

// 512 threads x at most 128 registers fill one SM's 65,536 registers
__global__ void __launch_bounds__(512, 1) resident_pool_kernel(rt::LaneIn in0, rt::LaneOut out0,
                                     rt::Dims d, int* board) {
  extern __shared__ __align__(16) char smem[];
  rt::LaneIn in;
  rt::LaneOut out;
  const int b = blockIdx.x;
  rt::lane_pointers(b, d, in0, out0, in, out);
  rt::lane_segment(in, out, d, smem);
  if (threadIdx.x == 0) {
    const int* s = out.scal;
    const bool done = s[rt::S_LVL] < 0 && s[rt::S_TPOS] >= s[rt::S_NTASKS];
    board[2 * b] = done ? 1 : 0;
    board[2 * b + 1] = d.spc - (s[rt::S_STEPS] - in.scal[rt::S_STEPS]);
  }
}

}  // namespace

extern "C" int rt_resident_pool(
    int* board, const int* scal_in, const uint32_t* adj, const int* order,
    const int* rank, const int* rc, const uint32_t* lroot, int ctx_batched,
    const int* tasks, const uint32_t* lmask_in, const int* cstack_in,
    const uint32_t* pmask_in, const uint32_t* qmask_in,
    const uint32_t* rmask_in, const int* xstack_in, const uint32_t* outl_in,
    const uint32_t* outr_in, int* scal, uint32_t* lmask, int* cstack,
    uint32_t* pmask, uint32_t* qmask, uint32_t* rmask, int* xstack,
    uint32_t* outl, uint32_t* outr, int nu, int wu, int wv, int depth,
    int cap, int t_len, int m_real, int order_mode, int spc, int threads,
    int group, int stage_adj, int smem_bytes, int lanes, void* stream) {
  rt::Dims d{nu, wu, wv, depth, cap, t_len, m_real, order_mode, spc,
             group, stage_adj, ctx_batched};
  const int need = rt::smem_base_bytes(nu, wu, wv) + (stage_adj ? 4 * nu * wv : 0);
  if (smem_bytes < need || threads % 32 != 0 || group < 1 || group > 32 ||
      lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::LaneIn in{scal_in, adj, order, rank, rc, lroot, tasks, lmask_in,
                cstack_in, pmask_in, qmask_in, rmask_in, xstack_in, outl_in,
                outr_in};
  rt::LaneOut out{scal, lmask, cstack, pmask, qmask, rmask, xstack, outl,
                  outr};
  cudaError_t e = cudaFuncSetAttribute(
      resident_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  resident_pool_kernel<<<lanes, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(in, out, d,
                                                              board);
  return static_cast<int>(cudaGetLastError());
}
