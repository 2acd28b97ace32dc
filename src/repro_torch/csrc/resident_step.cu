// Single-lane resident segment kernel: one lane, one CTA (or one cluster
// when the lane's adjacency needs several CTAs' shared memory).
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
template <bool STAGED>
__global__ void __launch_bounds__(rt::MAX_THREADS, 1)
    resident_step_kernel(const rt::LaneArgs a, int seq) {
  extern __shared__ __align__(16) char smem[];
  const int cl = a.cluster;
  const int rank = cl > 1 ? static_cast<int>(
      rt::cg::this_cluster().block_rank()) : 0;
  rt::lane_segment<STAGED>(a, 0, cl, rank, seq, smem);
}

int set_bytes[2][rt::MAX_DEVICES];   // dynamic smem set, per variant/device

}  // namespace

// Advance the lane of `*a` in place by up to a->spc guarded steps.
extern "C" int rt_resident_step(const rt::LaneArgs* a, int seq,
                                void* stream) {
  if (const int e = rt::check_args(*a)) return e;
  if (a->board != nullptr || a->lanes != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return a->staged
      ? rt::launch_lanes(resident_step_kernel<true>, *a, 1, seq, stream,
                         set_bytes[1])
      : rt::launch_lanes(resident_step_kernel<false>, *a, 1, seq, stream,
                         set_bytes[0]);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
