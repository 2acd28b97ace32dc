// Multi-lane resident pool kernel: one CTA (or one cluster of CTAs) per
// lane, every lane at once.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/resident_pool/kernel.py:resident_pool_kernel
// (built by make_resident_pool_call, dispatched by resident_pool/ops.py:
// resident_pool_segment).  Each lane runs the body of resident_lane.cuh
// on its own state (shared or per-lane context), then its rank-0 CTA
// publishes the scoreboard row [done, steps_per_call - advanced] and, when
// the lane is still active, the launch's `seq` in the host-mapped flag the
// run loop reads.  The TPU grid ran its cells one after another; here every
// lane runs at once on its own SMs.  What bounds it is in
// resident_lane.cuh.
#include "resident_lane.cuh"

namespace {

// 512 threads x at most 128 registers fill one SM's 65,536 registers
template <bool STAGED>
__global__ void __launch_bounds__(rt::MAX_THREADS, 1)
    resident_pool_kernel(const rt::LaneArgs a, int seq) {
  extern __shared__ __align__(16) char smem[];
  const int cl = a.cluster;
  const int rank = cl > 1 ? static_cast<int>(
      rt::cg::this_cluster().block_rank()) : 0;
  rt::lane_segment<STAGED>(a, blockIdx.x / cl, cl, rank, seq, smem);
}

int set_bytes[2][rt::MAX_DEVICES];   // dynamic smem set, per variant/device

}  // namespace

// Advance every lane of `*a` in place by up to a->spc guarded steps.
extern "C" int rt_resident_pool(const rt::LaneArgs* a, int seq,
                                void* stream) {
  if (const int e = rt::check_args(*a)) return e;
  if (a->board == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return a->staged
      ? rt::launch_lanes(resident_pool_kernel<true>, *a, a->lanes, seq,
                         stream, set_bytes[1])
      : rt::launch_lanes(resident_pool_kernel<false>, *a, a->lanes, seq,
                         stream, set_bytes[0]);
}
