// Fused Adam segment kernel, costs instance: the fidelity objective plus
// any of the seven penalties, n complete GRAPE iterations in ONE launch.
//
// Replaces the penalty and trajectory branches of
// qoc_tpu/ops/pallas_mega.py::_mega_kernel (kernel 3; :139-257, with
// pallas_tree.py's scan_forward_vals / scan_backward_vals, whose prefix
// products become per-segment walks of the states).  The kernel
// body, its design and its bound are in mega.cuh; this file instantiates
// mega_segment_kernel<M, true> for the supported M (built in parallel
// with mega.cu) and holds its C entry point.

#include "mega.cuh"

extern "C" int qoc_mega_segment_costs(QOC_MEGA_PARAMS,
                                      const qoc::CostArgs* costs,
                                      void* stream) {
  return qoc::launch_mega_segment<true>(
      QOC_MEGA_ARGS(QOC_ADAM_CONSTS, *costs, stream));
}
