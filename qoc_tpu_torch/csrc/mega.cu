// Fused Adam segment kernel, fidelity-only instance: n complete GRAPE
// iterations in ONE launch of one thread-block cluster.
//
// Replaces qoc_tpu/ops/pallas_mega.py::_mega_kernel / _build_mega_call
// (kernel 3) for the objective without penalties.  The kernel body, its
// design and its bound are in mega.cuh; this file instantiates
// mega_segment_kernel<M, false> for the supported M and holds its C entry
// point, which qoc_tpu_torch/ops/_cuda.py loads with ctypes.

#include "mega.cuh"

extern "C" int qoc_mega_segment(QOC_MEGA_PARAMS, void* stream) {
  return qoc::launch_mega_segment<false>(
      QOC_MEGA_ARGS(QOC_ADAM_CONSTS, qoc::CostArgs{}, stream));
}
