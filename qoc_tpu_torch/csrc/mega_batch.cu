// Fused batched-optimizer kernel, fidelity-only instance: n complete GRAPE
// iterations for every seed of a population in ONE launch.
//
// Replaces qoc_tpu/parallel/pallas_mega_batch.py::_kernel / _build_call
// (kernel 6) for the objective without penalties.  The kernel body, its
// design and its bound are in mega_batch.cuh; this file instantiates
// mega_batch_kernel<M, KG, false> for the supported M and generator slots
// and holds its C entry point, which qoc_tpu_torch/ops/_cuda.py loads with
// ctypes.

#include "mega_batch.cuh"

extern "C" int qoc_mega_batch_segment(QOC_BATCH_PARAMS, void* stream) {
  return qoc::launch_mega_batch<false>(QOC_BATCH_ARGS, qoc::BatchCostArgs{},
                                       stream);
}
