// Fused batched-optimizer kernel, costs instance: the fidelity objective
// plus any of the seven penalties, n complete GRAPE iterations for every
// seed of a population in ONE launch.
//
// Replaces the penalty and trajectory branches of
// qoc_tpu/parallel/pallas_mega_batch.py::_kernel (kernel 6; :265-382,
// :437-453, :498-508).  The kernel body, its design and its bound are in
// mega_batch.cuh; this file instantiates mega_batch_kernel<M, KG, true>
// for the supported M and generator slots (built in parallel with
// mega_batch.cu) and holds its C entry point.

#include "mega_batch.cuh"

extern "C" int qoc_mega_batch_segment_costs(QOC_BATCH_PARAMS,
                                            const qoc::BatchCostArgs* costs,
                                            void* stream) {
  return qoc::launch_mega_batch<true>(QOC_BATCH_ARGS, *costs, stream);
}
