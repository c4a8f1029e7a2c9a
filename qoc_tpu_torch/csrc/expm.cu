// Batched Taylor exponential kernels: exp(A_t) for every timestep
// (kernel 7) and its exact VJP (kernel 8).
//
// Replace qoc_tpu/ops/pallas_expm.py::_fwd_kernel and ::_bwd_kernel behind
// its _call.  The math and the layout are in expm.cuh; this file holds the
// launches and their C entry points, which qoc_tpu_torch/ops/_cuda.py
// loads with ctypes.  Grid: one block per timestep (T blocks; config 4's
// 1000 steps fill the 132 SMs in about eight waves).

#include <cuda_runtime.h>

#include "expm.cuh"

static inline bool expm_shape_ok(int T, int M, int order, int scaling) {
  return T >= 1 && M >= qoc::kRows && M % qoc::kRows == 0 && order >= 0 &&
         scaling >= 0;
}

// A [T][M][M] -> E [T][M][M].  scratch [T][4][M][M] for M above
// kExpmSharedMaxM, else unused (may be null).
extern "C" int qoc_expm_forward(const float* A, int T, int M, int order,
                                int scaling, float* E, float* scratch,
                                void* stream) {
  if (!expm_shape_ok(T, M, order, scaling)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float inv = 1.f / (float)(1L << scaling);
  const int threads = qoc::expm_threads(M);
  if (M <= qoc::kExpmSharedMaxM) {
    const int smem = 4 * M * M * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        qoc::expm_forward_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    qoc::expm_forward_kernel<true><<<T, threads, smem, s>>>(
        A, M, order, scaling, inv, E, nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    qoc::expm_forward_kernel<false><<<T, threads, 0, s>>>(
        A, M, order, scaling, inv, E, scratch);
  }
  return (int)cudaGetLastError();
}

// A, G = Ebar [T][M][M] -> Abar [T][M][M].
// scratch [T][expm_backward_slots(order, scaling)][M][M].
extern "C" int qoc_expm_backward(const float* A, const float* G, int T, int M,
                                 int order, int scaling, float* Abar,
                                 float* scratch, void* stream) {
  if (!expm_shape_ok(T, M, order, scaling) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float inv = 1.f / (float)(1L << scaling);
  qoc::expm_backward_kernel<<<T, qoc::expm_threads(M), 0, s>>>(
      A, G, M, order, scaling, inv, Abar, scratch);
  return (int)cudaGetLastError();
}
