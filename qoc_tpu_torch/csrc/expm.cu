// Batched Taylor exponential kernels: exp(A_t) for every timestep
// (kernel 7) and its exact VJP (kernel 8).
//
// Replace qoc_tpu/ops/pallas_expm.py::_fwd_kernel and ::_bwd_kernel behind
// its _call.  The math and the two paths are in expm.cuh; this file holds
// the launches and their C entry points, which qoc_tpu_torch/ops/_cuda.py
// loads with ctypes.  Shared path: one block per timestep (config 4's 1000
// steps take four waves of kernel 7, two blocks per SM, and eight of
// kernel 8, one block per SM).  Staged path: at most kExpmMaxGrid blocks
// walking the timesteps, in clusters that share a timestep while T is
// small, with a scratch of expm_scratch_floats(...) floats that the caller
// passes with its size.

#include <cuda_runtime.h>

#include "expm.cuh"

static inline bool expm_shape_ok(int T, int M, int order, int scaling) {
  return T >= 1 && M >= 8 && M % 8 == 0 && order >= 0 && scaling >= 0 &&
         scaling < 31;
}

template <class Kernel>
static cudaError_t expm_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The staged path's launch: one cluster of expm_cluster(T, M) blocks per
// timestep while T leaves resident blocks idle.
template <class... Params, class... Args>
static cudaError_t expm_staged_launch(void (*kernel)(Params...), int T, int M,
                                      cudaStream_t s, Args... args) {
  cudaError_t err = expm_smem(kernel, qoc::kStagedSmemBytes);
  if (err != cudaSuccess) return err;
  const int c = qoc::expm_cluster(T, M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(qoc::expm_grid(T, false) * c);
  cfg.blockDim = dim3(qoc::kExpmThreads);
  cfg.dynamicSmemBytes = qoc::kStagedSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Floats of scratch a launch needs (the wrapper's expm_scratch_bytes / 4).
extern "C" long qoc_expm_scratch_floats(int T, int M, int scaling,
                                        int backward) {
  return qoc::expm_scratch_floats(T, M, scaling, backward != 0);
}

// A [T][M][M] -> E [T][M][M].  scratch of scratch_bytes (0 and null on
// the shared path).
extern "C" int qoc_expm_forward(const float* A, int T, int M, int order,
                                int scaling, float* E, float* scratch,
                                long scratch_bytes, void* stream) {
  if (!expm_shape_ok(T, M, order, scaling)) return (int)cudaErrorInvalidValue;
  const long need = qoc::expm_scratch_floats(T, M, scaling, false);
  if (scratch_bytes < need * (long)sizeof(float) ||
      (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float inv = 1.f / (float)(1L << scaling);
  cudaError_t err;
  if (qoc::expm_forward_shared(M)) {
    const int smem = 2 * M * M * (int)sizeof(float);
    err = expm_smem(qoc::expm_forward_shared_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    qoc::expm_forward_shared_kernel<<<qoc::expm_grid(T, true),
                                      qoc::expm_shared_threads(M, 8), smem,
                                      s>>>(A, T, M, order, scaling, inv, E);
  } else {
    err = expm_staged_launch(qoc::expm_forward_staged_kernel, T, M, s, A, T,
                             M, order, scaling, inv, E, scratch);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// A, G = Ebar [T][M][M] -> Abar [T][M][M].  scratch as for the forward.
extern "C" int qoc_expm_backward(const float* A, const float* G, int T, int M,
                                 int order, int scaling, float* Abar,
                                 float* scratch, long scratch_bytes,
                                 void* stream) {
  if (!expm_shape_ok(T, M, order, scaling)) return (int)cudaErrorInvalidValue;
  const long need = qoc::expm_scratch_floats(T, M, scaling, true);
  if (scratch_bytes < need * (long)sizeof(float) ||
      (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float inv = 1.f / (float)(1L << scaling);
  cudaError_t err;
  if (qoc::expm_backward_shared(M, scaling)) {
    const int smem = 4 * M * M * (int)sizeof(float);
    err = expm_smem(qoc::expm_backward_shared_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    qoc::expm_backward_shared_kernel<<<qoc::expm_grid(T, true),
                                       qoc::expm_shared_threads(M, 4), smem,
                                       s>>>(A, G, T, M, order, Abar);
  } else {
    err = expm_staged_launch(qoc::expm_backward_staged_kernel, T, M, s, A, G,
                             T, M, order, scaling, inv, Abar, scratch);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
