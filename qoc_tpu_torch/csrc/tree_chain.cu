// Tree chain kernels: the full chain product of per-step Taylor
// propagators (forward) and its exact gradient in the weights (backward).
//
// Replace qoc_tpu/ops/pallas_tree.py::_fwd_kernel / _fwd_call (kernel 1)
// and ::_bwd_kernel / _bwd_call (kernel 2).  The math is in
// tree_chain.cuh; this file holds the two launches and their C entry
// points, which qoc_tpu_torch/ops/_cuda.py loads with ctypes.
//
// Both kernels run ONE block (one problem) of kThreads threads that stride
// over the Tp time lanes; see tree_chain.cuh for the layout and the bound.

#include <cuda_runtime.h>

#include "tree_chain.cuh"

namespace qoc {

// mats [K][MM], w [K][Tp] -> E [MM] = P_{Tp-1} ... P_0 and the residuals
// an [max(order-1,1)][MM][Tp], sq [max(scaling,1)][MM][Tp],
// tree [L][MM][Tp].
template <int M>
__global__ void __launch_bounds__(kThreads)
tree_forward_kernel(const float* __restrict__ mats,
                    const float* __restrict__ w, int K, int Tp, int order,
                    int scaling, float* __restrict__ E,
                    float* __restrict__ an, float* __restrict__ sq,
                    float* __restrict__ tree) {
  constexpr int MM = M * M;
  extern __shared__ float smats[];
  for (int i = threadIdx.x; i < K * MM; i += blockDim.x) smats[i] = mats[i];
  __syncthreads();
  for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
    float A[MM];
    const float w0 = w[t];
#pragma unroll
    for (int e = 0; e < MM; ++e) A[e] = smats[e] * w0;
    for (int k = 1; k < K; ++k) {
      const float wk = w[(long)k * Tp + t];
#pragma unroll
      for (int e = 0; e < MM; ++e) A[e] += smats[k * MM + e] * wk;
    }
    taylor_step<M>(A, order, scaling, an, sq, tree, Tp, t);
  }
  __syncthreads();
  tree_forward<M>(tree, tree_levels(Tp), Tp, E);
}

// Residuals of tree_forward_kernel and gbar [MM] (cotangent of E) ->
// wbar [K][Tp].  bar [MM][Tp] is scratch.
template <int M>
__global__ void __launch_bounds__(kThreads)
tree_backward_kernel(const float* __restrict__ mats, int K, int Tp,
                     int order, int scaling, const float* __restrict__ an,
                     const float* __restrict__ sq,
                     const float* __restrict__ tree,
                     const float* __restrict__ gbar, float* __restrict__ bar,
                     float* __restrict__ wbar) {
  constexpr int MM = M * M;
  extern __shared__ float smats[];
  for (int i = threadIdx.x; i < K * MM; i += blockDim.x) smats[i] = mats[i];
  for (int e = threadIdx.x; e < MM; e += blockDim.x) bar[(long)e * Tp] = gbar[e];
  __syncthreads();
  tree_backward<M>(tree, tree_levels(Tp), Tp, bar);
  for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
    float Ebar[MM], Abar[MM];
    mat_load<M>(bar, Tp, t, Ebar);
    taylor_step_backward<M>(Ebar, order, scaling, an, sq, Tp, t, Abar);
    for (int k = 0; k < K; ++k)
      wbar[(long)k * Tp + t] = frobenius_dot<M>(smats + k * MM, Abar);
  }
}

}  // namespace qoc

// ---- host launchers (plain C interface) ----------------------------------

extern "C" int qoc_tree_forward(const float* mats, const float* w, int K,
                                int M, int Tp, int order, int scaling,
                                float* E, float* an, float* sq, float* tree,
                                void* stream) {
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::tree_forward_kernel<kM>
                 <<<1, qoc::kThreads, smem, s>>>(
                     mats, w, K, Tp, order, scaling, E, an, sq, tree));
  return (int)cudaGetLastError();
}

extern "C" int qoc_tree_backward(const float* mats, int K, int M, int Tp,
                                 int order, int scaling, const float* an,
                                 const float* sq, const float* tree,
                                 const float* gbar, float* bar, float* wbar,
                                 void* stream) {
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::tree_backward_kernel<kM>
                 <<<1, qoc::kThreads, smem, s>>>(
                     mats, K, Tp, order, scaling, an, sq, tree, gbar, bar,
                     wbar));
  return (int)cudaGetLastError();
}

extern "C" const char* qoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
