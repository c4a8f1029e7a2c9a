// Column-batched state chain kernels: the chain psi_{t+1} = step_t psi_t
// over a block of columns with per-column weights, storing the trajectory
// (forward), and its exact reverse sweep (backward).
//
// Replace qoc_tpu/ops/pallas_chain.py::_fwd_kernel / _fwd_call (kernel 4)
// and ::_bwd_kernel / _bwd_call (kernel 5).  The per-step math is in
// state_chain.cuh; this file holds the two launches and their C entry
// points, which qoc_tpu_torch/ops/_cuda.py loads with ctypes.
//
// Work split.  One thread per column, kChainThreads columns per block, a
// grid over column blocks (any C: the last block's idle threads return
// after the only barrier).  Where the TPU kernel keeps a 128-column block
// of the trajectory in VMEM, here the trajectory [T+1][M][C] and the
// backward's replayed powers [reps*order][M][C] live in device memory,
// read and written coalesced; the weight cotangents accumulate in place
// in wbar [T][K][C].  The bound is the serial chain of each thread (see
// state_chain.cuh); small blocks spread a few hundred columns over more
// SMs.

#include <cuda_runtime.h>

#include "state_chain.cuh"

namespace qoc {

constexpr int kChainThreads = 64;

// mats [K][MM], w [T][K][C], psi0 [M][C] -> out [M][C], traj [T+1][M][C]
template <int M>
__global__ void __launch_bounds__(kChainThreads)
state_chain_forward_kernel(const float* mats, const float* w,
                           const float* psi0, int K, int T, int C, int order,
                           int scaling, float* out, float* traj) {
  extern __shared__ float smats[];
  for (int i = threadIdx.x; i < K * M * M; i += blockDim.x) smats[i] = mats[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float psi[M], wk[kMaxK];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    psi[i] = psi0[(long)i * C + c];
    traj[(long)i * C + c] = psi[i];
  }
  for (int t = 0; t < T; ++t) {
    for (int k = 0; k < K; ++k) wk[k] = w[((long)t * K + k) * C + c];
    chain_step<M>(smats, K, wk, order, scaling, psi);
    float* tr = traj + (long)(t + 1) * M * C + c;
#pragma unroll
    for (int i = 0; i < M; ++i) tr[(long)i * C] = psi[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) out[(long)i * C + c] = psi[i];
}

// mats, w, traj of the forward and gbar [M][C] (cotangent of out) ->
// wbar [T][K][C], psibar [M][C].  ps [reps*order][M][C] is scratch.
template <int M>
__global__ void __launch_bounds__(kChainThreads)
state_chain_backward_kernel(const float* mats, const float* w,
                            const float* traj, const float* gbar, int K,
                            int T, int C, int order, int scaling, float* ps,
                            float* wbar, float* psibar) {
  extern __shared__ float smats[];
  for (int i = threadIdx.x; i < K * M * M; i += blockDim.x) smats[i] = mats[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float pbar[M], psi[M], wk[kMaxK];
#pragma unroll
  for (int i = 0; i < M; ++i) pbar[i] = gbar[(long)i * C + c];
  for (int t = T - 1; t >= 0; --t) {
    for (int k = 0; k < K; ++k) wk[k] = w[((long)t * K + k) * C + c];
    const float* tr = traj + (long)t * M * C + c;
#pragma unroll
    for (int i = 0; i < M; ++i) psi[i] = tr[(long)i * C];
    chain_step_backward<M>(smats, K, wk, order, scaling, psi, pbar,
                           wbar + (long)t * K * C + c, 0, K, C, ps + c, C);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) psibar[(long)i * C + c] = pbar[i];
}

}  // namespace qoc

// ---- host launchers (plain C interface) ----------------------------------

static inline int chain_blocks(int C) {
  return (C + qoc::kChainThreads - 1) / qoc::kChainThreads;
}

extern "C" int qoc_state_chain_forward(const float* mats, const float* w,
                                       const float* psi0, int K, int M, int T,
                                       int C, int order, int scaling,
                                       float* out, float* traj,
                                       void* stream) {
  if (K > qoc::kMaxK || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::state_chain_forward_kernel<kM>
                 <<<chain_blocks(C), qoc::kChainThreads, smem, s>>>(
                     mats, w, psi0, K, T, C, order, scaling, out, traj));
  return (int)cudaGetLastError();
}

extern "C" int qoc_state_chain_backward(const float* mats, const float* w,
                                        const float* traj, const float* gbar,
                                        int K, int M, int T, int C,
                                        int order, int scaling, float* ps,
                                        float* wbar, float* psibar,
                                        void* stream) {
  if (K > qoc::kMaxK || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::state_chain_backward_kernel<kM>
                 <<<chain_blocks(C), qoc::kChainThreads, smem, s>>>(
                     mats, w, traj, gbar, K, T, C, order, scaling, ps, wbar,
                     psibar));
  return (int)cudaGetLastError();
}
