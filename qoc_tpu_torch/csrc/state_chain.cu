// Column-batched state chain kernels: the chain psi_{t+1} = step_t psi_t
// over a block of columns with per-column weights, storing the trajectory
// (forward), and its exact reverse sweep (backward).
//
// Replace qoc_tpu/ops/pallas_chain.py::_fwd_kernel / _fwd_call (kernel 4)
// and ::_bwd_kernel / _bwd_call (kernel 5).  The per-step math is in
// state_chain.cuh; this file holds the two launches and their C entry
// points, which qoc_tpu_torch/ops/_cuda.py loads with ctypes.
//
// Kernel 4 (forward): one thread per column (the per-thread form),
// kChainThreads columns per block, a grid over column blocks (the last
// block's idle threads return after the only barrier).  Where the TPU
// kernel keeps a 128-column block of the trajectory in VMEM, here the
// trajectory [T+1][M][C] lives in device memory, written coalesced.  Its
// bound is the serial chain of each thread.
//
// Kernel 5 (backward): a team of team_lanes(M) lanes per column (the team
// form), one warp per block holding 32 / L columns, a grid over column
// groups; the last block's idle teams read column 0, take part in every
// shuffle and write nothing.  Its bound is the serial chain over T, which
// the team shortens M-fold; the replayed powers of one step stay in
// shared memory ([2^s * order][32] floats beside the generators, sized by
// the launcher), so the sweep reads the trajectory and the weights and
// writes wbar [T][K][C] and nothing else.  One warp per block spreads a
// few hundred columns over as many SMs as there are warps, each alone on
// its SM: hence no branch and no run-time shuffle mask in the step
// (state_chain.cuh).

#include <cuda_runtime.h>

#include "state_chain.cuh"

namespace qoc {

constexpr int kChainThreads = 64;   // kernel 4: columns per block
constexpr int kTeamThreads = 32;    // kernel 5: one warp of 32 / L teams

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

// Shared memory of kernel 5: the generators (KG slots), the Taylor
// coefficients and the replayed powers of one step.
__host__ __device__ constexpr long chain_backward_smem_floats(int KG, int M,
                                                              int order,
                                                              int scaling) {
  return (long)team_smats_floats(KG, M) + order +
         ((long)order << scaling) * kTeamThreads;
}

// mats, w, traj of the forward and gbar [M][C] (cotangent of out) ->
// wbar [T][K][C], psibar [M][C].  KG = team_slots(K).
template <int M, int KG>
__global__ void __launch_bounds__(kTeamThreads)
state_chain_backward_kernel(const float* __restrict__ mats,
                            const float* __restrict__ w,
                            const float* __restrict__ traj,
                            const float* __restrict__ gbar, int K, int T,
                            int C, int order, int scaling,
                            float* __restrict__ wbar,
                            float* __restrict__ psibar) {
  constexpr int L = team_lanes(M);
  extern __shared__ float sm[];
  float* S = sm;
  float* coef = S + team_smats_floats(KG, M);
  float* pw = coef + order;
  team_smats<M, KG>(mats, K, S);
  for (int n = threadIdx.x; n < order; n += blockDim.x)
    coef[n] = n ? (float)(1.0 / (double)(1 << scaling) / (double)n) : 0.0f;
  __syncthreads();
  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int c = (blockIdx.x * blockDim.x + tid) / L;
  const bool act = c < C;
  const bool live = act && lane < M;
  const int row = lane < M ? lane : M - 1;
  const int cr = act ? c : 0;   // a column that exists, for idle teams
  const TeamGen<M, KG> gen(S, row);
  float wk[KG], wn[KG], wacc[KG];
  // step t's weights and state, loaded one step ahead of their use; the
  // slots past K read channel K - 1 and keep weight 0
  auto load = [&](int t, float (&wt)[KG]) {
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float x = w[((long)t * K + min(k, K - 1)) * C + cr];
      wt[k] = k < K ? x : 0.0f;
    }
  };
  load(T - 1, wn);
  float psin = traj[((long)(T - 1) * M + row) * C + cr];
  float pbar = live ? gbar[(long)row * C + c] : 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float psi = live ? psin : 0.0f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      wk[k] = wn[k];
      wacc[k] = 0.0f;
    }
    if (t > 0) {
      load(t - 1, wn);
      psin = traj[((long)(t - 1) * M + row) * C + cr];
    }
    pbar = team_step_backward<M, KG>(gen, wk, coef, order, scaling, psi,
                                     pbar, wacc, pw + tid, blockDim.x, live);
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float s = team_sum<L>(wacc[k]);
      if (act && k < K && lane == k % L) wbar[((long)t * K + k) * C + c] = s;
    }
  }
  if (live) psibar[(long)row * C + c] = pbar;
}

}  // namespace qoc

// ---- host launchers (plain C interface) ----------------------------------

template <class Kernel>
static cudaError_t chain_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int qoc_state_chain_forward(const float* mats, const float* w,
                                       const float* psi0, int K, int M, int T,
                                       int C, int order, int scaling,
                                       float* out, float* traj,
                                       void* stream) {
  if (K > qoc::kMaxK || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * M * M * sizeof(float);
  const int blocks = (C + qoc::kChainThreads - 1) / qoc::kChainThreads;
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::state_chain_forward_kernel<kM>
                 <<<blocks, qoc::kChainThreads, smem, s>>>(
                     mats, w, psi0, K, T, C, order, scaling, out, traj));
  return (int)cudaGetLastError();
}

extern "C" int qoc_state_chain_backward(const float* mats, const float* w,
                                        const float* traj, const float* gbar,
                                        int K, int M, int T, int C,
                                        int order, int scaling, float* wbar,
                                        float* psibar, void* stream) {
  if (K > qoc::kMaxK || C < 1 || T < 1 || order < 1 || scaling < 0 ||
      scaling > 20)
    return (int)cudaErrorInvalidValue;
  const long lanes = (long)C * qoc::team_lanes(M);
  const int blocks = (int)((lanes + qoc::kTeamThreads - 1) /
                           qoc::kTeamThreads);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, QOC_DISPATCH_SLOTS(K, {
    const size_t smem =
        qoc::chain_backward_smem_floats(kKG, M, order, scaling) *
        sizeof(float);
    auto kernel = qoc::state_chain_backward_kernel<kM, kKG>;
    const cudaError_t err = chain_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, qoc::kTeamThreads, smem, s>>>(
        mats, w, traj, gbar, K, T, C, order, scaling, wbar, psibar);
  }));
  return (int)cudaGetLastError();
}
