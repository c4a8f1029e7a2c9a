// Column-batched state chain kernels: the chain psi_{t+1} = step_t psi_t
// over a block of columns with per-column weights, storing the trajectory
// (forward), and its exact reverse sweep (backward).
//
// Replace qoc_tpu/ops/pallas_chain.py::_fwd_kernel / _fwd_call (kernel 4)
// and ::_bwd_kernel / _bwd_call (kernel 5).  The per-step math is in
// state_chain.cuh; this file holds the two launches and their C entry
// points, which qoc_tpu_torch/ops/_cuda.py loads with ctypes.
//
// Both kernels give each column a team of team_lanes(M) lanes (the team
// form of state_chain.cuh), one warp per block holding 32 / L columns, and
// a grid over column groups; the last block's idle teams read column 0,
// take part in every shuffle and write nothing.  One warp per block
// spreads a few hundred columns over as many SMs as there are warps, each
// alone on its SM: hence no branch and no run-time shuffle mask in the
// step (state_chain.cuh).  The bound of both is the serial chain over T,
// which the team shortens M-fold.
//
// Kernel 4 (forward): step t+1's weights are loaded during step t; the
// trajectory [T+1][M][C] goes to device memory (lane i writes row i), where
// the TPU kernel keeps a 128-column block of it in VMEM.  Its products are
// those of one thread walking the column, in that order (team_apply), so
// the trajectory is the one kernel 5's replay starts from.
//
// Kernel 5 (backward): the replayed powers of one step stay in shared
// memory ([2^s * order][32] floats beside the generators, sized by the
// launcher), so the sweep reads the trajectory and the weights and writes
// wbar [T][K][C] and nothing else.

#include <cuda_runtime.h>

#include "state_chain.cuh"

namespace qoc {

constexpr int kTeamThreads = 32;    // kernels 4-5: one warp of 32 / L teams

// Step t's weights of a lane's column into wt; the slots past K read
// channel K - 1 and keep weight 0.
template <int KG>
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             int t, int K, int C, int cr,
                                             float (&wt)[KG]) {
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const float x = w[((long)t * K + min(k, K - 1)) * C + cr];
    wt[k] = k < K ? x : 0.0f;
  }
}

// Shared memory of kernel 4: the generators (KG slots) and the Taylor
// coefficients.
__host__ __device__ constexpr long chain_forward_smem_floats(int KG, int M,
                                                             int order) {
  return (long)team_smats_floats(KG, M) + order;
}

// mats [K][MM], w [T][K][C], psi0 [M][C] -> out [M][C], traj [T+1][M][C].
// KG = team_slots(K).
template <int M, int KG>
__global__ void __launch_bounds__(kTeamThreads)
state_chain_forward_kernel(const float* __restrict__ mats,
                           const float* __restrict__ w,
                           const float* __restrict__ psi0, int K, int T,
                           int C, int order, int scaling,
                           float* __restrict__ out,
                           float* __restrict__ traj) {
  constexpr int L = team_lanes(M);
  extern __shared__ float sm[];
  float* S = sm;
  float* coef = S + team_smats_floats(KG, M);
  team_smats<M, KG>(mats, K, S);
  for (int n = threadIdx.x; n < order; n += blockDim.x)
    coef[n] = n ? (float)(1.0 / (double)(1 << scaling) / (double)n) : 0.0f;
  __syncthreads();
  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int c = (blockIdx.x * blockDim.x + tid) / L;
  const bool live = c < C && lane < M;
  const int row = lane < M ? lane : M - 1;
  const int cr = c < C ? c : 0;   // a column that exists, for idle teams
  const TeamGen<M, KG> gen(S, row);
  float wk[KG], wn[KG];
  if (T > 0) load_weights<KG>(w, 0, K, C, cr, wn);
  float psi = live ? psi0[(long)row * C + c] : 0.0f;
  if (live) traj[(long)row * C + c] = psi;
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int k = 0; k < KG; ++k) wk[k] = wn[k];
    if (t + 1 < T) load_weights<KG>(w, t + 1, K, C, cr, wn);
    psi = team_step<M, KG>(gen, wk, coef, order, scaling, psi);
    if (live) traj[((long)(t + 1) * M + row) * C + c] = psi;
  }
  if (live) out[(long)row * C + c] = psi;
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
  // step t's weights and state, loaded one step ahead of their use
  load_weights<KG>(w, T - 1, K, C, cr, wn);
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
      load_weights<KG>(w, t - 1, K, C, cr, wn);
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

static inline int team_blocks(int C, int M) {
  const long lanes = (long)C * qoc::team_lanes(M);
  return (int)((lanes + qoc::kTeamThreads - 1) / qoc::kTeamThreads);
}

extern "C" int qoc_state_chain_forward(const float* mats, const float* w,
                                       const float* psi0, int K, int M, int T,
                                       int C, int order, int scaling,
                                       float* out, float* traj,
                                       void* stream) {
  if (K > qoc::kMaxK || C < 1 || T < 0 || order < 1 || scaling < 0 ||
      scaling > 20)
    return (int)cudaErrorInvalidValue;
  const int blocks = team_blocks(C, M);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, QOC_DISPATCH_SLOTS(K, {
    const size_t smem =
        qoc::chain_forward_smem_floats(kKG, M, order) * sizeof(float);
    auto kernel = qoc::state_chain_forward_kernel<kM, kKG>;
    const cudaError_t err = chain_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, qoc::kTeamThreads, smem, s>>>(
        mats, w, psi0, K, T, C, order, scaling, out, traj);
  }));
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
  const int blocks = team_blocks(C, M);
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
