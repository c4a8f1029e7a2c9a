// Device functions of the column-batched state chain: one column's Taylor
// step and its exact reverse, in the team form (team_apply, team_step,
// team_step_backward).  A team of L lanes owns one column, L =
// team_lanes(M) the least power of two >= M.  Lane i < M owns row i of the
// state, of its cotangent and of each Taylor power; the rest of a vector
// comes from the other lanes by __shfl_sync of width L.  Lanes >= M
// compute on row M - 1 and contribute nothing, but reach every shuffle.
// Kernels 4 and 5 (state_chain.cu) and kernel 6 (mega_batch.cuh) run it.
//
// Replace the per-step bodies of qoc_tpu/ops/pallas_chain.py::_fwd_kernel
// and ::_bwd_kernel, and the forward and backward chains of
// qoc_tpu/parallel/pallas_mega_batch.py::_kernel.
//
// Layout.  Every per-column array of the public interface is [..][C] with
// c innermost (trajectory [T+1][M][C], weights [T][K][C]).  The generators
// are copied with a row stride of M + 1 (team_smats), where the lanes of a
// team read distinct banks and the teams of a warp the same addresses, and
// each lane keeps its row and column of them in registers where they fit
// (TeamGen).
//
// Step (the matvec convention, pallas_chain.py:23-26): with A = sum_k
// w_k mats_k, each of the 2^s applications is
//     p_0 = x;  p_n = (A p_{n-1}) * (2^-s / n);  x' = sum_n p_n
// over powers n < order.  The reverse replays the powers of every
// application from the stored state, then runs back through them:
//     pbar_n = xbar' + (A^T pbar_{n+1}) * c_{n+1},
//     wbar_k += c_n * p_{n-1} . (mats_k^T pbar_n),
// with one pass over mats_k giving both mats_k^T pbar_n terms (no
// transposed copy of the generators is needed, unlike the TPU kernel's
// matsT operand).
//
// Bound.  K*M*M FMAs per Taylor power per column, serial over T: a
// latency-bound chain, far above the operation and byte bounds.  The team
// splits each power over M lanes (M-long FMA chains plus M shuffles) where
// one thread per column would walk M*M-long chains, and the reverse keeps
// the replayed powers of a step in shared memory, so the chain touches no
// device memory but the trajectory.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "team.cuh"   // kFullMask, team_lanes, team_sum, QOC_DISPATCH_M

namespace qoc {

constexpr int kMaxK = 16;   // generators per step (drift + controls + extras)

// ---- team form -------------------------------------------------------------
//
// With one warp per SM (a few hundred columns on 132 SMs) nothing hides a
// branch or a slow instruction, so the inner loops have neither: every
// block is whole warps, so every shuffle names the full mask as a
// constant (a mask known only at run time makes the compiler check
// convergence before each group of shuffles), and the generators sit in
// KG slots (KG = team_slots(K): 4, 8 or 16, the kernels instantiated for
// each) with the slots past K zero, so the channel loops unroll with no
// test of K.  A zero slot adds fma(0, s, y) = y: the values are those of
// K slots exactly.

// Generator slots of the team form: the least of 4, 8, 16 that holds K.
__host__ __device__ constexpr int team_slots(int K) {
  return K <= 4 ? 4 : K <= 8 ? 8 : 16;
}

// Floats of the team form's generator copy: [KG][M][M + 1].
__host__ __device__ constexpr int team_smats_floats(int KG, int M) {
  return KG * M * (M + 1);
}

// mats [K][M][M] -> S [KG][M][M + 1] in shared memory, slots K.. zero (the
// block's threads).
template <int M, int KG>
__device__ __forceinline__ void team_smats(const float* mats, int K,
                                           float* S) {
  for (int e = threadIdx.x; e < KG * M * (M + 1); e += blockDim.x) {
    const int k = e / (M * (M + 1)), r = e % (M * (M + 1));
    const int i = r / (M + 1), j = r % (M + 1);
    S[e] = (k < K && j < M) ? mats[(k * M + i) * M + j] : 0.0f;
  }
}

// A lane's view of the generators: S_k[row][j] (r) for the forward and
// S_k[i][row] (c) for the reverse.  TeamRegs copies both into registers
// once per launch, so a step reads no shared memory and no load latency
// sits between a power's FMA chains; TeamSmem reads them from S where the
// 2 * KG * M floats would not fit (TeamGen picks).
template <int M, int KG>
struct TeamRegs {
  float rw[KG][M], cl[KG][M];
  __device__ __forceinline__ TeamRegs(const float* S, int row) {
#pragma unroll
    for (int k = 0; k < KG; ++k) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        rw[k][j] = S[(k * M + row) * (M + 1) + j];
        cl[k][j] = S[(k * M + j) * (M + 1) + row];
      }
    }
  }
  __device__ __forceinline__ float r(int k, int j) const { return rw[k][j]; }
  __device__ __forceinline__ float c(int k, int i) const { return cl[k][i]; }
};

template <int M, int KG>
struct TeamSmem {
  const float* S;
  int row;
  __device__ __forceinline__ TeamSmem(const float* S_, int row_)
      : S(S_), row(row_) {}
  __device__ __forceinline__ float r(int k, int j) const {
    return S[(k * M + row) * (M + 1) + j];
  }
  __device__ __forceinline__ float c(int k, int i) const {
    return S[(k * M + i) * (M + 1) + row];
  }
};

// Registers where the two copies take at most 96 floats: with the rest of
// kernel 6's live values that stays under the 255 a thread may hold.
template <int M, int KG>
using TeamGen = std::conditional_t<(KG * M <= 48), TeamRegs<M, KG>,
                                   TeamSmem<M, KG>>;

// Row `row` of sum_k wk[k] * (S_k @ x), x held one row per lane: the
// products of a serial walk over the row, in its order (j inside, k
// outside).
template <int M, int KG, class Gen>
__device__ __forceinline__ float team_apply(const Gen& g,
                                            const float (&wk)[KG], float x) {
  constexpr int L = team_lanes(M);
  float xv[M];
#pragma unroll
  for (int j = 0; j < M; ++j) xv[j] = __shfl_sync(kFullMask, x, j, L);
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) s += g.r(k, j) * xv[j];
    y += wk[k] * s;
  }
  return y;
}

// One timestep of the lane's row: 2^scaling Taylor applications, powers
// 0..order-1 each; coef[n] = (float)(2^-scaling / n).
template <int M, int KG, class Gen>
__device__ __forceinline__ float team_step(const Gen& g,
                                           const float (&wk)[KG],
                                           const float* coef, int order,
                                           int scaling, float psi) {
  const int reps = 1 << scaling;
  for (int r = 0; r < reps; ++r) {
    float pn = psi, y = psi;
    for (int n = 1; n < order; ++n) {
      const float cf = coef[n];
      pn = team_apply<M, KG>(g, wk, pn) * cf;
      y += pn;
    }
    psi = y;
  }
  return psi;
}

// Reverse of team_step for the lane's row (g's).  psi: the step's input
// state;
// pbar: the cotangent of its output; returns that of its input.  Every
// slot's weight cotangent is ADDED to wacc, this lane's share (team_sum
// of wacc[k] gives the column's); live: the lane owns a row of a real
// column.  pw[q * pstride], q < 2^scaling * order: the lane's slots for
// the replayed powers (shared memory).
//
// The p-bar recurrence keeps the sums and their order of one thread
// walking the column (lane j forms r_j = sum_i S_k[i, j] pbar_i, i
// ascending, and adds w_k r_j over k ascending).  The weight cotangent is
// summed in another order: each lane accumulates c_n p_{n-1, j} r_j over
// the step's powers and applications, and the team's butterfly adds the
// lanes, where a serial walk sums over j first.  The difference is
// float32 rounding, within the kernels' tolerances to their plain
// versions (gradient rel 1e-4).
template <int M, int KG, class Gen>
__device__ __forceinline__ float team_step_backward(
    const Gen& g, const float (&wk)[KG], const float* coef, int order,
    int scaling, float psi, float pbar, float (&wacc)[KG], float* pw,
    int pstride, bool live) {
  constexpr int L = team_lanes(M);
  const int reps = 1 << scaling;
  // replay: the powers p_0..p_{order-1} of every application
  float x = psi;
  for (int r = 0; r < reps; ++r) {
    float* pr = pw + r * order * pstride;
    float pn = x, y = x;
    pr[0] = x;
    for (int n = 1; n < order; ++n) {
      const float cf = coef[n];
      pn = team_apply<M, KG>(g, wk, pn) * cf;
      y += pn;
      pr[n * pstride] = pn;
    }
    x = y;
  }
  float pb_step = pbar;
  for (int r = reps - 1; r >= 0; --r) {
    const float* pr = pw + r * order * pstride;
    float pb = pb_step;
    for (int n = order - 1; n >= 1; --n) {
      const float pc = live ? pr[(n - 1) * pstride] * coef[n] : 0.0f;
      const float cn = coef[n];
      float pv[M];
#pragma unroll
      for (int i = 0; i < M; ++i) pv[i] = __shfl_sync(kFullMask, pb, i, L);
      float atp = 0.0f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        float rj = 0.0f;
#pragma unroll
        for (int i = 0; i < M; ++i) rj += g.c(k, i) * pv[i];
        atp += wk[k] * rj;
        wacc[k] += pc * rj;
      }
      pb = pb_step + atp * cn;
    }
    pb_step = pb;
  }
  return pb_step;
}

}  // namespace qoc

// Host side: instantiate for the generator slots of K (1 <= K <= 16); any
// other K returns cudaErrorInvalidValue.
#define QOC_DISPATCH_SLOTS(K_, ...)                          \
  if ((K_) < 1 || (K_) > 16) return (int)cudaErrorInvalidValue; \
  if ((K_) <= 4) {                                           \
    constexpr int kKG = 4;                                   \
    __VA_ARGS__;                                             \
  } else if ((K_) <= 8) {                                    \
    constexpr int kKG = 8;                                   \
    __VA_ARGS__;                                             \
  } else {                                                   \
    constexpr int kKG = 16;                                  \
    __VA_ARGS__;                                             \
  }
