// Device functions of the column-batched state chain: one column's Taylor
// step and its exact reverse, shared by the state chain kernels
// (state_chain.cu, kernels 4 and 5) and the fused batched-optimizer kernel
// (mega_batch.cuh, kernel 6).
//
// Replace the per-step bodies of qoc_tpu/ops/pallas_chain.py::_fwd_kernel
// and ::_bwd_kernel, and the forward and backward chains of
// qoc_tpu/parallel/pallas_mega_batch.py::_kernel.
//
// Layout.  One thread owns one column c (a seed times a concerned
// vector) and keeps its state vector [M] in registers.  Every per-column
// array is [..][C] with c innermost (trajectory [T+1][M][C], weights
// [T][K][C], replayed powers [reps*order][M][C]), so a warp touching one
// element of 32 neighbouring columns reads 128 contiguous bytes.  The
// generators mats [K][M][M] sit in shared memory; every thread reads the
// same element at the same time (a broadcast).
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
// latency-bound chain per thread.  Using several threads per column is
// later work.

#pragma once

#include <cuda_runtime.h>

#include "tree_chain.cuh"   // QOC_DISPATCH_M

namespace qoc {

constexpr int kMaxK = 16;   // generators per step (drift + controls + extras)

// y = sum_k wk[k] * (S_k @ x), S = mats [K][M][M]
template <int M>
__device__ __forceinline__ void chain_apply(const float* S, int K,
                                            const float* wk, const float* x,
                                            float* y) {
#pragma unroll
  for (int i = 0; i < M; ++i) y[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* Sk = S + k * M * M;
    const float a = wk[k];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) s += Sk[i * M + j] * x[j];
      y[i] += a * s;
    }
  }
}

// One timestep, in place on psi: 2^scaling Taylor applications of the
// 2^-scaling-scaled generator, powers 0..order-1 each.
template <int M>
__device__ __forceinline__ void chain_step(const float* S, int K,
                                           const float* wk, int order,
                                           int scaling, float* psi) {
  const int reps = 1 << scaling;
  const double csc = 1.0 / (double)reps;
  float pn[M], y[M], tmp[M];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      pn[i] = psi[i];
      y[i] = psi[i];
    }
    for (int n = 1; n < order; ++n) {
      chain_apply<M>(S, K, wk, pn, tmp);
      const float f = (float)(csc / (double)n);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        pn[i] = tmp[i] * f;
        y[i] += pn[i];
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) psi[i] = y[i];
  }
}

// Reverse of chain_step for one column.  psi: the step's input state;
// pbar: on entry the cotangent of the step's output, on exit that of its
// input.  Weight cotangents of channels k0 <= k < k1 are written (zeroed
// first, then accumulated) at wb[(k - k0) * wstride].  ps is the column's
// replay scratch: element (r, n, i) of [reps*order][M] at
// ps[((r * order + n) * M + i) * pstride].
template <int M>
__device__ __forceinline__ void chain_step_backward(
    const float* S, int K, const float* wk, int order, int scaling,
    const float* psi, float* pbar, float* wb, int k0, int k1, long wstride,
    float* ps, long pstride) {
  constexpr int MM = M * M;
  const int reps = 1 << scaling;
  const double csc = 1.0 / (double)reps;
  // replay: the powers p_0..p_{order-1} of every application
  {
    float x[M], pn[M], y[M], tmp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = psi[i];
    for (int r = 0; r < reps; ++r) {
      float* pr = ps + (long)r * order * M * pstride;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        pn[i] = x[i];
        y[i] = x[i];
        pr[i * pstride] = x[i];
      }
      for (int n = 1; n < order; ++n) {
        chain_apply<M>(S, K, wk, pn, tmp);
        const float f = (float)(csc / (double)n);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          pn[i] = tmp[i] * f;
          y[i] += pn[i];
          pr[((long)n * M + i) * pstride] = pn[i];
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) x[i] = y[i];
    }
  }
  for (int k = k0; k < k1; ++k) wb[(k - k0) * wstride] = 0.0f;
  float pb_step[M];
#pragma unroll
  for (int i = 0; i < M; ++i) pb_step[i] = pbar[i];
  for (int r = reps - 1; r >= 0; --r) {
    const float* pr = ps + (long)r * order * M * pstride;
    float pb[M];
#pragma unroll
    for (int i = 0; i < M; ++i) pb[i] = pb_step[i];
    for (int n = order - 1; n >= 1; --n) {
      float pm1[M], atp[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        pm1[i] = pr[((long)(n - 1) * M + i) * pstride];
        atp[i] = 0.0f;
      }
      const float cn = (float)(csc / (double)n);
      for (int k = 0; k < K; ++k) {
        const float* Sk = S + k * MM;
        const float a = wk[k];
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float rj = 0.0f;
#pragma unroll
          for (int i = 0; i < M; ++i) rj += Sk[i * M + j] * pb[i];
          dot += pm1[j] * rj;
          atp[j] += a * rj;
        }
        if (k >= k0 && k < k1) wb[(k - k0) * wstride] += dot * cn;
      }
#pragma unroll
      for (int i = 0; i < M; ++i) pb[i] = pb_step[i] + atp[i] * cn;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) pb_step[i] = pb[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) pbar[i] = pb_step[i];
}

}  // namespace qoc
