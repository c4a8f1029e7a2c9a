// Fused Adam segment kernel: n complete GRAPE iterations (sin-bounded
// weights, tree chain, coherent fidelity, exact backward, Adam with bias
// correction and exponential LR decay, convergence test and freeze) in
// ONE launch.
//
// Replaces qoc_tpu/ops/pallas_mega.py::_mega_kernel / _build_mega_call
// (kernel 3), fidelity-only branches.  Its penalty and trajectory
// branches come with the costs port.
//
// Design.  One block of kThreads threads runs the whole segment.  Per
// iteration: threads stride over the Tp lanes for the Taylor steps
// (tree_chain.cuh), the block runs the pairwise tree with a barrier per
// level, thread 0 forms the loss and the cotangent of the chain product
// (M, V <= 16: a few thousand flops), the block runs the tree in reverse,
// the lanes run the Taylor reverse and write the gradient, a shared-memory
// tree reduction gives grad^2, and every thread updates its share of the
// Adam state.  Once the convergence test holds, further iterations would
// recompute the same metrics at the frozen iterate, so the loop stops.
//
// Bound.  Latency: n * (log2(Tp) + ~6) block barriers and the serial
// per-lane Taylor recurrence on one SM.  The residuals
// ((max(order-1,1) + max(s,1) + L) * M^2 * Tp * 4 bytes, 3.4 MB for the
// CNOT) stay in L2.  Using more of the card (one problem per SM in a
// batch, or a cluster per problem) is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "tree_chain.cuh"

namespace qoc {

constexpr int kMaxV = 16;

struct AdamConsts {
  float b1, b2, one_minus_b1, one_minus_b2, eps, log_b1, log_b2;
  float rate_factor, conv_target, min_grad, max_iterations;
};

// mats [K][MM] (row 0 = drift), psi0 [M][V], target [M][V], maxamp [K-1],
// u0rows [M]; u, m, v [K-1][Tp] updated in place; sf_in [3] = (lr,
// iteration, done); met [8] = (loss, grad^2, unitary_scale, lr, iteration,
// done, reg_loss, 0).  Scratch: an, sq, tree as in tree_chain.cuh,
// bar [MM][Tp], g [K-1][Tp].
template <int M>
__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* mats, int K, int N, int T, int Tp, int V,
                    int order, int scaling, int n_iters, int unitary_mode,
                    const float* psi0, const float* target,
                    const float* maxamp, const float* u0rows, float* u,
                    float* m, float* v, const float* sf_in, float* met,
                    float* an, float* sq, float* tree, float* bar, float* g,
                    AdamConsts c) {
  constexpr int MM = M * M;
  extern __shared__ float smats[];
  __shared__ float sE[MM];
  __shared__ float red[kThreads];
  __shared__ float s_loss, s_g2, s_uscale, s_lr, s_itc, s_done, s_do;

  const int tid = threadIdx.x;
  const int Kc = K - 1;
  const int L = tree_levels(Tp);
  const long KT = (long)Kc * Tp;
  for (int i = tid; i < K * MM; i += blockDim.x) smats[i] = mats[i];
  if (tid == 0) {
    s_lr = sf_in[0];
    s_itc = sf_in[1];
    s_done = sf_in[2];
    s_loss = INFINITY;
    s_g2 = INFINITY;
    s_uscale = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // ---- forward: weights -> step propagators -> chain product ----
    for (int t = tid; t < Tp; t += blockDim.x) {
      const float live = t < T ? 1.0f : 0.0f;
      float A[MM];
#pragma unroll
      for (int e = 0; e < MM; ++e) A[e] = smats[e] * live;
      for (int k = 1; k < K; ++k) {
        const float wk = maxamp[k - 1] * (sinf(u[(k - 1) * (long)Tp + t]) * live);
#pragma unroll
        for (int e = 0; e < MM; ++e) A[e] += smats[k * MM + e] * wk;
      }
      taylor_step<M>(A, order, scaling, an, sq, tree, Tp, t);
    }
    __syncthreads();
    tree_forward<M>(tree, L, Tp, sE);

    // ---- loss and its cotangent at the chain product (thread 0) ----
    if (tid == 0) {
      float fin[M * kMaxV];
      for (int i = 0; i < M; ++i)
        for (int vv = 0; vv < V; ++vv) {
          float acc = 0.0f;
          for (int j = 0; j < M; ++j) acc += sE[i * M + j] * psi0[j * V + vv];
          fin[i * V + vv] = acc;
        }
      float s_at = 0.0f, s_bt = 0.0f, s_ba = 0.0f, s_ab = 0.0f;
      float s_aa = 0.0f, s_bb = 0.0f;
      for (int i = 0; i < N; ++i)
        for (int vv = 0; vv < V; ++vv) {
          const float fa = fin[i * V + vv], fb = fin[(N + i) * V + vv];
          const float ta = target[i * V + vv], tb = target[(N + i) * V + vv];
          s_at += fa * ta;
          s_bt += fb * tb;
          s_ba += fb * ta;
          s_ab += fa * tb;
          s_aa += fa * fa;
          s_bb += fb * fb;
        }
      const float re = s_at + s_bt;
      const float im = s_ba - s_ab;
      const float VV = (float)(V * V);
      s_loss = 1.0f - (re * re + im * im) / VV;
      if (unitary_mode) {
        // 0.5/N * sum(F^T F) = 0.5/N * sum_i (row_i(E @ U0) . 1)^2
        float acc = 0.0f;
        for (int i = 0; i < M; ++i) {
          float r = 0.0f;
          for (int j = 0; j < M; ++j) r += sE[i * M + j] * u0rows[j];
          acc += r * r;
        }
        s_uscale = (float)(0.5 / N) * acc;
      } else {
        const float nrm = s_aa + s_bb;
        s_uscale = nrm * nrm / VV;
      }
      // d loss / d final, then d loss / d E = fbar @ psi0^T at lane 0
      const float scale2 = (float)(-2.0 / (double)(V * V));
      float fbar[M * kMaxV];
      for (int i = 0; i < N; ++i)
        for (int vv = 0; vv < V; ++vv) {
          const float ta = target[i * V + vv], tb = target[(N + i) * V + vv];
          fbar[i * V + vv] = scale2 * (re * ta - im * tb);
          fbar[(N + i) * V + vv] = scale2 * (re * tb + im * ta);
        }
      for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) {
          float acc = 0.0f;
          for (int vv = 0; vv < V; ++vv)
            acc += fbar[i * V + vv] * psi0[j * V + vv];
          bar[(long)(i * M + j) * Tp] = acc;
        }
    }
    __syncthreads();

    // ---- backward: tree, Taylor steps, gradient in the pulse ----
    tree_backward<M>(tree, L, Tp, bar);
    float part = 0.0f;
    for (int t = tid; t < Tp; t += blockDim.x) {
      const float live = t < T ? 1.0f : 0.0f;
      float Ebar[MM], Abar[MM];
      mat_load<M>(bar, Tp, t, Ebar);
      taylor_step_backward<M>(Ebar, order, scaling, an, sq, Tp, t, Abar);
      for (int k = 1; k < K; ++k) {
        const long idx = (k - 1) * (long)Tp + t;
        const float wbar = frobenius_dot<M>(smats + k * MM, Abar);
        const float gk = (wbar * maxamp[k - 1]) * cosf(u[idx]) * live;
        g[idx] = gk;
        part += gk * gk;
      }
    }
    red[tid] = part;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }

    // ---- convergence test at the current iterate ----
    if (tid == 0) {
      s_g2 = 0.5f * red[0];
      const bool converged = s_loss < c.conv_target || s_g2 < c.min_grad ||
                             s_itc >= c.max_iterations;
      const bool done_new = s_done > 0.5f || converged;
      s_do = done_new ? 0.0f : 1.0f;
      s_done = done_new ? 1.0f : 0.0f;
    }
    __syncthreads();

    // ---- Adam (bias-corrected), applied only while not done ----
    const float dof = s_do;
    const float lr = s_lr;
    const float cnt = s_itc + 1.0f;
    const float bc1 = 1.0f - expf(cnt * c.log_b1);
    const float bc2 = 1.0f - expf(cnt * c.log_b2);
    for (long idx = tid; idx < KT; idx += blockDim.x) {
      const float gk = g[idx], am = m[idx], av = v[idx], uu = u[idx];
      const float am_n = c.b1 * am + c.one_minus_b1 * gk;
      const float av_n = c.b2 * av + c.one_minus_b2 * (gk * gk);
      const float upd = (am_n / bc1) / (sqrtf(av_n / bc2) + c.eps);
      const float u_n = uu - lr * upd;
      u[idx] = uu + dof * (u_n - uu);
      m[idx] = am + dof * (am_n - am);
      v[idx] = av + dof * (av_n - av);
    }
    __syncthreads();
    if (tid == 0) {
      s_lr = lr * (s_done > 0.5f ? 1.0f : c.rate_factor);
      s_itc = s_itc + dof;
    }
    __syncthreads();
    if (s_done > 0.5f) break;
  }

  if (tid == 0) {
    met[0] = s_loss;
    met[1] = s_g2;
    met[2] = s_uscale;
    met[3] = s_lr;
    met[4] = s_itc;
    met[5] = s_done;
    met[6] = s_loss;   // reg_loss: the fidelity-only objective has no penalty
    met[7] = 0.0f;
  }
}

}  // namespace qoc

// ---- host launchers (plain C interface) ----------------------------------

extern "C" int qoc_mega_segment(
    const float* mats, int K, int M, int N, int T, int Tp, int V, int order,
    int scaling, int n_iters, int unitary_mode, const float* psi0,
    const float* target, const float* maxamp, const float* u0rows, float* u,
    float* m, float* v, const float* sf_in, float* met, float* an, float* sq,
    float* tree, float* bar, float* g, float b1, float b2, float one_minus_b1,
    float one_minus_b2, float eps, float log_b1, float log_b2,
    float rate_factor, float conv_target, float min_grad,
    float max_iterations, void* stream) {
  if (V > qoc::kMaxV) return (int)cudaErrorInvalidValue;
  const qoc::AdamConsts c{b1, b2, one_minus_b1, one_minus_b2, eps, log_b1,
                          log_b2, rate_factor, conv_target, min_grad,
                          max_iterations};
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, qoc::mega_segment_kernel<kM>
                 <<<1, qoc::kThreads, smem, s>>>(
                     mats, K, N, T, Tp, V, order, scaling, n_iters,
                     unitary_mode, psi0, target, maxamp, u0rows, u, m, v,
                     sf_in, met, an, sq, tree, bar, g, c));
  return (int)cudaGetLastError();
}
