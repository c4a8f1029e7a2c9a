// Fused Adam segment kernel: n complete GRAPE iterations (sin-bounded
// weights, chain product, coherent fidelity, penalties, exact backward,
// Adam with bias correction and exponential LR decay, convergence test
// and freeze) in ONE launch.
//
// Replaces qoc_tpu/ops/pallas_mega.py::_mega_kernel / _build_mega_call
// (kernel 3), all branches.  Two instances per M:
//   * mega_segment_kernel<M, false> (mega.cu): the fidelity-only
//     objective on the pairwise product tree;
//   * mega_segment_kernel<M, true> (mega_costs.cu): the same plus the
//     pulse-shape penalties (amplitude, envelope, dwdt, d2wdt2), the
//     bandpass penalty as hand-written DFT products over the penalized
//     bins, and, when a cost reads the trajectory (forbidden levels,
//     speed_up), the inclusive prefix scan in place of the tree.
// The costs branches sit behind `if constexpr (kCosts)`, so the
// fidelity-only instance compiles to the code it had without them.
//
// Design.  One block of kThreads threads runs the whole segment.  Per
// iteration: threads stride over the Tp lanes for the Taylor steps
// (tree_chain.cuh), the block runs the tree (or the scan) with a barrier
// per level, thread 0 forms the loss and the cotangent of the chain
// product (M, V <= 16: a few thousand flops), the block runs the tree (or
// scan) in reverse, the lanes run the Taylor reverse and write the
// gradient, a shared-memory tree reduction gives grad^2, and every thread
// updates its share of the Adam state.  Once the convergence test holds,
// further iterations would recompute the same metrics at the frozen
// iterate, so the loop stops.
//
// Costs.  sw = sin(u) * live is staged in a [Kc][Tp] buffer; the
// difference penalties read neighbours with lanes outside [0, T) reading
// zero (the reference's two-zero padding), and d2wdt2's cotangent reads
// the second difference at t+1 and t+2 from a second staged buffer.  The
// bandpass spectrum runs threads over (k, f) with a loop over t, its
// cotangent threads over (k, t) with a loop over f, both reading the
// host-built cos/sin matrices (and their transposes, for coalesced reads)
// from L2.  In trajectory mode lane t holds X[t] = P_t ... P_0; a first
// lane pass forms traj = X psi0p and the forbidden populations and the
// speed_up overlaps, a block reduction gives the speed_up sum, and a
// second lane pass forms the trajectory cotangent (the fidelity's at lane
// T-1, the penalties' at every live lane) and Xbar = trajbar psi0p^T
// before the reverse scan.  Every sum is a fixed-order shared-memory
// reduction: no atomics, so the kernel is deterministic.
//
// Bound.  Latency: n * (log2(Tp) + ~6) block barriers (about twice that
// in trajectory mode) and the serial per-lane recurrences on one SM.  The
// residuals ((max(order-1,1) + max(s,1) + L [+1]) * M^2 * Tp * 4 bytes:
// 3.4 MB for the CNOT, 5.7 MB in trajectory mode at M = 10, Tp = 1024)
// stay in L2.  Using more of the card is later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tree_chain.cuh"

namespace qoc {

constexpr int kMaxV = 16;       // concerned vectors
constexpr int kMaxVTraj = 8;    // concerned vectors in trajectory mode

struct AdamConsts {
  float b1, b2, one_minus_b1, one_minus_b2, eps, log_b1, log_b2;
  float rate_factor, conv_target, min_grad, max_iterations;
};

// Operands of the costs instance (field order mirrored by _cuda.CostArgs).
// Coefficients are coeff/steps.
struct CostArgs {
  const float* env;     // [Kc][Tp] envelope mask, zero past T
  const float* forb;    // [nforb][1 + 2M]: alpha, rs[M], rns[M]
  const float* dftc;    // [Tp][F] cos of the penalized bins, zero past T
  const float* dfts;    // [Tp][F] sin
  const float* dftct;   // [F][Tp] transposes
  const float* dftst;
  float* sw;            // [Kc][Tp] scratch: sin(u) * live
  float* s2;            // [Kc][Tp] scratch: second difference
  float* spec;          // [Kc][F][2] scratch: spectrum / |spectrum|
  float* bar2;          // [MM][Tp] scratch: second cotangent buffer
  int nforb, F, traj;
  float a_amp, a_env, a_dwdt, a_d2, inv_dt, a_bp, a_spd, spd_c0, forb_c0;
};

// Deterministic block sum: every thread passes its part and gets the
// total.  red has blockDim.x entries (a power of two).
__device__ __forceinline__ float block_sum(float part, float* red) {
  const int tid = threadIdx.x;
  red[tid] = part;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();   // red is reused by the caller
  return total;
}

__device__ __forceinline__ float sw_at(const CostArgs& ca, int k, int t,
                                       int T, int Tp) {
  return (t >= 0 && t < T) ? ca.sw[(long)k * Tp + t] : 0.0f;
}

// Pulse-shape and bandpass penalties on ca.sw (written and synchronised by
// the caller).  Writes their gradient in sw to gw [Kc][Tp] and returns this
// thread's share of the penalty sum.  Synchronises inside; gw is read
// later only after further barriers.
__device__ __forceinline__ float pulse_costs(const CostArgs& ca, int Kc,
                                             int T, int Tp, float* gw) {
  const int tid = threadIdx.x;
  const long KT = (long)Kc * Tp;
  const float idt2 = ca.inv_dt * ca.inv_dt;
  if (ca.a_d2 != 0.0f) {
    for (long idx = tid; idx < KT; idx += blockDim.x) {
      const int k = (int)(idx / Tp), t = (int)(idx % Tp);
      ca.s2[idx] = (sw_at(ca, k, t, T, Tp) - 2.0f * sw_at(ca, k, t - 1, T, Tp)
                    + sw_at(ca, k, t - 2, T, Tp)) * idt2;
    }
    __syncthreads();
  }
  float part = 0.0f;
  for (long idx = tid; idx < KT; idx += blockDim.x) {
    const int k = (int)(idx / Tp), t = (int)(idx % Tp);
    const float live = t < T ? 1.0f : 0.0f;
    const float s = sw_at(ca, k, t, T, Tp);
    float g = 0.0f;
    if (ca.a_amp != 0.0f) {
      part += ca.a_amp * 0.5f * (s * s);
      g += ca.a_amp * s;
    }
    if (ca.a_env != 0.0f) {
      const float e = ca.env[idx];
      const float ew = e * s;
      part += ca.a_env * 0.5f * (ew * ew);
      g += ca.a_env * e * e * s;
    }
    if (ca.a_dwdt != 0.0f) {
      const float sm = sw_at(ca, k, t - 1, T, Tp);
      const float sp = sw_at(ca, k, t + 1, T, Tp);
      const float d = (s - sm) * ca.inv_dt;
      part += ca.a_dwdt * 0.5f * (d * d);
      g += (ca.a_dwdt * idt2) * (2.0f * s - sm - sp) * live;
    }
    if (ca.a_d2 != 0.0f) {
      const float c = ca.s2[idx];
      const float n1 = t + 1 < Tp ? ca.s2[idx + 1] : 0.0f;
      const float n2 = t + 2 < Tp ? ca.s2[idx + 2] : 0.0f;
      part += ca.a_d2 * 0.5f * (c * c);
      g += (ca.a_d2 * idt2) * (c - 2.0f * n1 + n2) * live;
    }
    gw[idx] = g;
  }
  if (ca.a_bp != 0.0f) {
    // re_f[k,f] = sum_t sw C[t,f], im_f = -sum_t sw S[t,f]; keep
    // (re, im) / |.| (0 where |.| = 0: the subgradient mask)
    const int F = ca.F;
    for (int i = tid; i < Kc * F; i += blockDim.x) {
      const int k = i / F, f = i % F;
      float re = 0.0f, im = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float s = ca.sw[(long)k * Tp + t];
        re += s * ca.dftc[(long)t * F + f];
        im -= s * ca.dfts[(long)t * F + f];
      }
      const float mag = sqrtf(re * re + im * im);
      part += ca.a_bp * mag;
      const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, 1e-30f) : 0.0f;
      ca.spec[2 * i] = re * inv;
      ca.spec[2 * i + 1] = im * inv;
    }
    __syncthreads();
    // gw[k,t] += a_bp * sum_f (re_f inv C[t,f] - im_f inv S[t,f])
    for (long idx = tid; idx < KT; idx += blockDim.x) {
      const int k = (int)(idx / Tp), t = (int)(idx % Tp);
      const float* sp = ca.spec + 2L * k * F;
      float acc = 0.0f;
      for (int f = 0; f < F; ++f)
        acc += sp[2 * f] * ca.dftct[(long)f * Tp + t]
               - sp[2 * f + 1] * ca.dftst[(long)f * Tp + t];
      gw[idx] += ca.a_bp * acc;
    }
  }
  return part;
}

// traj[i*V + v] = sum_j X[i,j,t] psi0[j,v] at lane t of the prefix products.
template <int M>
__device__ __forceinline__ void lane_traj(const float* X, int Tp, int t,
                                          const float* psi0, int V,
                                          float* tr) {
  for (int e = 0; e < M * V; ++e) tr[e] = 0.0f;
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < M; ++j) {
      const float x = X[(long)(i * M + j) * Tp + t];
      for (int v = 0; v < V; ++v) tr[i * V + v] += x * psi0[j * V + v];
    }
}

// Coherent overlap of one lane's trajectory with the target:
// re = sum (traj . target), im = sum (traj . [-tb; ta]).
template <int M>
__device__ __forceinline__ void lane_overlap(const float* tr,
                                             const float* target, int N,
                                             int V, float* re, float* im) {
  float r = 0.0f, m = 0.0f;
  for (int i = 0; i < M; ++i)
    for (int v = 0; v < V; ++v) {
      const float tgt_im = i < N ? -target[(N + i) * V + v]
                                 : target[(i - N) * V + v];
      r += tr[i * V + v] * target[i * V + v];
      m += tr[i * V + v] * tgt_im;
    }
  *re = r;
  *im = m;
}

// mats [K][MM] (row 0 = drift), psi0 [M][V], target [M][V], maxamp [K-1],
// u0rows [M]; u, m, v [K-1][Tp] updated in place; sf_in [3] = (lr,
// iteration, done); met [8] = (loss, grad^2, unitary_scale, lr, iteration,
// done, reg_loss, 0).  Scratch: an, sq, tree as in tree_chain.cuh (the
// trajectory mode uses L+1 tree levels), bar [MM][Tp], g [K-1][Tp].
template <int M, bool kCosts>
__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* mats, int K, int N, int T, int Tp, int V,
                    int order, int scaling, int n_iters, int unitary_mode,
                    const float* psi0, const float* target,
                    const float* maxamp, const float* u0rows, float* u,
                    float* m, float* v, const float* sf_in, float* met,
                    float* an, float* sq, float* tree, float* bar, float* g,
                    AdamConsts c, CostArgs ca) {
  constexpr int MM = M * M;
  extern __shared__ float smats[];
  __shared__ float sE[MM];
  __shared__ float red[kThreads];
  __shared__ float s_loss, s_g2, s_uscale, s_lr, s_itc, s_done, s_do;
  __shared__ float s_fbar[kCosts ? M * kMaxVTraj : 1];
  __shared__ float s_regloss;

  const int tid = threadIdx.x;
  const int Kc = K - 1;
  const int L = tree_levels(Tp);
  const long KT = (long)Kc * Tp;
  bool traj = false;
  if constexpr (kCosts) traj = ca.traj != 0;
  for (int i = tid; i < K * MM; i += blockDim.x) smats[i] = mats[i];
  if (tid == 0) {
    s_lr = sf_in[0];
    s_itc = sf_in[1];
    s_done = sf_in[2];
    s_loss = INFINITY;
    s_g2 = INFINITY;
    s_uscale = 0.0f;
    s_regloss = INFINITY;
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
        const float swk = sinf(u[(k - 1) * (long)Tp + t]) * live;
        if constexpr (kCosts) ca.sw[(k - 1) * (long)Tp + t] = swk;
        const float wk = maxamp[k - 1] * swk;
#pragma unroll
        for (int e = 0; e < MM; ++e) A[e] += smats[k * MM + e] * wk;
      }
      taylor_step<M>(A, order, scaling, an, sq, tree, Tp, t);
    }
    __syncthreads();

    // ---- pulse-shape and bandpass penalties (gradient into g) ----
    float reg_part = 0.0f;
    if constexpr (kCosts) reg_part = pulse_costs(ca, Kc, T, Tp, g);

    if (!traj) {
      tree_forward<M>(tree, L, Tp, sE);
    } else {
      // prefix products; the full chain is lane T-1 of the last level
      scan_forward<M>(tree, L, Tp);
      const float* XL = tree + (long)L * MM * Tp;
      for (int e = tid; e < MM; e += blockDim.x)
        sE[e] = XL[(long)e * Tp + T - 1];
      __syncthreads();
    }

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
      // (tree); in trajectory mode fbar seeds lane T-1 (below)
      const float scale2 = (float)(-2.0 / (double)(V * V));
      float fbar[M * kMaxV];
      for (int i = 0; i < N; ++i)
        for (int vv = 0; vv < V; ++vv) {
          const float ta = target[i * V + vv], tb = target[(N + i) * V + vv];
          fbar[i * V + vv] = scale2 * (re * ta - im * tb);
          fbar[(N + i) * V + vv] = scale2 * (re * tb + im * ta);
        }
      if (!traj) {
        for (int i = 0; i < M; ++i)
          for (int j = 0; j < M; ++j) {
            float acc = 0.0f;
            for (int vv = 0; vv < V; ++vv)
              acc += fbar[i * V + vv] * psi0[j * V + vv];
            bar[(long)(i * M + j) * Tp] = acc;
          }
      } else {
        for (int e = 0; e < M * V; ++e) s_fbar[e] = fbar[e];
      }
    }
    __syncthreads();

    // ---- trajectory penalties and the trajectory cotangent ----
    if constexpr (kCosts) {
      float reg = 0.0f;
      if (traj) {
        const float* XL = tree + (long)L * MM * Tp;
        const float VV = (float)(V * V);
        const float T1f = (float)(T + 1);
        float spd_part = 0.0f;
        // pass 1: forbidden populations and speed_up overlaps per lane
        for (int t = tid; t < T; t += blockDim.x) {
          float tr[M * kMaxVTraj];
          lane_traj<M>(XL, Tp, t, psi0, V, tr);
          for (int f = 0; f < ca.nforb; ++f) {
            const float* row = ca.forb + f * (1 + 2 * M);
            for (int vv = 0; vv < V; ++vv) {
              float ps = 0.0f, pn = 0.0f;
              for (int j = 0; j < M; ++j) {
                ps += row[1 + j] * tr[j * V + vv];
                pn += row[1 + M + j] * tr[j * V + vv];
              }
              const float pop = ps * ps + pn * pn;
              reg_part += row[0] * 0.5f * (pop * pop);
            }
          }
          if (ca.a_spd != 0.0f) {
            float re, im;
            lane_overlap<M>(tr, target, N, V, &re, &im);
            spd_part += re * re + im * im;
          }
        }
        reg = block_sum(reg_part, red) + ca.forb_c0;
        float S_spd = 0.0f;
        if (ca.a_spd != 0.0f) {
          const float ip3 = ca.spd_c0 + block_sum(spd_part, red) / VV;
          reg += ca.a_spd * 0.5f * (T1f - ip3) * (T1f - ip3);
          S_spd = -ca.a_spd * (T1f - ip3) * (2.0f / VV);
        }
        // pass 2: trajbar (dense over live lanes, + fbar at lane T-1),
        // then Xbar[t] = sum_v trajbar[:, v] psi0[:, v]^T
        for (int t = tid; t < Tp; t += blockDim.x) {
          float tb[M * kMaxVTraj];
          for (int e = 0; e < M * V; ++e) tb[e] = 0.0f;
          if (t < T) {
            float tr[M * kMaxVTraj];
            lane_traj<M>(XL, Tp, t, psi0, V, tr);
            for (int f = 0; f < ca.nforb; ++f) {
              const float* row = ca.forb + f * (1 + 2 * M);
              for (int vv = 0; vv < V; ++vv) {
                float ps = 0.0f, pn = 0.0f;
                for (int j = 0; j < M; ++j) {
                  ps += row[1 + j] * tr[j * V + vv];
                  pn += row[1 + M + j] * tr[j * V + vv];
                }
                const float pop = ps * ps + pn * pn;
                const float bs = (2.0f * row[0]) * pop * ps;
                const float bn = (2.0f * row[0]) * pop * pn;
                for (int j = 0; j < M; ++j)
                  tb[j * V + vv] += row[1 + j] * bs + row[1 + M + j] * bn;
              }
            }
            if (ca.a_spd != 0.0f) {
              float re, im;
              lane_overlap<M>(tr, target, N, V, &re, &im);
              for (int i = 0; i < M; ++i)
                for (int vv = 0; vv < V; ++vv) {
                  const float tgt_im = i < N ? -target[(N + i) * V + vv]
                                             : target[(i - N) * V + vv];
                  tb[i * V + vv] +=
                      S_spd * (re * target[i * V + vv] + im * tgt_im);
                }
            }
            if (t == T - 1)
              for (int e = 0; e < M * V; ++e) tb[e] += s_fbar[e];
          }
          for (int i = 0; i < M; ++i)
            for (int j = 0; j < M; ++j) {
              float acc = 0.0f;
              for (int vv = 0; vv < V; ++vv)
                acc += tb[i * V + vv] * psi0[j * V + vv];
              bar[(long)(i * M + j) * Tp + t] = acc;
            }
        }
        __syncthreads();
      } else {
        reg = block_sum(reg_part, red);
      }
      if (tid == 0) s_regloss = s_loss + reg;
    }

    // ---- backward: tree or scan, Taylor steps, gradient in the pulse ----
    const float* sbar = bar;
    if (!traj) {
      tree_backward<M>(tree, L, Tp, bar);
    } else {
      sbar = scan_backward<M>(tree, L, Tp, bar, ca.bar2);
    }
    float part = 0.0f;
    for (int t = tid; t < Tp; t += blockDim.x) {
      const float live = t < T ? 1.0f : 0.0f;
      float Ebar[MM], Abar[MM];
      mat_load<M>(sbar, Tp, t, Ebar);
      taylor_step_backward<M>(Ebar, order, scaling, an, sq, Tp, t, Abar);
      for (int k = 1; k < K; ++k) {
        const long idx = (k - 1) * (long)Tp + t;
        const float wbar = frobenius_dot<M>(smats + k * MM, Abar);
        float gk;
        if constexpr (kCosts) {
          gk = (wbar * maxamp[k - 1] + g[idx]) * cosf(u[idx]) * live;
        } else {
          gk = (wbar * maxamp[k - 1]) * cosf(u[idx]) * live;
        }
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
    // reg_loss: the fidelity-only objective has no penalty
    met[6] = kCosts ? s_regloss : s_loss;
    met[7] = 0.0f;
  }
}

// Host side: launch one segment on `stream`; returns cudaGetLastError().
template <bool kCosts>
int launch_mega_segment(
    const float* mats, int K, int M, int N, int T, int Tp, int V, int order,
    int scaling, int n_iters, int unitary_mode, const float* psi0,
    const float* target, const float* maxamp, const float* u0rows, float* u,
    float* m, float* v, const float* sf_in, float* met, float* an, float* sq,
    float* tree, float* bar, float* g, const AdamConsts& c,
    const CostArgs& ca, void* stream) {
  if (V > (kCosts && ca.traj ? kMaxVTraj : kMaxV))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, mega_segment_kernel<kM, kCosts>
                 <<<1, kThreads, smem, s>>>(
                     mats, K, N, T, Tp, V, order, scaling, n_iters,
                     unitary_mode, psi0, target, maxamp, u0rows, u, m, v,
                     sf_in, met, an, sq, tree, bar, g, c, ca));
  return (int)cudaGetLastError();
}

}  // namespace qoc

// The C entry points' operands (shared by mega.cu and mega_costs.cu).
#define QOC_MEGA_PARAMS                                                      \
  const float *mats, int K, int M, int N, int T, int Tp, int V, int order,   \
      int scaling, int n_iters, int unitary_mode, const float *psi0,         \
      const float *target, const float *maxamp, const float *u0rows,         \
      float *u, float *m, float *v, const float *sf_in, float *met,          \
      float *an, float *sq, float *tree, float *bar, float *g, float b1,     \
      float b2, float one_minus_b1, float one_minus_b2, float eps,           \
      float log_b1, float log_b2, float rate_factor, float conv_target,      \
      float min_grad, float max_iterations
#define QOC_MEGA_ARGS(c_, ca_, stream_)                                      \
  mats, K, M, N, T, Tp, V, order, scaling, n_iters, unitary_mode, psi0,      \
      target, maxamp, u0rows, u, m, v, sf_in, met, an, sq, tree, bar, g,     \
      c_, ca_, stream_
#define QOC_ADAM_CONSTS                                                      \
  qoc::AdamConsts {                                                          \
    b1, b2, one_minus_b1, one_minus_b2, eps, log_b1, log_b2, rate_factor,    \
        conv_target, min_grad, max_iterations                                \
  }
