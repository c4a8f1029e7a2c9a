// Fused batched-optimizer kernel: n complete GRAPE iterations for every
// seed of a population in ONE launch (sin-bounded weights, the column
// chain storing the trajectory, the coherent per-seed fidelity, the
// penalties, the exact reverse sweep, the gradient, and Adam with a
// per-seed freeze, count and learning rate).
//
// Replaces qoc_tpu/parallel/pallas_mega_batch.py::_kernel / _build_call
// (kernel 6).  Two instances per M:
//   * mega_batch_kernel<M, false> (mega_batch.cu): the fidelity objective;
//   * mega_batch_kernel<M, true> (mega_batch_costs.cu): the same plus the
//     seven penalties: amplitude, envelope, dwdt, d2wdt2, bandpass (DFT
//     products over the penalized bins), forbidden levels and speed_up.
// The costs branches sit behind `if constexpr (kCosts)`.
//
// Layout (qoc_tpu's): u, m, v, and the scratch sn (sin u), wbar and gs
// (the gradient) are time-major [T][Kc][C]; column c = seed * V + v
// holds concerned vector v of a seed, and the V columns of a seed carry
// the same controls.  One thread per column; a block holds V * (32 / V)
// threads, so a seed's group never straddles blocks, and a partial last
// block's idle threads still reach every barrier.
//
// Per iteration and column: sn = sin(u) for all (t, k); the forward chain
// (state_chain.cuh) storing traj [T+1][M][C], the forbidden penalty and
// the per-column speed_up overlaps [T+1][2][C]; group sums over the V
// columns of a seed in a fixed order (shared memory for the fidelity and
// the forbidden penalty; the stored overlaps for speed_up, read after one
// barrier instead of a barrier per step); the reverse sweep with the
// forbidden and speed_up cotangents at every step; the pulse penalties
// and their gradient; g = (group_sum(wbar) * maxamp + gw) * cos(u); the
// seed's grad^2 = 0.5 * sum g^2 (the true seed norm: qoc_tpu's kernel
// divides it by V, pallas_mega_batch.py:528-529, which its other backends
// do not); the predicates loss < conv_target | grad^2 < min_grad | it >=
// max_iterations; Adam (pallas_mega_batch.py:547-560) masked by the
// freeze.  A block whose seeds are all frozen stops: further iterations
// would recompute the same metrics at the same iterate.
//
// Bound.  The serial chain per thread: of the order of 10^6-10^7 FMAs per
// column and iteration at T = 1000, with a few hundred threads on a few
// SMs.  Several threads per column, or clusters, are later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "state_chain.cuh"

namespace qoc {

constexpr int kBatchThreads = 32;   // threads per block before V-rounding
constexpr int kMaxVBatch = 8;       // concerned vectors per seed

struct BatchAdam {
  float b1, b2, one_minus_b1, one_minus_b2, eps, ln_b1, ln_b2, ln_f, rate;
  float conv_target, min_grad, max_iterations;
};

// Operands of the costs instance (field order mirrored by
// _cuda.BatchCostArgs).  Coefficients are coeff/steps; c_dwdt and c_d2
// carry the extra 1/dt^2 of the difference gradients.
struct BatchCostArgs {
  const float* env2;    // [T][Kc] squared envelope mask
  const float* forb;    // [nforb][1 + 2M]: alpha, rs[M], rns[M]
  const float* dftc;    // [T][F] cos of the penalized bins
  const float* dfts;    // [T][F] sin
  float* spec;          // [Kc][F][2][C] scratch: spectrum / |spectrum|
  float* ov;            // [T+1][2][C] scratch: per-column target overlaps
  int nforb, F;
  float a_amp, a_env, a_dwdt, c_dwdt, a_d2, c_d2, inv_dt, idt2, a_bp;
  float a_spd, spd_c0, forb_c0;
};

// Sum over the V columns of each thread's seed group, in column order;
// every thread of the block calls it.  red has blockDim.x entries.
__device__ __forceinline__ float group_sum(float x, float* red, int V) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  const int g0 = tid - tid % V;
  float s = 0.0f;
  for (int v = 0; v < V; ++v) s += red[g0 + v];
  __syncthreads();
  return s;
}

// Coherent overlap terms of one column with its target vector:
// re = sum_i (fa ta + fb tb), im = sum_i (fb ta - fa tb).
template <int M>
__device__ __forceinline__ void column_overlap(const float* psi,
                                               const float* tgt, int V,
                                               int vc, float* re, float* im) {
  constexpr int N = M / 2;
  float r = 0.0f, m = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ta = tgt[i * V + vc], tb = tgt[(N + i) * V + vc];
    r += psi[i] * ta + psi[N + i] * tb;
    m += psi[N + i] * ta - psi[i] * tb;
  }
  *re = r;
  *im = m;
}

// Forbidden-level penalty of one state: sum_f alpha 0.5 pop^2 with
// pop = (rs . psi)^2 + (rns . psi)^2.
template <int M>
__device__ __forceinline__ float forb_penalty(const BatchCostArgs& ca,
                                              const float* psi) {
  float pen = 0.0f;
  for (int f = 0; f < ca.nforb; ++f) {
    const float* row = ca.forb + f * (1 + 2 * M);
    float ps = 0.0f, pn = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ps += row[1 + j] * psi[j];
      pn += row[1 + M + j] * psi[j];
    }
    const float pop = ps * ps + pn * pn;
    pen += row[0] * 0.5f * pop * pop;
  }
  return pen;
}

// pbar += d(forbidden penalty)/d psi at one stored state.
template <int M>
__device__ __forceinline__ void forb_cotangent(const BatchCostArgs& ca,
                                               const float* psi,
                                               float* pbar) {
  for (int f = 0; f < ca.nforb; ++f) {
    const float* row = ca.forb + f * (1 + 2 * M);
    float ps = 0.0f, pn = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ps += row[1 + j] * psi[j];
      pn += row[1 + M + j] * psi[j];
    }
    const float pop = ps * ps + pn * pn;
    const float bs = (2.0f * row[0]) * pop * ps;
    const float bn = (2.0f * row[0]) * pop * pn;
#pragma unroll
    for (int j = 0; j < M; ++j) pbar[j] += row[1 + j] * bs + row[1 + M + j] * bn;
  }
}

// Group totals of the stored speed_up overlaps at step tau.
__device__ __forceinline__ void group_overlap(const float* ov, int tau,
                                              int C, int cg0, int V,
                                              float* re, float* im) {
  const float* row = ov + (long)tau * 2 * C + cg0;
  float r = 0.0f, m = 0.0f;
  for (int v = 0; v < V; ++v) {
    r += row[v];
    m += row[C + v];
  }
  *re = r;
  *im = m;
}

// mats [K][MM] (row 0 drift, 1..Kc controls, Kc+1.. extra channels with
// constant per-column weights ew [E][C]); maxamp [Kc]; psi0, tgt [M][V];
// u, m, v [T][Kc][C], itc, done [C] updated in place; stats [3][C] =
// (loss, grad^2, reg_loss).  Scratch: traj [T+1][M][C], sn, wbar, gs
// [T][Kc][C], ps [reps*order][M][C].
template <int M, bool kCosts>
__global__ void __launch_bounds__(kBatchThreads)
mega_batch_kernel(const float* mats, int K, int Kc, int V, int T, int C,
                  int order, int scaling, int n_iters, const float* maxamp,
                  const float* psi0, const float* tgt, const float* ew,
                  float* u, float* m, float* v, float* itc, float* done,
                  float* stats, float* traj, float* sn, float* wbar,
                  float* gs, float* ps, BatchAdam c, BatchCostArgs ca) {
  constexpr int N = M / 2;
  extern __shared__ float smats[];
  __shared__ float red[kBatchThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < K * M * M; i += blockDim.x) smats[i] = mats[i];
  __syncthreads();

  const int col = blockIdx.x * blockDim.x + tid;
  const bool act = col < C;
  const int vc = col % V;           // this column's concerned vector
  const int cg0 = col - vc;         // the seed's first column
  const int E = K - 1 - Kc;
  const long KC = (long)Kc * C;
  const float inv_v2 = (float)(1.0 / (double)(V * V));
  float a_spd = 0.0f;
  bool spd = false, forb = false;
  if constexpr (kCosts) {
    a_spd = ca.a_spd;
    spd = ca.a_spd != 0.0f;
    forb = ca.nforb > 0;
  }

  for (int iter = 0; iter < n_iters; ++iter) {
    // ---- weights and the forward chain ----
    float psi[M], wk[kMaxK];
    float re = 0.0f, im = 0.0f, pen = 0.0f;
    if (act) {
      for (long e = col; e < (long)T * KC; e += C) sn[e] = sinf(u[e]);
      wk[0] = 1.0f;
      for (int e = 0; e < E; ++e) wk[1 + Kc + e] = ew[(long)e * C + col];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        psi[i] = psi0[i * V + vc];
        traj[(long)i * C + col] = psi[i];
      }
      for (int t = 0; t < T; ++t) {
        for (int k = 0; k < Kc; ++k)
          wk[1 + k] = maxamp[k] * sn[t * KC + (long)k * C + col];
        chain_step<M>(smats, K, wk, order, scaling, psi);
        float* tr = traj + (long)(t + 1) * M * C + col;
#pragma unroll
        for (int i = 0; i < M; ++i) tr[(long)i * C] = psi[i];
        if constexpr (kCosts) {
          if (forb) pen += forb_penalty<M>(ca, psi);
          if (spd) {
            float r, q;
            column_overlap<M>(psi, tgt, V, vc, &r, &q);
            ca.ov[(long)(t + 1) * 2 * C + col] = r;
            ca.ov[(long)(t + 1) * 2 * C + C + col] = q;
          }
        }
      }
      column_overlap<M>(psi, tgt, V, vc, &re, &im);
    }

    // ---- coherent fidelity of each seed (group sums over V columns) ----
    const float re_g = group_sum(re, red, V);   // also orders ca.ov
    const float im_g = group_sum(im, red, V);
    const float loss = 1.0f - (re_g * re_g + im_g * im_g) * inv_v2;
    float pbar[M];
    float pen_spd = 0.0f, s_spd = 0.0f;
    if (act) {
      const float sc = (float)(-2.0 / (double)(V * V));
      const float gr = sc * re_g, gi = sc * im_g;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ta = tgt[i * V + vc], tb = tgt[(N + i) * V + vc];
        pbar[i] = gr * ta - gi * tb;
        pbar[N + i] = gr * tb + gi * ta;
      }
      if constexpr (kCosts) {
        if (forb) forb_cotangent<M>(ca, psi, pbar);   // tau = T
        if (spd) {
          // speed_up (regularization_functions.py:88-95): a_spd/2 (T+1 -
          // ip3)^2, ip3 = c0 + sum_tau |group overlap_tau|^2 / V^2
          float ip3 = 0.0f, gre = 0.0f, gim = 0.0f;
          for (int tau = 1; tau <= T; ++tau) {
            group_overlap(ca.ov, tau, C, cg0, V, &gre, &gim);
            ip3 += (gre * gre + gim * gim) * inv_v2;
          }
          ip3 = ca.spd_c0 + ip3;
          const float miss = (float)(T + 1) - ip3;
          pen_spd = a_spd * 0.5f * miss * miss;
          s_spd = (-2.0f * a_spd * inv_v2) * miss;
          // gre, gim hold tau = T
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float ta = tgt[i * V + vc], tb = tgt[(N + i) * V + vc];
            pbar[i] += s_spd * (gre * ta - gim * tb);
            pbar[N + i] += s_spd * (gre * tb + gim * ta);
          }
        }
      }

      // ---- reverse sweep: wbar of the control channels ----
      for (int t = T - 1; t >= 0; --t) {
        for (int k = 0; k < Kc; ++k)
          wk[1 + k] = maxamp[k] * sn[t * KC + (long)k * C + col];
        const float* tr = traj + (long)t * M * C + col;
#pragma unroll
        for (int i = 0; i < M; ++i) psi[i] = tr[(long)i * C];
        chain_step_backward<M>(smats, K, wk, order, scaling, psi, pbar,
                               wbar + t * KC + col, 1, 1 + Kc, C, ps + col,
                               C);
        if constexpr (kCosts) {
          if (t > 0) {   // tau = 0 only feeds the discarded psi0 cotangent
            if (forb) forb_cotangent<M>(ca, psi, pbar);
            if (spd) {
              float gre, gim;
              group_overlap(ca.ov, t, C, cg0, V, &gre, &gim);
#pragma unroll
              for (int i = 0; i < N; ++i) {
                const float ta = tgt[i * V + vc], tb = tgt[(N + i) * V + vc];
                pbar[i] += s_spd * (gre * ta - gim * tb);
                pbar[N + i] += s_spd * (gre * tb + gim * ta);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // every column's wbar is written

    // ---- pulse penalties, the gradient and grad^2 ----
    float pen_p = 0.0f, g2 = 0.0f;
    if (act) {
      if constexpr (kCosts) {
        if (ca.a_bp != 0.0f) {
          // spectrum of each control channel over the penalized bins:
          // re_f = sum_t sn C[t,f], im_f = -sum_t sn S[t,f]; keep
          // (re, im) / |.| (0 where |.| = 0)
          const int F = ca.F;
          for (int k = 0; k < Kc; ++k) {
            float mags = 0.0f;
            for (int f = 0; f < F; ++f) {
              float rr = 0.0f, ii = 0.0f;
              for (int t = 0; t < T; ++t) {
                const float s = sn[t * KC + (long)k * C + col];
                rr += s * ca.dftc[(long)t * F + f];
                ii += s * ca.dfts[(long)t * F + f];
              }
              ii = -ii;
              const float mag = sqrtf(rr * rr + ii * ii);
              mags += mag;
              const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, 1e-30f) : 0.0f;
              float* sp = ca.spec + ((long)(k * F + f) * 2) * C + col;
              sp[0] = rr * inv;
              sp[C] = ii * inv;
            }
            pen_p += ca.a_bp * mags;
          }
        }
      }
      for (int t = 0; t < T; ++t) {
        for (int k = 0; k < Kc; ++k) {
          const long idx = t * KC + (long)k * C + col;
          float ws = 0.0f;
          const float* wg = wbar + t * KC + (long)k * C + cg0;
          for (int vv = 0; vv < V; ++vv) ws += wg[vv];
          float g;
          if constexpr (kCosts) {
            const long kc = (long)k * C + col;
            auto at = [&](int tt) {   // sin(u) with zeros outside [0, T)
              return (tt >= 0 && tt < T) ? sn[tt * KC + kc] : 0.0f;
            };
            const float s = sn[idx];
            float gw = 0.0f;
            if (ca.a_amp != 0.0f) {
              pen_p += ca.a_amp * 0.5f * s * s;
              gw += ca.a_amp * s;
            }
            if (ca.a_env != 0.0f) {
              const float e2 = ca.env2[t * Kc + k];
              pen_p += ca.a_env * 0.5f * e2 * s * s;
              gw += ca.a_env * e2 * s;
            }
            if (ca.a_dwdt != 0.0f) {
              const float sm = at(t - 1), sp = at(t + 1);
              const float d = (s - sm) * ca.inv_dt;
              pen_p += ca.a_dwdt * 0.5f * d * d;
              if (t == T - 1) {   // d_T = -w_{T-1}/dt (the trailing pad)
                const float tail = s * ca.inv_dt;
                pen_p += ca.a_dwdt * 0.5f * tail * tail;
              }
              gw += ca.c_dwdt * (2.0f * s - sm - sp);
            }
            if (ca.a_d2 != 0.0f) {
              // s2(t') = (w_t' - 2 w_{t'-1} + w_{t'-2}) / dt^2 for t' in
              // [0, T+2), zeros outside [0, T)
              auto s2 = [&](int tp) {
                return (at(tp) - 2.0f * at(tp - 1) + at(tp - 2)) * ca.idt2;
              };
              const float s0 = s2(t), s1 = s2(t + 1), s22 = s2(t + 2);
              pen_p += ca.a_d2 * 0.5f * s0 * s0;
              if (t == T - 1)   // the boundary rows t' = T, T+1
                pen_p += ca.a_d2 * 0.5f * (s1 * s1 + s22 * s22);
              gw += ca.c_d2 * (s0 - 2.0f * s1 + s22);
            }
            if (ca.a_bp != 0.0f) {
              const int F = ca.F;
              const float* sp = ca.spec + ((long)k * F * 2) * C + col;
              float acc = 0.0f;
              for (int f = 0; f < F; ++f)
                acc += ca.dftc[(long)t * F + f] * sp[(long)(2 * f) * C]
                       - ca.dfts[(long)t * F + f] * sp[(long)(2 * f + 1) * C];
              gw += ca.a_bp * acc;
            }
            g = (ws * maxamp[k] + gw) * cosf(u[idx]);
          } else {
            g = ws * (maxamp[k] * cosf(u[idx]));
          }
          gs[idx] = g;
          g2 += g * g;
        }
      }
      g2 *= 0.5f;
    }

    // ---- metrics, convergence test and Adam (frozen seeds masked) ----
    float reg = loss;
    if constexpr (kCosts) {
      reg = loss + group_sum(pen, red, V) + ca.forb_c0 + pen_p + pen_spd;
    }
    bool frozen = true;
    if (act) {
      const float itv = itc[col];
      const bool conv = loss < c.conv_target || g2 < c.min_grad ||
                        itv >= c.max_iterations;
      const float dn = fmaxf(done[col], conv ? 1.0f : 0.0f);
      const float dof = 1.0f - dn;
      stats[col] = loss;
      stats[C + col] = g2;
      stats[2L * C + col] = reg;
      const float cnt = itv + 1.0f;
      const float lr = c.rate * expf(c.ln_f * itv);
      const float bc1 = 1.0f - expf(cnt * c.ln_b1);
      const float bc2 = 1.0f - expf(cnt * c.ln_b2);
      for (long e = col; e < (long)T * KC; e += C) {
        const float gk = gs[e], am = m[e], av = v[e];
        const float mm = c.b1 * am + c.one_minus_b1 * gk;
        const float vv = c.b2 * av + c.one_minus_b2 * (gk * gk);
        const float upd = (mm / bc1) / (sqrtf(vv / bc2) + c.eps);
        u[e] = u[e] - dof * (lr * upd);
        m[e] = am + dof * (mm - am);
        v[e] = av + dof * (vv - av);
      }
      itc[col] = itv + dof;
      done[col] = dn;
      frozen = dn > 0.5f;
    }
    if (__syncthreads_and(frozen)) break;
  }
}

// Host side: launch one segment on `stream`; returns cudaGetLastError().
template <bool kCosts>
int launch_mega_batch(const float* mats, int K, int M, int Kc, int V, int T,
                      int C, int order, int scaling, int n_iters,
                      const float* maxamp, const float* psi0,
                      const float* tgt, const float* ew, float* u, float* m,
                      float* v, float* itc, float* done, float* stats,
                      float* traj, float* sn, float* wbar, float* gs,
                      float* ps, const BatchAdam& c, const BatchCostArgs& ca,
                      void* stream) {
  if (V < 1 || V > kMaxVBatch || K > kMaxK || C < 1 || C % V != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = V * (kBatchThreads / V);
  const int blocks = (C + threads - 1) / threads;
  const size_t smem = (size_t)K * M * M * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, mega_batch_kernel<kM, kCosts>
                 <<<blocks, threads, smem, s>>>(
                     mats, K, Kc, V, T, C, order, scaling, n_iters, maxamp,
                     psi0, tgt, ew, u, m, v, itc, done, stats, traj, sn,
                     wbar, gs, ps, c, ca));
  return (int)cudaGetLastError();
}

}  // namespace qoc

// The C entry points' operands (shared by mega_batch.cu and
// mega_batch_costs.cu).
#define QOC_BATCH_PARAMS                                                     \
  const float *mats, int K, int M, int Kc, int V, int T, int C, int order,   \
      int scaling, int n_iters, const float *maxamp, const float *psi0,      \
      const float *tgt, const float *ew, float *u, float *m, float *v,       \
      float *itc, float *done, float *stats, float *traj, float *sn,         \
      float *wbar, float *gs, float *ps, const qoc::BatchAdam *adam
#define QOC_BATCH_ARGS                                                       \
  mats, K, M, Kc, V, T, C, order, scaling, n_iters, maxamp, psi0, tgt, ew,   \
      u, m, v, itc, done, stats, traj, sn, wbar, gs, ps, *adam
