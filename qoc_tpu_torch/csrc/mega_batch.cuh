// Fused batched-optimizer kernel: n complete GRAPE iterations for every
// seed of a population in ONE launch (sin-bounded weights, the column
// chain storing the trajectory, the coherent per-seed fidelity, the
// penalties, the exact reverse sweep, the gradient, and Adam with a
// per-seed freeze, count and learning rate).
//
// Replaces qoc_tpu/parallel/pallas_mega_batch.py::_kernel / _build_call
// (kernel 6).  Two instances per M and generator slots KG
// (team_slots(K), state_chain.cuh):
//   * mega_batch_kernel<M, KG, false> (mega_batch.cu): the fidelity
//     objective;
//   * mega_batch_kernel<M, KG, true> (mega_batch_costs.cu): the same plus
//     the seven penalties: amplitude, envelope, dwdt, d2wdt2, bandpass (DFT
//     products over the penalized bins), forbidden levels and speed_up.
// The costs branches sit behind `if constexpr (kCosts)`.
//
// Layout (qoc_tpu's at the interface): u, m, v are time-major [T][Kc][C];
// column c = seed * V + v holds concerned vector v of a seed, and the V
// columns of a seed carry the same controls.  Internal scratch: the
// trajectory traj [T+1][C][M] (a warp's rows of one step are contiguous),
// the weight cotangents wbar [C][T][Kc], and per seed sn = sin(u) and the
// gradient gs [S][T][Kc].
//
// Work split.  A team of L = team_lanes(M) lanes owns one column and runs
// the chain in the team form of state_chain.cuh (lane i holds row i).  A
// seed group is the V teams of one seed, G = V * L lanes; it never
// straddles a block.  Where G <= 32 a block is one warp of 32 / G groups,
// and sums over a seed's columns are shuffles; where G > 32 a block is one
// group (up to 128 lanes), and those sums go through shared memory.
// Blocks are whole warps: the lanes past the groups idle on seed 0's
// data, take part in every shuffle and barrier, and store nothing.
// Per iteration: sn = sin(u), once per seed, over the group's lanes; the
// forward chain storing traj, the forbidden penalty and the per-column
// speed_up overlaps [T+1][2][C] (team sums per step); the group sums of
// the fidelity in column order; the reverse sweep with the forbidden and
// speed_up cotangents at every step, the replayed powers of a step in
// shared memory; then, once per seed and split over its lanes by (t, k):
// the pulse penalties, the bandpass spectrum (split by bin) and its
// gradient, g = (sum_v wbar * maxamp + gw) * cos(u), the seed's grad^2 =
// 0.5 * sum g^2 (the true seed norm: qoc_tpu's kernel divides it by V,
// pallas_mega_batch.py:528-529, which its other backends do not); the
// predicates loss < conv_target | grad^2 < min_grad | it >= max_iterations;
// Adam (pallas_mega_batch.py:547-560) masked by the freeze, written to all
// V column copies of u, m and v.  A block whose seeds are all frozen
// stops: further iterations would recompute the same metrics at the same
// iterate.  Sums over lanes (team butterflies, then the V columns in
// order) are taken in another order than a serial walk: float32 rounding,
// within kernel 6's tolerances to its plain version.
//
// Bound.  The serial chain over T of each column, twice per iteration
// (forward, then replay and reverse): a latency bound, far above the
// operation and byte bounds.  A thread per column would walk M*M-long FMA
// chains per Taylor power, one warp on each of a few SMs; a team walks
// M-long chains plus M shuffles, and puts 8-64x as many warps on the card
// (the CNOT's 64 seeds: 64 warps), still about one per SM, so the step has
// no branch and no run-time shuffle mask (state_chain.cuh).  Step t+1's
// weights and states are loaded during step t, and the per-seed passes
// keep several elements' loads in flight.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "state_chain.cuh"

namespace qoc {

constexpr int kMaxVBatch = 8;       // concerned vectors per seed
constexpr int kMaxBatchThreads = kMaxVBatch * 16;   // V = 8 teams of 16
// Phases of the optional clock64 counters (mirrored by _cuda.CLOCK_PHASES):
// the sin pass, the forward chain (penalties and overlaps included), the
// group sums and fidelity, the reverse sweep, the bandpass spectrum, the
// gradient with the per-step pulse penalties and grad^2, and the metrics
// with Adam.
constexpr int kClockPhases = 7;

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
  float* spec;          // [S][Kc][F][2] scratch: spectrum / |spectrum|
  float* ov;            // [T+1][2][C] scratch: per-column target overlaps
  int nforb, F;
  float a_amp, a_env, a_dwdt, c_dwdt, a_d2, c_d2, inv_dt, idt2, a_bp;
  float a_spd, spd_c0, forb_c0;
};

// Where a thread sits: its seed group, its team (column) and its row.
struct BatchLane {
  int G;          // lanes of a seed group, V * L
  int gl;         // lane within the group
  int vc;         // the team's concerned vector
  int lane;       // lane within the team
  int seed, cg0, col;   // the seed, its first column, the team's column
  int row;        // the row this lane computes (M - 1 for lanes >= M)
  int gbase;      // the group's first lane in the warp (G <= 32)
  bool act;       // a lane of a real seed (the last block may hold fewer,
                  // and lanes past the block's whole groups hold none)
  bool live;      // act and a lane < M
  bool one_warp;  // G <= 32: the block is one warp of whole groups
};

// Sum over the V columns of the lane's seed, in column order, of a value
// every lane of a team holds.  Every thread of the block calls it; red
// has a float per column of the block.
template <int L>
__device__ __forceinline__ float group_sum(float x, const BatchLane& b,
                                           int V, float* red) {
  float s = 0.0f;
  if (b.one_warp) {
    for (int v = 0; v < V; ++v)
      s += __shfl_sync(kFullMask, x, (b.gbase + v * L) & 31);
    return s;
  }
  if (b.act && b.lane == 0) red[b.vc] = x;
  __syncthreads();
  for (int v = 0; v < V; ++v) s += red[v];
  __syncthreads();
  return s;
}

// Sum over all lanes of the seed group (team butterflies, then columns).
template <int L>
__device__ __forceinline__ float group_total(float x, const BatchLane& b,
                                             int V, float* red) {
  return group_sum<L>(team_sum<L>(x), b, V, red);
}

// Coherent overlap terms of the team's column with its target vector:
// re = sum_i (fa ta + fb tb), im = sum_i (fb ta - fa tb), one row a lane.
template <int M>
__device__ __forceinline__ void team_overlap(float psi, const float* tgt,
                                             int V, const BatchLane& b,
                                             float* re, float* im) {
  constexpr int N = M / 2;
  float r = 0.0f, q = 0.0f;
  if (b.live) {
    const int i = b.row % N;
    const float ta = tgt[i * V + b.vc], tb = tgt[(N + i) * V + b.vc];
    r = b.row < N ? psi * ta : psi * tb;
    q = b.row < N ? -(psi * tb) : psi * ta;
  }
  *re = team_sum<team_lanes(M)>(r);
  *im = team_sum<team_lanes(M)>(q);
}

// The lane's row of d(re gr + im gi)/d psi: gr ta - gi tb on the first N
// rows, gr tb + gi ta on the last N.
template <int M>
__device__ __forceinline__ float team_overlap_bar(float gr, float gi,
                                                  const float* tgt, int V,
                                                  const BatchLane& b) {
  constexpr int N = M / 2;
  if (!b.live) return 0.0f;
  const int i = b.row % N;
  const float ta = tgt[i * V + b.vc], tb = tgt[(N + i) * V + b.vc];
  return b.row < N ? gr * ta - gi * tb : gr * tb + gi * ta;
}

// Forbidden-level penalty of the team's state: sum_f alpha 0.5 pop^2 with
// pop = (rs . psi)^2 + (rns . psi)^2 (team sums).
template <int M>
__device__ __forceinline__ float team_forb_penalty(const BatchCostArgs& ca,
                                                   float psi,
                                                   const BatchLane& b) {
  constexpr int L = team_lanes(M);
  float pen = 0.0f;
  for (int f = 0; f < ca.nforb; ++f) {
    const float* rf = ca.forb + f * (1 + 2 * M);
    const float ps = team_sum<L>(b.live ? rf[1 + b.row] * psi : 0.0f);
    const float pn = team_sum<L>(b.live ? rf[1 + M + b.row] * psi : 0.0f);
    const float pop = ps * ps + pn * pn;
    pen += rf[0] * 0.5f * pop * pop;
  }
  return pen;
}

// pbar += d(forbidden penalty)/d psi at one stored state, the lane's row.
template <int M>
__device__ __forceinline__ void team_forb_cotangent(const BatchCostArgs& ca,
                                                    float psi,
                                                    const BatchLane& b,
                                                    float& pbar) {
  constexpr int L = team_lanes(M);
  for (int f = 0; f < ca.nforb; ++f) {
    const float* rf = ca.forb + f * (1 + 2 * M);
    const float rs = b.live ? rf[1 + b.row] : 0.0f;
    const float rn = b.live ? rf[1 + M + b.row] : 0.0f;
    const float ps = team_sum<L>(rs * psi);
    const float pn = team_sum<L>(rn * psi);
    const float pop = ps * ps + pn * pn;
    const float bs = (2.0f * rf[0]) * pop * ps;
    const float bn = (2.0f * rf[0]) * pop * pn;
    pbar += rs * bs + rn * bn;
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

// Launch geometry (mirrored by _cuda.batch_geometry): lanes per team, seed
// groups per block, threads per block (whole warps), blocks.
struct BatchGeometry {
  int L, groups, threads, blocks;
};

__host__ __device__ inline BatchGeometry batch_geometry(int M, int V, int C) {
  BatchGeometry g;
  g.L = team_lanes(M);
  const int G = V * g.L;
  g.groups = G <= 32 ? 32 / G : 1;
  g.threads = (g.groups * G + 31) / 32 * 32;
  const int seeds = C / V;
  g.blocks = (seeds + g.groups - 1) / g.groups;
  return g;
}

// Shared memory of a block: the generators (KG slots), the Taylor
// coefficients, a float per column for group sums, and the replayed
// powers of one step ([2^s * order][threads]).
__host__ __device__ inline long batch_smem_floats(int KG, int M, int order,
                                                  int scaling, int threads) {
  return (long)team_smats_floats(KG, M) + order + threads / team_lanes(M) +
         ((long)order << scaling) * threads;
}

// mats [K][MM] (row 0 drift, 1..Kc controls, Kc+1.. extra channels with
// constant per-column weights ew [E][C]); maxamp [Kc]; psi0, tgt [M][V];
// u, m, v [T][Kc][C], itc, done [C] updated in place; stats [3][C] =
// (loss, grad^2, reg_loss).  Scratch: traj [T+1][C][M], wbar [C][T][Kc],
// sn and gs [S][T][Kc].  clocks (null unless asked for):
// [gridDim.x][kClockPhases] int64, to which thread 0 of each block adds
// its clock64() cycles per phase of every iteration.  KG = team_slots(K).
template <int M, int KG, bool kCosts>
// The buffers never overlap (__restrict__): a pass over a seed's elements
// may then load the next elements before it stores the last, which keeps
// several loads in flight.  One block per SM is all the launch needs, so
// registers go to the block's threads rather than to more resident blocks.
__global__ void __launch_bounds__(kMaxBatchThreads, 1)
mega_batch_kernel(const float* __restrict__ mats, int K, int Kc, int V,
                  int T, int C, int order, int scaling, int n_iters,
                  const float* __restrict__ maxamp,
                  const float* __restrict__ psi0,
                  const float* __restrict__ tgt, const float* __restrict__ ew,
                  float* __restrict__ u, float* __restrict__ m,
                  float* __restrict__ v, float* __restrict__ itc,
                  float* __restrict__ done, float* __restrict__ stats,
                  float* __restrict__ traj, float* __restrict__ sn,
                  float* __restrict__ wbar, float* __restrict__ gs,
                  long long* __restrict__ clocks, BatchAdam c,
                  BatchCostArgs ca) {
  constexpr int L = team_lanes(M);
  extern __shared__ float sm[];
  float* S = sm;
  float* coef = S + team_smats_floats(KG, M);
  float* red = coef + order;
  float* pw = red + blockDim.x / L;
  team_smats<M, KG>(mats, K, S);
  for (int n = threadIdx.x; n < order; n += blockDim.x)
    coef[n] = n ? (float)(1.0 / (double)(1 << scaling) / (double)n) : 0.0f;
  __syncthreads();

  const int tid = threadIdx.x;
  BatchLane b;
  b.G = V * L;
  b.one_warp = b.G <= 32;
  const int groups = b.one_warp ? 32 / b.G : 1;
  b.gl = tid % b.G;
  b.vc = b.gl / L;
  b.lane = b.gl % L;
  b.seed = blockIdx.x * groups + tid / b.G;
  b.act = tid < groups * b.G && b.seed < C / V;
  if (!b.act) b.seed = 0;   // idle lanes compute on seed 0, store nothing
  b.cg0 = b.seed * V;
  b.col = b.cg0 + b.vc;
  b.live = b.act && b.lane < M;
  b.row = b.lane < M ? b.lane : M - 1;
  b.gbase = (tid & 31) - b.gl;
  const int G = b.G, gl = b.gl;
  const long TK = (long)T * Kc;
  const TeamGen<M, KG> gen(S, b.row);
  float* sn_s = sn + (long)b.seed * TK;   // this seed's sin(u), gradient
  float* gs_s = gs + (long)b.seed * TK;
  const float inv_v2 = (float)(1.0 / (double)(V * V));
  float a_spd = 0.0f;
  bool spd = false, forb = false;
  if constexpr (kCosts) {
    a_spd = ca.a_spd;
    spd = ca.a_spd != 0.0f;
    forb = ca.nforb > 0;
  }

  // wk: the step's weights (drift 1, controls maxamp sin(u), the extra
  // channels' constants, 0 past K); wn: the next step's controls, loaded
  // ahead (slots outside 1..Kc read channel 1 and are not taken)
  float wk[KG], wn[KG], amp[KG], wacc[KG];
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    amp[k] = (k >= 1 && k <= Kc) ? maxamp[k - 1] : 0.0f;
    wk[k] = k == 0 ? 1.0f
            : (k > Kc && k < K) ? ew[(long)(k - 1 - Kc) * C + b.col] : 0.0f;
    wn[k] = 0.0f;
    wacc[k] = 0.0f;
  }
  auto load_w = [&](int t) {
#pragma unroll
    for (int k = 0; k < KG; ++k)
      wn[k] = amp[k] * sn_s[(long)t * Kc + min(max(k, 1), Kc) - 1];
  };
  auto take_w = [&]() {
#pragma unroll
    for (int k = 1; k < KG; ++k) wk[k] = k <= Kc ? wn[k] : wk[k];
  };
  auto traj_at = [&](int t) {
    return b.live ? traj[((long)t * C + b.col) * M + b.row] : 0.0f;
  };

  long long clk = 0;
  auto tick = [&](int phase) {   // thread 0's cycles since the last tick
    if (clocks != nullptr && tid == 0) {
      const long long now = clock64();
      if (phase >= 0)
        clocks[(long)blockIdx.x * kClockPhases + phase] += now - clk;
      clk = now;
    }
  };

  for (int iter = 0; iter < n_iters; ++iter) {
    tick(-1);
    const float itv = b.act ? itc[b.cg0] : 0.0f;
    const float dn0 = b.act ? done[b.cg0] : 1.0f;
    // ---- sin(u), once per seed over its lanes ----
    if (b.act) {
#pragma unroll 4
      for (long e = gl; e < TK; e += G) sn_s[e] = sinf(u[e * C + b.cg0]);
    }
    __syncthreads();
    tick(0);

    // ---- the forward chain ----
    float psi = b.live ? psi0[b.row * V + b.vc] : 0.0f;
    if (b.live) traj[(long)b.col * M + b.row] = psi;
    float pen = 0.0f;   // the column's forbidden penalty
    load_w(0);
    for (int t = 0; t < T; ++t) {
      take_w();
      if (t + 1 < T) load_w(t + 1);
      psi = team_step<M, KG>(gen, wk, coef, order, scaling, psi);
      if (b.live) traj[((long)(t + 1) * C + b.col) * M + b.row] = psi;
      if constexpr (kCosts) {
        if (forb) pen += team_forb_penalty<M>(ca, psi, b);
        if (spd) {
          float r, q;
          team_overlap<M>(psi, tgt, V, b, &r, &q);
          if (b.act && b.lane == 0) {
            ca.ov[(long)(t + 1) * 2 * C + b.col] = r;
            ca.ov[(long)(t + 1) * 2 * C + C + b.col] = q;
          }
        }
      }
    }
    float re, im;
    team_overlap<M>(psi, tgt, V, b, &re, &im);
    __syncthreads();   // the group's speed_up overlaps are stored
    tick(1);

    // ---- coherent fidelity of each seed (sums over its V columns) ----
    const float re_g = group_sum<L>(re, b, V, red);
    const float im_g = group_sum<L>(im, b, V, red);
    const float loss = 1.0f - (re_g * re_g + im_g * im_g) * inv_v2;
    const float sc = (float)(-2.0 / (double)(V * V));
    float pbar = team_overlap_bar<M>(sc * re_g, sc * im_g, tgt, V, b);
    float pen_spd = 0.0f, s_spd = 0.0f;
    if constexpr (kCosts) {
      if (forb) team_forb_cotangent<M>(ca, psi, b, pbar);   // tau = T
      if (spd) {
        // speed_up (regularization_functions.py:88-95): a_spd/2 (T+1 -
        // ip3)^2, ip3 = c0 + sum_tau |group overlap_tau|^2 / V^2, the
        // steps split over the group's lanes
        float part = 0.0f, gre = 0.0f, gim = 0.0f;
        if (b.act) {
          for (int tau = 1 + gl; tau <= T; tau += G) {
            group_overlap(ca.ov, tau, C, b.cg0, V, &gre, &gim);
            part += (gre * gre + gim * gim) * inv_v2;
          }
          group_overlap(ca.ov, T, C, b.cg0, V, &gre, &gim);
        }
        const float ip3 = ca.spd_c0 + group_total<L>(part, b, V, red);
        const float miss = (float)(T + 1) - ip3;
        pen_spd = a_spd * 0.5f * miss * miss;
        s_spd = (-2.0f * a_spd * inv_v2) * miss;
        pbar += s_spd * team_overlap_bar<M>(gre, gim, tgt, V, b);
      }
    }
    tick(2);

    // ---- reverse sweep: wbar of the control channels ----
    load_w(T - 1);
    float psin = traj_at(T - 1);
    for (int t = T - 1; t >= 0; --t) {
      const float psi_t = psin;
      take_w();
#pragma unroll
      for (int k = 0; k < KG; ++k) wacc[k] = 0.0f;
      if (t > 0) {
        load_w(t - 1);
        psin = traj_at(t - 1);
      }
      pbar = team_step_backward<M, KG>(gen, wk, coef, order, scaling, psi_t,
                                       pbar, wacc, pw + tid, blockDim.x,
                                       b.live);
#pragma unroll
      for (int k = 1; k < KG; ++k) {
        const float s = team_sum<L>(wacc[k]);
        if (b.act && k <= Kc && b.lane == k % L)
          wbar[(long)b.col * TK + (long)t * Kc + k - 1] = s;
      }
      if constexpr (kCosts) {
        if (t > 0) {   // tau = 0 only feeds the discarded psi0 cotangent
          if (forb) team_forb_cotangent<M>(ca, psi_t, b, pbar);
          if (spd) {
            float gre = 0.0f, gim = 0.0f;
            if (b.act) group_overlap(ca.ov, t, C, b.cg0, V, &gre, &gim);
            pbar += s_spd * team_overlap_bar<M>(gre, gim, tgt, V, b);
          }
        }
      }
    }
    __syncthreads();   // the group's wbar is written
    tick(3);

    // ---- bandpass spectrum, once per seed, split by bin ----
    float pen_p = 0.0f;   // this lane's share of the pulse penalties
    if constexpr (kCosts) {
      if (ca.a_bp != 0.0f && b.act) {
        // re_f = sum_t sn C[t,f], im_f = -sum_t sn S[t,f] of each control
        // channel; keep (re, im) / |.| (0 where |.| = 0)
        const int F = ca.F;
        float* sp = ca.spec + (long)b.seed * Kc * F * 2;
        float mags = 0.0f;
        for (int e = gl; e < Kc * F; e += G) {
          const int k = e / F, f = e % F;
          float rr = 0.0f, ii = 0.0f;
#pragma unroll 8
          for (int t = 0; t < T; ++t) {   // the loads of 8 steps in flight
            const float s = sn_s[(long)t * Kc + k];
            rr += s * ca.dftc[(long)t * F + f];
            ii += s * ca.dfts[(long)t * F + f];
          }
          ii = -ii;
          const float mag = sqrtf(rr * rr + ii * ii);
          mags += mag;
          const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, 1e-30f) : 0.0f;
          sp[2 * e] = rr * inv;
          sp[2 * e + 1] = ii * inv;
        }
        pen_p += ca.a_bp * mags;
      }
      __syncthreads();   // the seed's spectrum is written
    }
    tick(4);

    // ---- the gradient and grad^2, once per seed, split by (t, k) ----
    float g2 = 0.0f;
    if (b.act) {
#pragma unroll 2
      for (long e = gl; e < TK; e += G) {
        const int t = (int)(e / Kc), k = (int)(e % Kc);
        float ws = 0.0f;
        for (int vv = 0; vv < V; ++vv)
          ws += wbar[(long)(b.cg0 + vv) * TK + e];
        const float cu = cosf(u[e * C + b.cg0]);
        float g;
        if constexpr (kCosts) {
          auto at = [&](int tt) {   // sin(u) with zeros outside [0, T)
            return (tt >= 0 && tt < T) ? sn_s[(long)tt * Kc + k] : 0.0f;
          };
          const float s = sn_s[e];
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
            const float sm1 = at(t - 1), sp1 = at(t + 1);
            const float d = (s - sm1) * ca.inv_dt;
            pen_p += ca.a_dwdt * 0.5f * d * d;
            if (t == T - 1) {   // d_T = -w_{T-1}/dt (the trailing pad)
              const float tail = s * ca.inv_dt;
              pen_p += ca.a_dwdt * 0.5f * tail * tail;
            }
            gw += ca.c_dwdt * (2.0f * s - sm1 - sp1);
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
            const float* sp = ca.spec + ((long)b.seed * Kc + k) * F * 2;
            float acc = 0.0f;
#pragma unroll 8
            for (int f = 0; f < F; ++f)   // the loads of 8 bins in flight
              acc += ca.dftc[(long)t * F + f] * sp[2 * f]
                     - ca.dfts[(long)t * F + f] * sp[2 * f + 1];
            gw += ca.a_bp * acc;
          }
          g = (ws * maxamp[k] + gw) * cu;
        } else {
          g = ws * (maxamp[k] * cu);
        }
        gs_s[e] = g;
        g2 += g * g;
      }
    }
    g2 = 0.5f * group_total<L>(g2, b, V, red);
    if constexpr (kCosts) pen_p = group_total<L>(pen_p, b, V, red);
    tick(5);

    // ---- metrics, convergence test and Adam (frozen seeds masked) ----
    float reg = loss;
    if constexpr (kCosts) {
      reg = loss + group_sum<L>(pen, b, V, red) + ca.forb_c0 + pen_p +
            pen_spd;
    }
    const bool conv = loss < c.conv_target || g2 < c.min_grad ||
                      itv >= c.max_iterations;
    const float dn = fmaxf(dn0, conv ? 1.0f : 0.0f);
    const float dof = 1.0f - dn;
    if (b.act) {
      const float cnt = itv + 1.0f;
      const float lr = c.rate * expf(c.ln_f * itv);
      const float bc1 = 1.0f - expf(cnt * c.ln_b1);
      const float bc2 = 1.0f - expf(cnt * c.ln_b2);
#pragma unroll 4
      for (long e = gl; e < TK; e += G) {
        const long i0 = e * C + b.cg0;
        const float gk = gs_s[e], am = m[i0], av = v[i0];
        const float mm = c.b1 * am + c.one_minus_b1 * gk;
        const float vv = c.b2 * av + c.one_minus_b2 * (gk * gk);
        const float upd = (mm / bc1) / (sqrtf(vv / bc2) + c.eps);
        const float un = u[i0] - dof * (lr * upd);
        const float mn = am + dof * (mm - am);
        const float vn = av + dof * (vv - av);
        for (int w = 0; w < V; ++w) {   // every column copy of the seed
          u[i0 + w] = un;
          m[i0 + w] = mn;
          v[i0 + w] = vn;
        }
      }
      if (gl < V) {
        const int cc = b.cg0 + gl;
        stats[cc] = loss;
        stats[C + cc] = g2;
        stats[2L * C + cc] = reg;
        itc[cc] = itv + dof;
        done[cc] = dn;
      }
    }
    const bool frozen = !b.act || dn > 0.5f;
    tick(6);
    if (__syncthreads_and(frozen)) break;
  }
}

// Host side: launch one segment on `stream`; returns the launch's error.
template <bool kCosts>
int launch_mega_batch(const float* mats, int K, int M, int Kc, int V, int T,
                      int C, int order, int scaling, int n_iters,
                      const float* maxamp, const float* psi0,
                      const float* tgt, const float* ew, float* u, float* m,
                      float* v, float* itc, float* done, float* stats,
                      float* traj, float* sn, float* wbar, float* gs,
                      long long* clocks, const BatchAdam& c,
                      const BatchCostArgs& ca, void* stream) {
  if (V < 1 || V > kMaxVBatch || K > kMaxK || C < 1 || C % V != 0 ||
      T < 1 || order < 1 || scaling < 0 || scaling > 20)
    return (int)cudaErrorInvalidValue;
  const BatchGeometry g = batch_geometry(M, V, C);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, QOC_DISPATCH_SLOTS(K, {
    const size_t smem =
        batch_smem_floats(kKG, M, order, scaling, g.threads) * sizeof(float);
    auto kernel = mega_batch_kernel<kM, kKG, kCosts>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<g.blocks, g.threads, smem, s>>>(
        mats, K, Kc, V, T, C, order, scaling, n_iters, maxamp, psi0, tgt, ew,
        u, m, v, itc, done, stats, traj, sn, wbar, gs, clocks, c, ca);
  }));
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
      float *wbar, float *gs, long long *clocks, const qoc::BatchAdam *adam
#define QOC_BATCH_ARGS                                                       \
  mats, K, M, Kc, V, T, C, order, scaling, n_iters, maxamp, psi0, tgt, ew,   \
      u, m, v, itc, done, stats, traj, sn, wbar, gs, clocks, *adam
