// Fused Adam segment kernel: n complete GRAPE iterations (sin-bounded
// weights, chain product, coherent fidelity, penalties, exact backward,
// Adam with bias correction and exponential LR decay, convergence test
// and freeze) in ONE launch, one problem spread over a thread-block
// cluster.
//
// Replaces qoc_tpu/ops/pallas_mega.py::_mega_kernel / _build_mega_call
// (kernel 3), all branches.  Two instances per M:
//   * mega_segment_kernel<M, false> (mega.cu): the fidelity-only
//     objective;
//   * mega_segment_kernel<M, true> (mega_costs.cu): the same plus the
//     pulse-shape penalties (amplitude, envelope, dwdt, d2wdt2), the
//     bandpass penalty as hand-written DFT products over the penalized
//     bins, and, when a cost reads the trajectory (forbidden levels,
//     speed_up), its values and cotangents at every step.
// The costs branches sit behind `if constexpr (kCosts)`.
//
// Work split (mega_geometry).  The Tp time lanes go to a cluster of G
// blocks, each owning TB = Tp / G contiguous lanes.  A block is NT threads
// (at most 512, 256 in the costs instance) in at most 64 teams of L =
// team_lanes(M) lanes (state_chain.cuh); lane i of a team holds row i of
// every matrix or vector the team works on, and each team owns a segment
// of S = TB / teams contiguous lanes (S = 1 and lanes past TB that are
// identities where TB < teams).  Matrices sit in shared memory
// column-major with the column stride MP = M rounded up to 4 (float4
// reads of a column); a thread keeps O(M) floats: its row of the step
// generator A_t = sum_k w_k[t] mats_k (its column in team scratch), its
// row of the running sums and of Abar.
//
// Chain (the association this kernel uses).  With x_{t+1} = P_t x_t the
// states (x_0 = psi0, V columns) and P_t = Taylor_order(A_t / 2^s)^(2^s):
//   1. each team walks its segment from the identity, applying P_t by the
//      series (p_n = A p_{n-1} 2^-s / n, 2^s times), which gives the
//      segment's product Q = P_{b-1} ... P_a (no P_t is stored);
//   2. a pairwise tree over the block's segments (later on the left)
//      gives the block's product C_b, with a block barrier per level;
//   3. the cluster meets (barrier), every block reads the G products
//      from the others' shared memory and walks x_0 through them in
//      order, so each block holds its own start and end states and the
//      final state, from which it forms the loss and its cotangent fbar
//      (every block the same numbers in the same order);
//   4. down the tree, the state at each segment start is the left child's
//      product applied to the state at its parent's start;
//   5. each team walks the states of its segment's lanes by the series.
// The reverse mirrors it with nu_t, the cotangent of x_t from the steps
// after t: nu_Tp = fbar (padded lanes are identities, so x_T = x_Tp), a
// block's end value is fbar pulled back through the later blocks'
// products, and down the tree nu at a segment end is the right child's
// product, transposed, applied to nu at its parent's end.  In trajectory
// mode the costs add a direct cotangent D_t at every state; a first
// reverse walk per segment sums them to its start (R, by the series of
// A^T), a tree and the cluster combine the R's with the products (R =
// R_left + Q_left^T R_right), and they enter each pull-back.  The last
// reverse walk runs each column back through each step from its stored
// state (replaying the series' powers), accumulates the lane's row of
// Abar = sum_n c_n pbar_n p_{n-1}^T and reads the weight cotangents
// <mats_k, Abar> by team sums.  Work: Tp M^3 per series power for the
// walks from the identity, Tp / S tree products, and matvecs for the
// states and their cotangents; no log2(Tp)-level scan.  The rounding
// differs from the plain version's tree or Hillis-Steele scan by float32
// association only.
//
// Costs.  sw = sin(u) * live goes to a [Kc][Tp] buffer that the blocks
// read across their boundaries (the difference penalties' zero padding
// outside [0, T), d2wdt2's second differences formed on the fly); the
// bandpass spectrum is summed per block over its lanes, met at a cluster
// barrier and finished by every block for itself (all bins, in block
// order), and its cotangent is formed for the block's lanes.  The
// trajectory costs read each lane's stored states (forbidden populations,
// the speed_up overlap); the speed_up sum meets at a cluster barrier
// before the reverse.
//
// Every sum is a fixed-order reduction (shared-memory trees and warp
// butterflies within a block, then the G block values in rank order, the
// same in every block): no atomics, so the kernel is deterministic.  The
// loss, its cotangent, grad^2 and the convergence test are computed by
// every block alike.
//
// Bound.  Latency: per iteration two cluster barriers (three with
// bandpass, four in trajectory mode), about 2 log2(Tp / (G S)) + G block
// barriers, and per team S serial steps of M-long FMA chains; the
// operations (~order M^3 Tp) are far below the card's rate.  Nothing of
// order M^2 Tp leaves shared memory: the device scratch is sw and g
// [Kc][Tp] (and the bandpass spectra).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"
#include "state_chain.cuh"
#include "team.cuh"   // Team, ld_col, dot, block_sum, team_lanes, team_sum

namespace qoc {

constexpr int kMaxV = 16;       // concerned vectors
constexpr int kMaxVTraj = 8;    // concerned vectors in trajectory mode
constexpr int kMegaThreads = 512;          // most threads of a block
constexpr int kMegaSmemMax = 232448;       // dynamic shared memory a block
// Phases of the optional clock64 counters (mirrored by
// _cuda.MEGA_CLOCK_PHASES): the Taylor forward (sin, generator, the
// segment walks from the identity), the pulse and bandpass penalties, the
// chain product (tree, cluster, states), the loss and its cotangent, the
// trajectory passes, the chain reverse, the Taylor reverse and gradient,
// grad^2 and the convergence test, and Adam.
constexpr int kMegaClockPhases = 9;

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
  float* spec;          // [2][G][Kc][F][2] scratch: the blocks' partial
                        // spectra, then each block's (re, im) / |.|
  int nforb, F, traj;
  float a_amp, a_env, a_dwdt, a_d2, inv_dt, a_bp, a_spd, spd_c0, forb_c0;
};

// Most threads of a block: at most 64 teams of team_lanes(M) lanes, and
// at most 256 in the costs instance, whose phases keep more live values
// (with 512 threads a thread has 128 registers, and ptxas spilled it).
__host__ __device__ constexpr int mega_max_threads(int M, bool costs) {
  return 64 * team_lanes(M) < (costs ? kMegaThreads / 2 : kMegaThreads)
             ? 64 * team_lanes(M)
             : (costs ? kMegaThreads / 2 : kMegaThreads);
}
__host__ __device__ constexpr long al4(long n) { return (n + 3) & ~3L; }

// Launch geometry and shared-memory layout (mirrored by
// _cuda.mega_geometry); offsets in floats from the dynamic buffer.
struct MegaGeometry {
  int G, NT, L, teams, TB, S;     // cluster, threads, team, per block
  int nterms, reps, MP, TS;       // series, column stride, team scratch
  long smats, coef, amp, tree, rtree, xl, nb, ct, rt, ya, yb, fb, z0, z1;
  long team, red, slots, ov, dl, total;
};

// cap: the most threads (a power of two >= 32).
__host__ __device__ inline MegaGeometry mega_layout(int G, int M, int Tp,
                                                    int K, int V, int order,
                                                    int scaling, bool traj,
                                                    int cap) {
  MegaGeometry g;
  g.G = G;
  g.L = team_lanes(M);
  g.TB = Tp / G;
  long nt = (long)g.TB * g.L;   // a team per lane, at most cap threads
  nt = nt < 32 ? 32 : nt > cap ? cap : nt;
  g.NT = (int)nt;
  g.teams = g.NT / g.L;
  g.S = g.TB > g.teams ? g.TB / g.teams : 1;
  g.nterms = order + 1;
  g.reps = 1 << scaling;
  g.MP = mega_mp(M);
  const int MP = g.MP, nseg = g.teams, tbv = nseg * g.S;
  const long mat = (long)M * MP, vec = (long)V * MP;
  const long series = (long)(g.reps + g.nterms + 2 + g.L) * MP;
  const long walk = 2 * mat > series ? 2 * mat : series;
  g.TS = (int)al4(walk + vec);
  long o = 0;
  g.smats = o; o += al4((long)K * M * (M + 1));
  g.coef = o;  o += al4(g.nterms);
  g.amp = o;   o += al4(K);
  g.tree = o;  o += (2L * nseg - 1) * mat;
  g.rtree = o; o += traj ? (2L * nseg - 1) * vec : 0;
  g.xl = o;    o += (long)(tbv + 1) * vec;
  g.nb = o;    o += (long)(nseg + 1) * vec;
  g.ct = o;    o += (long)G * mat;
  g.rt = o;    o += traj ? (long)G * vec : 0;
  g.ya = o;    o += (long)(V + 1) * MP;
  g.yb = o;    o += (long)(V + 1) * MP;
  g.fb = o;    o += vec;
  g.z0 = o;    o += vec;
  g.z1 = o;    o += vec;
  g.team = o;  o += (long)g.teams * g.TS;
  g.red = o;   o += g.NT;
  g.slots = o; o += 8;
  g.ov = o;    o += traj ? 2L * tbv : 0;
  g.dl = o;    o += traj ? (long)(tbv + 1) * vec : 0;
  g.total = o;
  return g;
}

// The rule: G = Tp / 32 blocks, at most 8 (a portable cluster) of at
// most mega_max_threads(M, costs) threads; where that would not fit the
// shared memory, 16 blocks, then 16 blocks of half the threads; G = 0
// where nothing fits.
__host__ __device__ inline MegaGeometry mega_geometry(int M, int Tp, int K,
                                                      int V, int order,
                                                      int scaling, bool costs,
                                                      bool traj) {
  int G = Tp / 32;
  G = G < 1 ? 1 : G > 8 ? 8 : G;
  const int cap = mega_max_threads(M, costs);
  MegaGeometry g = mega_layout(G, M, Tp, K, V, order, scaling, traj, cap);
  if (g.total * 4 > kMegaSmemMax && Tp >= 32)
    g = mega_layout(16, M, Tp, K, V, order, scaling, traj, cap);
  if (g.total * 4 > kMegaSmemMax && Tp >= 32 && cap > 32)
    g = mega_layout(16, M, Tp, K, V, order, scaling, traj, cap / 2);
  if (g.total * 4 > kMegaSmemMax) g.G = 0;
  return g;
}

// The lane's row and column of A_t = live mats_0 + sum_k amp_k sw_k[t]
// mats_k (S: mats [K][M][M + 1] in shared memory); zero where !live.
template <int M>
__device__ __forceinline__ void generator(const float* S, const float* amp,
                                          const float* sw, int K, int Tp,
                                          int t, bool live, int row,
                                          float (&ar)[M], float (&ac)[M]) {
  const float l0 = live ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    ar[j] = S[row * (M + 1) + j] * l0;
    ac[j] = S[j * (M + 1) + row] * l0;
  }
  if (!live) return;
  for (int k = 1; k < K; ++k) {
    const float wk = amp[k] * sw[(long)(k - 1) * Tp + t];
    const float* Sk = S + k * M * (M + 1);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ar[j] += Sk[row * (M + 1) + j] * wk;
      ac[j] += Sk[j * (M + 1) + row] * wk;
    }
  }
}

// X <- P X for NC columns X[c * MP + i] in shared memory (in place), P =
// (sum_{n < nterms} (A 2^-s)^n / n!)^(2^s) applied by the series; a: the
// lane's row of A (its column, for P^T).  P0, P1: NC * MP floats each.
// Ends with the team's columns written and visible to the warp.
template <int M, int NC>
__device__ __forceinline__ void team_series(const float (&a)[M], float* X,
                                            float* P0, float* P1,
                                            const float* coef, int nterms,
                                            int reps, const Team& tm) {
  constexpr int MP = mega_mp(M);
  for (int r = 0; r < reps; ++r) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = X[c * MP + tm.row];
    const float* cur = X;
    float* nxt = P0;
    for (int n = 1; n < nterms; ++n) {
      const float cf = coef[n];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float v[M];
        ld_col<M>(cur + c * MP, v);
        const float y = dot<M>(a, v) * cf;
        if (tm.rl) nxt[c * MP + tm.row] = y;
        acc[c] += y;
      }
      __syncwarp();
      cur = nxt;
      nxt = nxt == P0 ? P1 : P0;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tm.rl) X[c * MP + tm.row] = acc[c];
    __syncwarp();
  }
}

// The trajectory costs' direct cotangent at a stored state x (column v,
// rows in shared memory) into d (rows): the forbidden levels' and
// speed_up's ((ore, oim): the state's overlap with the target, s_spd its
// weight).
template <int M>
__device__ __forceinline__ void traj_cotangent(const CostArgs& ca,
                                               const float* x,
                                               const float* target, int N,
                                               int V, int v, float ore,
                                               float oim, float s_spd,
                                               float* d) {
  float xv[M], dv[M];
  ld_col<M>(x, xv);
#pragma unroll
  for (int i = 0; i < M; ++i) dv[i] = 0.0f;
  for (int f = 0; f < ca.nforb; ++f) {
    const float* rf = ca.forb + f * (1 + 2 * M);
    float ps = 0.0f, pn = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ps += rf[1 + j] * xv[j];
      pn += rf[1 + M + j] * xv[j];
    }
    const float pop = ps * ps + pn * pn;
    const float bs = (2.0f * rf[0]) * pop * ps;
    const float bn = (2.0f * rf[0]) * pop * pn;
#pragma unroll
    for (int i = 0; i < M; ++i) dv[i] += rf[1 + i] * bs + rf[1 + M + i] * bn;
  }
  if (s_spd != 0.0f) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float tgt_im = i < N ? -target[(N + i) * V + v]
                                 : target[(i - N) * V + v];
      dv[i] += s_spd * (ore * target[i * V + v] + oim * tgt_im);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = dv[i];
}

// mats [K][MM] (row 0 = drift), psi0 [M][V], target [M][V], maxamp [K-1],
// u0rows [M]; u, m, v [K-1][Tp] updated in place; sf_in [3] = (lr,
// iteration, done); met [8] = (loss, grad^2, unitary_scale, lr, iteration,
// done, reg_loss, 0).  Scratch: sw, g [K-1][Tp].  clocks (null unless
// asked for): [gridDim.x][kMegaClockPhases] int64, to which thread 0 of
// each block adds its clock64() cycles per phase of every iteration.
// Launched as one cluster of mega_geometry(...).G blocks.
template <int M, bool kCosts>
__global__ void __launch_bounds__(mega_max_threads(M, kCosts), 1)
mega_segment_kernel(const float* __restrict__ mats, int K, int N, int T,
                    int Tp, int V, int order, int scaling, int n_iters,
                    int unitary_mode, const float* __restrict__ psi0,
                    const float* __restrict__ target,
                    const float* __restrict__ maxamp,
                    const float* __restrict__ u0rows, float* __restrict__ u,
                    float* __restrict__ m, float* __restrict__ v,
                    const float* __restrict__ sf_in, float* __restrict__ met,
                    float* __restrict__ sw, float* __restrict__ g,
                    long long* __restrict__ clocks, AdamConsts c,
                    CostArgs ca) {
  constexpr int MP = mega_mp(M);
  constexpr int L = team_lanes(M);
  constexpr long MAT = (long)M * MP;
  extern __shared__ float smem[];
  bool traj = false;
  if constexpr (kCosts) traj = ca.traj != 0;
  const int G = (int)cluster_blocks();
  const int rank = (int)cluster_rank();
  const MegaGeometry geo =
      mega_layout(G, M, Tp, K, V, order, scaling, traj, blockDim.x);
  float* S = smem + geo.smats;
  float* coef = smem + geo.coef;
  float* amp = smem + geo.amp;
  float* tree = smem + geo.tree;
  float* rtree = smem + geo.rtree;
  float* XL = smem + geo.xl;
  float* NB = smem + geo.nb;
  float* CT = smem + geo.ct;
  float* RT = smem + geo.rt;
  float* FB = smem + geo.fb;
  float* red = smem + geo.red;
  float* slots = smem + geo.slots;   // [0] grad^2, [1] speed_up, [2] reg,
                                     // [3] loss, [4] unitary_scale,
                                     // [5] the speed_up penalty
  float* OV = smem + geo.ov;          // trajectory mode: overlaps,
  float* DL = smem + geo.dl;          // direct cotangents of the states
  const long VEC = (long)V * MP;
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int Kc = K - 1;
  const int TB = geo.TB, SG = geo.S, nseg = geo.teams;
  const int t0 = rank * TB;
  const int levels = 31 - __clz(nseg);
  const int nterms = geo.nterms, reps = geo.reps;

  for (long i = tid; i < (long)K * M * (M + 1); i += NT) {
    const int k = (int)(i / (M * (M + 1))), r = (int)(i % (M * (M + 1)));
    const int ii = r / (M + 1), jj = r % (M + 1);
    S[i] = jj < M ? mats[((long)k * M + ii) * M + jj] : 0.0f;
  }
  for (int n = tid; n < nterms; n += NT)
    coef[n] = n ? (float)(1.0 / (double)(1 << scaling) / (double)n) : 0.0f;
  for (int k = tid; k < K; k += NT) amp[k] = k ? maxamp[k - 1] : 1.0f;
  for (int i = tid; i < VEC; i += NT) FB[i] = 0.0f;

  Team tm;
  tm.idx = tid / L;
  tm.lane = tid % L;
  tm.row = tm.lane < M ? tm.lane : M - 1;
  tm.rl = tm.lane < M;
  float* ts = smem + geo.team + (long)tm.idx * geo.TS;
  float* NU = ts + (geo.TS - VEC);   // the team's nu columns
  const int lo = tm.idx * SG;        // the team's segment [lo, lo + SG)

  float lr = sf_in[0], itc = sf_in[1];
  bool done = sf_in[2] > 0.5f;
  float loss = INFINITY, g2 = INFINITY, uscale = 0.0f, regloss = INFINITY;
  __syncthreads();

  long long clk = 0;
  auto tick = [&](int phase) {   // thread 0's cycles since the last tick
    if (clocks != nullptr && tid == 0) {
      const long long now = clock64();
      if (phase >= 0)
        clocks[(long)blockIdx.x * kMegaClockPhases + phase] += now - clk;
      clk = now;
    }
  };
  // lane tl of the block: real (tl < TB) and live (real, t < T)
  auto live_lane = [&](int tl) { return tl < TB && t0 + tl < T; };

  for (int it = 0; it < n_iters; ++it) {
    tick(-1);
    // ---- sin(u) of the block's lanes ----
    for (long i = tid; i < (long)Kc * TB; i += NT) {
      const int k = (int)(i / TB), tl = (int)(i % TB);
      const long idx = (long)k * Tp + t0 + tl;
      sw[idx] = live_lane(tl) ? sinf(u[idx]) : 0.0f;
    }
    __syncthreads();

    // ---- each team's segment product, walked from the identity ----
    {
      float* X = tree + (long)tm.idx * MAT;
      for (int cc = 0; cc < M; ++cc)
        if (tm.rl) X[cc * MP + tm.row] = cc == tm.row ? 1.0f : 0.0f;
      __syncwarp();
      for (int q = 0; q < SG; ++q) {
        const int tl = lo + q;
        float ar[M], ac[M];
        generator<M>(S, amp, sw, K, Tp, t0 + tl, live_lane(tl), tm.row, ar,
                     ac);
        team_series<M, M>(ar, X, ts, ts + MAT, coef, nterms, reps, tm);
      }
    }
    __syncthreads();
    tick(0);

    // ---- up the tree: node (l+1, j) = node (l, 2j+1) node (l, 2j) ----
    {
      long off = 0;   // level l's first node
      for (int l = 0, cnt = nseg; l < levels; ++l, cnt >>= 1) {
        const long up = off + cnt;
        if (tm.idx < cnt / 2) {
          const float* A = tree + (off + 2L * tm.idx + 1) * MAT;
          const float* B = tree + (off + 2L * tm.idx) * MAT;
          float* C = tree + (up + tm.idx) * MAT;
          float ar[M];
#pragma unroll
          for (int j = 0; j < M; ++j) ar[j] = A[j * MP + tm.row];
#pragma unroll
          for (int cc = 0; cc < M; ++cc) {
            float bv[M];
            ld_col<M>(B + cc * MP, bv);
            const float s = dot<M>(ar, bv);
            if (tm.rl) C[cc * MP + tm.row] = s;
          }
        }
        off = up;
        __syncthreads();
      }
    }
    const float* root = tree + (2L * nseg - 2) * MAT;
    cluster_sync();   // every block's product (and sw) is visible

    // ---- the cluster's products, and the states at their starts ----
    for (long i = tid; i < (long)G * MAT; i += NT)
      CT[i] = *cluster_peer(root + i % MAT, (unsigned)(i / MAT));
    float* Y = smem + geo.ya;
    float* Yn = smem + geo.yb;
    for (int i = tid; i < (V + 1) * MP; i += NT) {
      const int cc = i / MP, r = i % MP;
      Y[i] = r >= M ? 0.0f
             : cc < V ? psi0[r * V + cc]
             : (unitary_mode ? u0rows[r] : 0.0f);
    }
    __syncthreads();
    for (int b = 0; b < G; ++b) {
      if (b == rank)
        for (int i = tid; i < VEC; i += NT) XL[i] = Y[i];
      for (int i = tid; i < (V + 1) * MP; i += NT) {
        const int cc = i / MP, r = i % MP;
        float s = 0.0f;
        if (r < M)
          for (int j = 0; j < M; ++j)
            s += CT[(long)b * MAT + j * MP + r] * Y[cc * MP + j];
        Yn[i] = s;
      }
      __syncthreads();
      float* tmp = Y;
      Y = Yn;
      Yn = tmp;
      if (b == rank)
        for (int i = tid; i < VEC; i += NT)
          XL[(long)nseg * SG * VEC + i] = Y[i];
    }
    tick(2);

    // ---- the loss and its cotangent (warp 0; every block alike) ----
    if (tid < 32) {
      float s_at = 0.0f, s_bt = 0.0f, s_ba = 0.0f, s_ab = 0.0f;
      float s_aa = 0.0f, s_bb = 0.0f, s_u = 0.0f;
      for (int e = tid; e < N * V; e += 32) {
        const int i = e / V, vv = e % V;
        const float fa = Y[vv * MP + i], fb = Y[vv * MP + N + i];
        const float ta = target[i * V + vv], tb = target[(N + i) * V + vv];
        s_at += fa * ta;
        s_bt += fb * tb;
        s_ba += fb * ta;
        s_ab += fa * tb;
        s_aa += fa * fa;
        s_bb += fb * fb;
      }
      for (int i = tid; i < M; i += 32) {
        const float r = Y[V * MP + i];
        s_u += r * r;
      }
      s_at = warp_sum(s_at);
      s_bt = warp_sum(s_bt);
      s_ba = warp_sum(s_ba);
      s_ab = warp_sum(s_ab);
      s_aa = warp_sum(s_aa);
      s_bb = warp_sum(s_bb);
      s_u = warp_sum(s_u);
      const float re = s_at + s_bt;
      const float im = s_ba - s_ab;
      const float VV = (float)(V * V);
      const float scale2 = (float)(-2.0 / (double)(V * V));
      for (int e = tid; e < N * V; e += 32) {
        const int i = e / V, vv = e % V;
        const float ta = target[i * V + vv], tb = target[(N + i) * V + vv];
        FB[vv * MP + i] = scale2 * (re * ta - im * tb);
        FB[vv * MP + N + i] = scale2 * (re * tb + im * ta);
      }
      if (tid == 0) {
        slots[3] = 1.0f - (re * re + im * im) / VV;
        const float nrm = s_aa + s_bb;
        slots[4] = unitary_mode ? (float)(0.5 / N) * s_u : nrm * nrm / VV;
      }
    }
    __syncthreads();
    loss = slots[3];
    uscale = slots[4];
    tick(3);

    // ---- down the tree: the state at every segment start ----
    for (int l = levels - 1; l >= 0; --l) {
      const int d = 1 << l;
      const long off = 2L * nseg - (2L * nseg >> l);   // level l's first node
      if (tm.idx < nseg / (2 * d)) {
        const int a = 2 * d * tm.idx;
        const float* Lc = tree + (off + 2L * tm.idx) * MAT;
        float ar[M];
#pragma unroll
        for (int j = 0; j < M; ++j) ar[j] = Lc[j * MP + tm.row];
        for (int vv = 0; vv < V; ++vv) {
          float xv[M];
          ld_col<M>(XL + (long)a * SG * VEC + vv * MP, xv);
          const float s = dot<M>(ar, xv);
          if (tm.rl) XL[(long)(a + d) * SG * VEC + vv * MP + tm.row] = s;
        }
      }
      __syncthreads();
    }
    // ---- each team's states through its segment (its end is the next
    // segment's start, from the tree) ----
    for (int q = 0; q + 1 < SG; ++q) {
      const int tl = lo + q;
      float ar[M], ac[M];
      generator<M>(S, amp, sw, K, Tp, t0 + tl, live_lane(tl), tm.row, ar, ac);
      for (int vv = 0; vv < V; ++vv) {
        float* x1 = XL + (long)(tl + 1) * VEC + vv * MP;
        if (tm.rl) x1[tm.row] = XL[(long)tl * VEC + vv * MP + tm.row];
        __syncwarp();
        team_series<M, 1>(ar, x1, ts, ts + MP, coef, nterms, reps, tm);
      }
    }
    __syncthreads();
    tick(2);

    // ---- pulse-shape and bandpass penalties of the block's lanes ----
    float reg_part = 0.0f;
    float s_spd = 0.0f, spd_term = 0.0f;
    if constexpr (kCosts) {
      const float idt2 = ca.inv_dt * ca.inv_dt;
      auto at = [&](int k, int t) {   // sin(u) with zeros outside [0, T)
        return (t >= 0 && t < T) ? sw[(long)k * Tp + t] : 0.0f;
      };
      auto s2 = [&](int k, int t) {
        return (at(k, t) - 2.0f * at(k, t - 1) + at(k, t - 2)) * idt2;
      };
      for (long i = tid; i < (long)Kc * TB; i += NT) {
        const int k = (int)(i / TB), t = t0 + (int)(i % TB);
        const long idx = (long)k * Tp + t;
        const float live = t < T ? 1.0f : 0.0f;
        const float s = at(k, t);
        float gw = 0.0f;
        if (ca.a_amp != 0.0f) {
          reg_part += ca.a_amp * 0.5f * (s * s);
          gw += ca.a_amp * s;
        }
        if (ca.a_env != 0.0f) {
          const float e = ca.env[idx];
          const float ew = e * s;
          reg_part += ca.a_env * 0.5f * (ew * ew);
          gw += ca.a_env * e * e * s;
        }
        if (ca.a_dwdt != 0.0f) {
          const float sm = at(k, t - 1), sp = at(k, t + 1);
          const float dd = (s - sm) * ca.inv_dt;
          reg_part += ca.a_dwdt * 0.5f * (dd * dd);
          gw += (ca.a_dwdt * idt2) * (2.0f * s - sm - sp) * live;
        }
        if (ca.a_d2 != 0.0f) {
          const float c0 = s2(k, t);
          const float n1 = t + 1 < Tp ? s2(k, t + 1) : 0.0f;
          const float n2 = t + 2 < Tp ? s2(k, t + 2) : 0.0f;
          reg_part += ca.a_d2 * 0.5f * (c0 * c0);
          gw += (ca.a_d2 * idt2) * (c0 - 2.0f * n1 + n2) * live;
        }
        g[idx] = gw;
      }
      if (ca.a_bp != 0.0f) {
        // the block's share of re_f[k,f] = sum_t sw C[t,f] and im_f =
        // -sum_t sw S[t,f], over its lanes
        const int F = ca.F;
        float* part = ca.spec + (long)rank * Kc * F * 2;
        const int te = min(t0 + TB, T);
        for (int i = tid; i < Kc * F; i += NT) {
          const int k = i / F, f = i % F;
          float re = 0.0f, im = 0.0f;
          for (int t = t0; t < te; ++t) {
            const float s = sw[(long)k * Tp + t];
            re += s * ca.dftc[(long)t * F + f];
            im -= s * ca.dfts[(long)t * F + f];
          }
          part[2 * i] = re;
          part[2 * i + 1] = im;
        }
      }
    }
    tick(1);

    // ---- trajectory costs: values and overlaps of the block's states ----
    if constexpr (kCosts) {
      if (traj) {
        float spd_part = 0.0f;
        for (int tl = tid; tl < TB; tl += NT) {
          if (t0 + tl >= T) continue;
          const float* x = XL + (long)(tl + 1) * VEC;   // the state after tl
          float re = 0.0f, im = 0.0f;
          for (int vv = 0; vv < V; ++vv) {
            float xv[M];
            ld_col<M>(x + vv * MP, xv);
            for (int f = 0; f < ca.nforb; ++f) {
              const float* rf = ca.forb + f * (1 + 2 * M);
              float ps = 0.0f, pn = 0.0f;
#pragma unroll
              for (int j = 0; j < M; ++j) {
                ps += rf[1 + j] * xv[j];
                pn += rf[1 + M + j] * xv[j];
              }
              const float pop = ps * ps + pn * pn;
              reg_part += rf[0] * 0.5f * (pop * pop);
            }
#pragma unroll
            for (int i = 0; i < M; ++i) {
              const float tgt_im = i < N ? -target[(N + i) * V + vv]
                                         : target[(i - N) * V + vv];
              re += xv[i] * target[i * V + vv];
              im += xv[i] * tgt_im;
            }
          }
          OV[2 * tl] = re;
          OV[2 * tl + 1] = im;
          spd_part += re * re + im * im;
        }
        const float spd_b = block_sum(spd_part, red);
        if (tid == 0) slots[1] = spd_b;
      }
    }
    tick(4);

    if constexpr (kCosts) {
      if (traj || ca.a_bp != 0.0f) {
        cluster_sync();   // partial spectra and speed_up sums are visible
        if (ca.a_bp != 0.0f) {
          // every block finishes the spectrum (all bins, blocks in rank
          // order) into its own copy, then the cotangent of its lanes
          const int F = ca.F;
          const long KF = (long)Kc * F;
          float* fin = ca.spec + ((long)G + rank) * KF * 2;
          for (long i = tid; i < KF; i += NT) {
            float re = 0.0f, im = 0.0f;
            for (int b = 0; b < G; ++b) {
              re += ca.spec[((long)b * KF + i) * 2];
              im += ca.spec[((long)b * KF + i) * 2 + 1];
            }
            const float mag = sqrtf(re * re + im * im);
            if (rank == 0) reg_part += ca.a_bp * mag;
            const float inv = mag > 0.0f ? 1.0f / fmaxf(mag, 1e-30f) : 0.0f;
            fin[2 * i] = re * inv;
            fin[2 * i + 1] = im * inv;
          }
          __syncthreads();
          for (long i = tid; i < (long)Kc * TB; i += NT) {
            const int k = (int)(i / TB), t = t0 + (int)(i % TB);
            const float* sp = fin + 2L * k * F;
            float acc = 0.0f;
            for (int f = 0; f < F; ++f)
              acc += sp[2 * f] * ca.dftct[(long)f * Tp + t]
                     - sp[2 * f + 1] * ca.dftst[(long)f * Tp + t];
            g[(long)k * Tp + t] += ca.a_bp * acc;
          }
        }
        tick(1);
        if (traj && ca.a_spd != 0.0f) {
          float tot = 0.0f;
          for (int b = 0; b < G; ++b) tot += *cluster_peer(slots + 1, b);
          const float VV = (float)(V * V);
          const float T1f = (float)(T + 1);
          const float ip3 = ca.spd_c0 + tot / VV;
          spd_term = ca.a_spd * 0.5f * (T1f - ip3) * (T1f - ip3);
          s_spd = -ca.a_spd * (T1f - ip3) * (2.0f / VV);
        }
      }
      if (traj) {
        // the direct cotangents D of the states after the live lanes
        for (long i = tid; i < (long)TB * V; i += NT) {
          const int tl = (int)(i / V), vv = (int)(i % V);
          if (t0 + tl < T)
            traj_cotangent<M>(ca, XL + (long)(tl + 1) * VEC + vv * MP,
                              target, N, V, vv, OV[2 * tl], OV[2 * tl + 1],
                              s_spd, DL + (long)(tl + 1) * VEC + vv * MP);
        }
        __syncthreads();
        // each team sums its segment's direct cotangents to its start
        for (int vv = 0; vv < V; ++vv)
          if (tm.rl) NU[vv * MP + tm.row] = 0.0f;
        for (int q = SG - 1; q >= 0; --q) {
          const int tl = lo + q;
          const bool live = live_lane(tl);
          float ar[M], ac[M];
          generator<M>(S, amp, sw, K, Tp, t0 + tl, live, tm.row, ar, ac);
          for (int vv = 0; vv < V; ++vv) {
            float* z = ts;   // the column being pulled back
            float d = NU[vv * MP + tm.row];
            if (live) d += DL[(long)(tl + 1) * VEC + vv * MP + tm.row];
            if (tm.rl) z[tm.row] = d;
            __syncwarp();
            team_series<M, 1>(ac, z, ts + MP, ts + 2 * MP, coef, nterms,
                              reps, tm);
            if (tm.rl) NU[vv * MP + tm.row] = z[tm.row];
            __syncwarp();
          }
        }
        for (int vv = 0; vv < V; ++vv)
          if (tm.rl)
            rtree[(long)tm.idx * VEC + vv * MP + tm.row] =
                NU[vv * MP + tm.row];
        __syncthreads();
        // up the tree: R = R_left + Q_left^T R_right
        long off = 0;
        for (int l = 0, cnt = nseg; l < levels; ++l, cnt >>= 1) {
          const long up = off + cnt;
          if (tm.idx < cnt / 2) {
            const float* Q = tree + (off + 2L * tm.idx) * MAT;
            const float* Rl = rtree + (off + 2L * tm.idx) * VEC;
            const float* Rr = rtree + (off + 2L * tm.idx + 1) * VEC;
            float qc[M];
            ld_col<M>(Q + tm.row * MP, qc);   // column `row` of Q
            for (int vv = 0; vv < V; ++vv) {
              float rv[M];
              ld_col<M>(Rr + vv * MP, rv);
              const float s = Rl[vv * MP + tm.row] + dot<M>(qc, rv);
              if (tm.rl) rtree[(up + tm.idx) * VEC + vv * MP + tm.row] = s;
            }
          }
          off = up;
          __syncthreads();
        }
        cluster_sync();   // every block's R is visible
        const float* rroot = rtree + (2L * nseg - 2) * VEC;
        for (long i = tid; i < (long)G * VEC; i += NT)
          RT[i] = *cluster_peer(rroot + i % VEC, (unsigned)(i / VEC));
        __syncthreads();
      }
    }
    if constexpr (kCosts) {   // the block's penalties, read after CS4
      const float rb = block_sum(reg_part, red);
      if (tid == 0) {
        slots[2] = rb;
        slots[5] = spd_term;
      }
    }
    tick(4);

    // ---- the reverse: nu at the block's end, then down the tree ----
    {
      float* Z = smem + geo.z0;
      float* Zn = smem + geo.z1;
      for (int i = tid; i < VEC; i += NT) Z[i] = FB[i];
      __syncthreads();
      for (int b = G - 1; b > rank; --b) {
        for (int i = tid; i < VEC; i += NT) {
          const int vv = i / MP, r = i % MP;
          float s = 0.0f;
          if (r < M) {
            for (int j = 0; j < M; ++j)
              s += CT[(long)b * MAT + r * MP + j] * Z[vv * MP + j];
            if (traj) s += RT[(long)b * VEC + i];
          }
          Zn[i] = s;
        }
        __syncthreads();
        float* tmp = Z;
        Z = Zn;
        Zn = tmp;
      }
      for (int i = tid; i < VEC; i += NT) NB[(long)nseg * VEC + i] = Z[i];
      __syncthreads();
    }
    for (int l = levels - 1; l >= 0; --l) {
      const int d = 1 << l;
      const long off = 2L * nseg - (2L * nseg >> l);
      if (tm.idx < nseg / (2 * d)) {
        const int a = 2 * d * tm.idx;
        const float* Q = tree + (off + 2L * tm.idx + 1) * MAT;
        const float* Rr = rtree + (off + 2L * tm.idx + 1) * VEC;
        float qc[M];
        ld_col<M>(Q + tm.row * MP, qc);   // column `row` of the right child
        for (int vv = 0; vv < V; ++vv) {
          float nv[M];
          ld_col<M>(NB + (long)(a + 2 * d) * VEC + vv * MP, nv);
          float s = dot<M>(qc, nv);
          if (traj) s += Rr[vv * MP + tm.row];
          if (tm.rl) NB[(long)(a + d) * VEC + vv * MP + tm.row] = s;
        }
      }
      __syncthreads();
    }
    tick(5);

    // ---- each team back through its segment: Abar rows, the gradient ----
    float gpart = 0.0f;
    {
      for (int vv = 0; vv < V; ++vv)
        if (tm.rl)
          NU[vv * MP + tm.row] =
              NB[(long)(tm.idx + 1) * VEC + vv * MP + tm.row];
      float* XR = ts;                      // rep inputs [reps][MP]
      float* PW = ts + (long)reps * MP;    // one rep's powers [nterms][MP]
      float* ACOL = PW + (long)(nterms + 2) * MP;   // lanes' A columns
      float* acol = ACOL + tm.lane * MP;
      for (int q = SG - 1; q >= 0; --q) {
        const int tl = lo + q;
        const int t = t0 + tl;
        const bool live = live_lane(tl);
        float ar[M];
        {
          float ac[M];
          generator<M>(S, amp, sw, K, Tp, t, live, tm.row, ar, ac);
#pragma unroll
          for (int j = 0; j < M; ++j) acol[j] = ac[j];   // read back below
        }
        float ab[M];
#pragma unroll
        for (int j = 0; j < M; ++j) ab[j] = 0.0f;
        for (int vv = 0; vv < V; ++vv) {
          float mu = NU[vv * MP + tm.row];
          if (traj && live) mu += DL[(long)(tl + 1) * VEC + vv * MP + tm.row];
          // the step's rep inputs, from the stored state
          if (tm.rl) XR[tm.row] = XL[(long)tl * VEC + vv * MP + tm.row];
          __syncwarp();
          for (int r = 0; r + 1 < reps; ++r) {
            if (tm.rl) XR[(r + 1) * MP + tm.row] = XR[r * MP + tm.row];
            __syncwarp();
            team_series<M, 1>(ar, XR + (r + 1) * MP, PW, PW + MP, coef,
                              nterms, 1, tm);
          }
          float pb_step = tm.rl ? mu : 0.0f;
          for (int r = reps - 1; r >= 0; --r) {
            // the rep's powers p_0 .. p_{nterms-1}
            if (tm.rl) PW[tm.row] = XR[r * MP + tm.row];
            __syncwarp();
            for (int n = 1; n < nterms; ++n) {
              float pv[M];
              ld_col<M>(PW + (n - 1) * MP, pv);
              const float y = dot<M>(ar, pv) * coef[n];
              if (tm.rl) PW[n * MP + tm.row] = y;
              __syncwarp();
            }
            // back through them: Abar += c_n pbar_n p_{n-1}^T, pbar_{n-1}
            // = pbar + c_n A^T pbar_n
            float pb = pb_step;
            for (int n = nterms - 1; n >= 1; --n) {
              float pv[M], pp[M];
#pragma unroll
              for (int i = 0; i < M; ++i)
                pv[i] = __shfl_sync(kFullMask, pb, i, L);
              ld_col<M>(PW + (n - 1) * MP, pp);
              const float cn = coef[n];
              const float own = cn * pb;   // this row's pbar_n
#pragma unroll
              for (int j = 0; j < M; ++j) ab[j] += own * pp[j];
              ld_col<M>(acol, pp);         // this row's column of A
              pb = pb_step + dot<M>(pp, pv) * cn;
            }
            pb_step = tm.rl ? pb : 0.0f;
            __syncwarp();   // PW is rewritten by the next rep
          }
          if (tm.rl) NU[vv * MP + tm.row] = pb_step;
        }
        // the weight cotangents <mats_k, Abar> and the gradient
        for (int k = 1; k < K; ++k) {
          const float* Sk = S + k * M * (M + 1);
          float part = 0.0f;
#pragma unroll
          for (int j = 0; j < M; ++j)
            part += Sk[tm.row * (M + 1) + j] * ab[j];
          const float wb = team_sum<L>(tm.rl ? part : 0.0f);
          if (tl < TB && tm.lane == (k - 1) % L) {
            const long idx = (long)(k - 1) * Tp + t;
            float gk = 0.0f;
            if (live) {
              if constexpr (kCosts) {
                gk = (wb * amp[k] + g[idx]) * cosf(u[idx]);
              } else {
                gk = (wb * amp[k]) * cosf(u[idx]);
              }
            }
            g[idx] = gk;
            gpart += gk * gk;
          }
        }
      }
    }
    __syncthreads();
    tick(6);

    // ---- grad^2, the penalties and the convergence test (cluster) ----
    {
      const float gb = block_sum(gpart, red);
      if (tid == 0) slots[0] = gb;
      cluster_sync();
      float gt = 0.0f, rt = 0.0f;
      for (int b = 0; b < G; ++b) {
        gt += *cluster_peer(slots, b);
        if constexpr (kCosts) rt += *cluster_peer(slots + 2, b);
      }
      g2 = 0.5f * gt;
      regloss = loss;
      if constexpr (kCosts) {
        regloss = loss + rt + slots[5];
        if (traj) regloss += ca.forb_c0;
      }
    }
    const bool converged = loss < c.conv_target || g2 < c.min_grad ||
                           itc >= c.max_iterations;
    done = done || converged;
    const float dof = done ? 0.0f : 1.0f;
    tick(7);

    // ---- Adam (bias-corrected), applied only while not done ----
    const float cnt = itc + 1.0f;
    const float bc1 = 1.0f - expf(cnt * c.log_b1);
    const float bc2 = 1.0f - expf(cnt * c.log_b2);
    for (long i = tid; i < (long)Kc * TB; i += NT) {
      const long idx = (i / TB) * Tp + t0 + i % TB;
      const float gk = g[idx], am = m[idx], av = v[idx], uu = u[idx];
      const float am_n = c.b1 * am + c.one_minus_b1 * gk;
      const float av_n = c.b2 * av + c.one_minus_b2 * (gk * gk);
      const float upd = (am_n / bc1) / (sqrtf(av_n / bc2) + c.eps);
      const float u_n = uu - lr * upd;
      u[idx] = uu + dof * (u_n - uu);
      m[idx] = am + dof * (am_n - am);
      v[idx] = av + dof * (av_n - av);
    }
    lr = lr * (done ? 1.0f : c.rate_factor);
    itc = itc + dof;
    tick(8);
    if (done) break;
  }
  // the last reads of the others' shared memory are done before a block
  // leaves
  cluster_sync();
  if (rank == 0 && tid == 0) {
    met[0] = loss;
    met[1] = g2;
    met[2] = uscale;
    met[3] = lr;
    met[4] = itc;
    met[5] = done ? 1.0f : 0.0f;
    met[6] = regloss;   // the fidelity-only objective has no penalty
    met[7] = 0.0f;
  }
}

// Host side: launch one segment on `stream` as one cluster; returns the
// launch's error (cudaErrorInvalidValue outside the kernel's bounds: V,
// or a shared memory over the limit at G = 16).
template <bool kCosts>
int launch_mega_segment(
    const float* mats, int K, int M, int N, int T, int Tp, int V, int order,
    int scaling, int n_iters, int unitary_mode, const float* psi0,
    const float* target, const float* maxamp, const float* u0rows, float* u,
    float* m, float* v, const float* sf_in, float* met, float* sw, float* g,
    long long* clocks, const AdamConsts& c, const CostArgs& ca,
    void* stream) {
  const bool traj = kCosts && ca.traj;
  if (V < 1 || V > (traj ? kMaxVTraj : kMaxV) || K < 1 || Tp < 2 ||
      (Tp & (Tp - 1)) || T > Tp || order < 0 || scaling < 0 || scaling > 20)
    return (int)cudaErrorInvalidValue;
  const MegaGeometry geo =
      mega_geometry(M, Tp, K, V, order, scaling, kCosts, traj);
  if (geo.G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)geo.total * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  QOC_DISPATCH_M(M, {
    auto kernel = mega_segment_kernel<kM, kCosts>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(geo.G);
    cfg.blockDim = dim3(geo.NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = geo.G;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, mats, K, N, T, Tp, V, order,
                             scaling, n_iters, unitary_mode, psi0, target,
                             maxamp, u0rows, u, m, v, sf_in, met, sw, g,
                             clocks, c, ca);
    if (err != cudaSuccess) return (int)err;
  });
  return (int)cudaGetLastError();
}

}  // namespace qoc

// The C entry points' operands (shared by mega.cu and mega_costs.cu).
#define QOC_MEGA_PARAMS                                                      \
  const float *mats, int K, int M, int N, int T, int Tp, int V, int order,   \
      int scaling, int n_iters, int unitary_mode, const float *psi0,         \
      const float *target, const float *maxamp, const float *u0rows,         \
      float *u, float *m, float *v, const float *sf_in, float *met,          \
      float *sw, float *g, long long *clocks, float b1, float b2,            \
      float one_minus_b1, float one_minus_b2, float eps, float log_b1,       \
      float log_b2, float rate_factor, float conv_target, float min_grad,    \
      float max_iterations
#define QOC_MEGA_ARGS(c_, ca_, stream_)                                      \
  mats, K, M, N, T, Tp, V, order, scaling, n_iters, unitary_mode, psi0,      \
      target, maxamp, u0rows, u, m, v, sf_in, met, sw, g, clocks, c_, ca_,   \
      stream_
#define QOC_ADAM_CONSTS                                                      \
  qoc::AdamConsts {                                                          \
    b1, b2, one_minus_b1, one_minus_b2, eps, log_b1, log_b2, rate_factor,    \
        conv_target, min_grad, max_iterations                                \
  }
