// Tree chain kernels 1-2 (launches and C entry points in tree_chain.cu):
// the chain product of per-step Taylor propagators and its exact gradient
// in the weights, one problem spread over a cluster of blocks in teams of
// lanes.
//
// Replaces qoc_tpu/ops/pallas_tree.py::_fwd_kernel / _fwd_call (kernel 1)
// and ::_bwd_kernel / _bwd_call (kernel 2):
//
//   E = P_{Tp-1} ... P_0,  P_t = (sum_{n <= order} B_t^n / n!)^(2^s),
//   B_t = A_t / 2^s,  A_t = sum_k w[k, t] mats_k,
//
// padded lanes (zero weights) being identities; the backward gives
// wbar[k, t] = <mats_k, Abar_t> for gbar = dL/dE.  An order below 1 keeps
// the first power all the same (tree_terms), as the plain version does.
//
// Work split (tree_geometry, mirrored by _cuda.tree_geometry).  The Tp
// lanes go to G blocks (a cluster in kernel 1), each owning TB = Tp / G
// contiguous lanes; a block is NT threads in `teams` teams of L =
// team_lanes(M) lanes (team.cuh), each team owning a segment of S = TB /
// teams lanes (S = 1, and segments past TB empty, where TB < teams).  Lane
// i of a team holds row i of every matrix the team works on; matrices sit
// in shared memory column-major (column stride MP = M rounded up to 4), so
// a thread keeps O(M) floats, never an M x M array.
//
// Forward (kernel 1).
//   1. Each team walks its segment from the identity: per step it forms
//      P_t by Horner on B_t (R <- I + B R / k, k = order .. 1) and s
//      squarings, (order - 1 + s) products, then X <- P_t X; the segment's
//      product Q_j is a leaf of the block's tree.  (Applying the series
//      to X's columns 2^s times, as kernel 3 does for its V columns, would
//      take 2^s order products a step.)
//   2. A pairwise tree over the block's leaves (later on the left) gives
//      the block's product C_b, a block barrier per level.
//   3. One cluster barrier; block 0 reads the G products through
//      distributed shared memory and walks each column of the identity
//      through them in rank order: E = C_{G-1} ... C_0.
//   Residuals: the leaves [G teams][M][M], then the block products
//   [G][M][M], in one buffer: about (Tp / S + G) M^2 floats, no Taylor
//   power, squaring or tree level of order M^2 Tp.
//
// Backward (kernel 2; G blocks, no cluster: the block products come from
// the residuals).  Pbar_t = nu_{t+1} X_t^T, with X_t = P_{t-1} ... P_0 the
// prefix and nu_{t+1} = (P_{Tp-1} ... P_{t+1})^T gbar:
//   1. the block rebuilds its tree from its leaves (the forward's bits);
//   2. its teams walk the columns of the identity through C_0 .. C_{b-1}
//      (the prefix at the block's start) and the columns of gbar back
//      through C_{G-1}^T .. C_{b+1}^T (nu at its end);
//   3. down the tree: the prefix at a right child's start is the left
//      child's product times the parent's; nu at a left child's end is the
//      right child's product, transposed, times the parent's;
//   4. each team walks its segment forward from its start prefix, keeping
//      each lane's prefix X_t in shared memory, then back from nu at its
//      end: per step it forms P_t again (Horner, squarings), Pbar_t =
//      nu_{t+1} X_t^T and nu_t = P_t^T nu_{t+1};
//   5. the Taylor reverse of step t: the squarings reversed, Ebar <- Ebar
//      E_j^T + E_j^T Ebar for j = s-1 .. 0, each pre-squaring E_j
//      recomputed from the Horner value E_0 (team scratch) by j squarings;
//      then Abar by Horner on the block-triangular form, as kernel 8 does
//      (expm.cuh): with X = B^T and G = Ebar, R12 <- (X R12 + G R11) / k
//      and R11 <- I + X R11 / k for k = order .. 1, so Abar = 2^-s R12 and
//      no Taylor power is stored; wbar[k, t] = <mats_k, Abar_t> by a team
//      sum.
//   No Hillis-Steele scan and no log2(Tp)-level tree over lanes.
//
// Every sum runs in a fixed order (dot products in index order, team
// butterflies, the cluster's products in rank order) and nothing is
// atomic, so a second launch repeats the bits.  The association differs
// from the plain version's pairwise tree by float32 rounding only.
//
// Bound.  The forward does (order + s) M^3 multiply-adds a step, the
// backward about (3 (order - 1 + s) + 3 + s (s - 1) / 2) M^3 (the prefix
// walk and the propagator formed twice, Pbar and nu, the two products of
// each squaring's reverse, three of each Horner step): far below the
// card's float32 rate on the G SMs it uses, so both are latency bound (a
// team's S serial steps of M-long FMA chains, a block barrier per tree
// level, the cluster barrier).  The only device memory traffic is the
// operands and the residuals above.

#pragma once

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "team.cuh"

namespace qoc {

constexpr int kTreeThreads = 512;       // most threads of a block
constexpr int kTreeMaxBlocks = 8;       // a portable cluster
constexpr int kTreeSmemMax = 232448;    // dynamic shared memory a block
// Phases of the optional clock64 counters (mirrored by
// _cuda.TREE_FWD_CLOCK_PHASES and TREE_BWD_CLOCK_PHASES).
constexpr int kTreeFwdPhases = 3;   // walks, block tree, cluster
constexpr int kTreeBwdPhases = 6;   // block tree, cluster, down the tree,
                                    // walks, reverse walks, Taylor reverse

// The series' last power: order, but at least 1 (the plain version's
// taylor_expm and qoc_tpu's taylor_step_vals always keep I + B).
__host__ __device__ constexpr int tree_terms(int order) {
  return order < 1 ? 1 : order;
}

// Most threads of a block: at most 64 teams, at most kTreeThreads.
__host__ __device__ constexpr int tree_max_threads(int M) {
  return 64 * team_lanes(M) < kTreeThreads ? 64 * team_lanes(M)
                                           : kTreeThreads;
}

// Launch geometry and the shared-memory layouts of both kernels (offsets
// in floats from the dynamic buffer; mirrored by _cuda.tree_geometry).
struct TreeGeometry {
  int G, NT, L, teams, TB, S;
  long mat;                          // floats of a matrix, M * mega_mp(M)
  long smats, coef;                  // both kernels
  long tree, ct, team, total_fwd;    // kernel 1
  long xl, nb, u, total_bwd;         // kernel 2 (tree, ct and team scratch
                                     // share u)
};

constexpr int kTreeTeamMats = 3;    // kernel 2's team scratch: E0, R, Ebar

// cap: the most threads (a power of two >= 32).
__host__ __device__ inline TreeGeometry tree_layout(int G, int M, int Tp,
                                                    int K, int order,
                                                    int cap) {
  TreeGeometry g;
  g.G = G;
  g.L = team_lanes(M);
  g.TB = Tp / G;
  long nt = (long)g.TB * g.L;   // a team per lane, at most cap threads
  nt = nt < 32 ? 32 : nt > cap ? cap : nt;
  g.NT = (int)nt;
  g.teams = g.NT / g.L;
  g.S = g.TB > g.teams ? g.TB / g.teams : 1;
  g.mat = (long)M * mega_mp(M);
  const long tnodes = 2L * g.teams - 1;
  long o = 0;
  g.smats = o; o += ((long)K * M * (M + 1) + 3) & ~3L;
  g.coef = o;  o += ((long)order + 1 + 3) & ~3L;
  const long base = o;
  g.tree = o;  o += tnodes * g.mat;
  g.ct = o;    o += (long)G * g.mat;
  g.team = o;  o += (long)g.teams * g.mat;
  g.total_fwd = o;
  o = base;
  g.xl = o;    o += (long)g.teams * g.S * g.mat;
  g.nb = o;    o += (long)(g.teams + 1) * g.mat;
  g.u = o;
  const long ut = (tnodes + G) * g.mat;
  const long us = (long)g.teams * kTreeTeamMats * g.mat;
  o += ut > us ? ut : us;
  g.total_bwd = o;
  return g;
}

// The rule: G = Tp / 32 blocks, between 1 and 8, of at most
// tree_max_threads(M) threads; where kernel 2's shared memory (the larger)
// would not fit, half the threads, down to one warp; G = 0 where nothing
// fits.
__host__ __device__ inline TreeGeometry tree_geometry(int M, int Tp, int K,
                                                      int order) {
  int G = Tp / 32;
  G = G < 1 ? 1 : G > kTreeMaxBlocks ? kTreeMaxBlocks : G;
  int cap = tree_max_threads(M);
  TreeGeometry g = tree_layout(G, M, Tp, K, order, cap);
  while (g.total_bwd * 4 > kTreeSmemMax && cap > 32) {
    cap /= 2;
    g = tree_layout(G, M, Tp, K, order, cap);
  }
  if (g.total_bwd * 4 > kTreeSmemMax) g.G = 0;
  return g;
}

// Thread 0's clock64 cycles per phase, added to clocks[phase] (null: off).
struct TreeClock {
  long long* c;
  long long t;
  __device__ __forceinline__ void tick(int phase) {
    if (c != nullptr) {
      const long long now = clock64();
      if (phase >= 0) c[phase] += now - t;
      t = now;
    }
  }
};

// ---- team helpers (lane i: row i; matrices column-major, stride MP) ------

// The lane's row of B_t = A_t * scale (b) and its column (bc), from the
// generators S [K][M][M + 1] in shared memory and the weights w [K][Tp].
// (Kernel 3's `generator` weights the drift by the lane's liveness; here
// every row of w is a weight.)
template <int M>
__device__ __forceinline__ void tree_generator(const float* S,
                                               const float* w, int K, int Tp,
                                               int t, float scale, int row,
                                               float (&b)[M], float (&bc)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    b[j] = 0.0f;
    bc[j] = 0.0f;
  }
  for (int k = 0; k < K; ++k) {
    const float wk = __ldg(w + (long)k * Tp + t) * scale;
    const float* Sk = S + k * M * (M + 1);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      b[j] += Sk[row * (M + 1) + j] * wk;
      bc[j] += Sk[j * (M + 1) + row] * wk;
    }
  }
}

// v[j] = row r of the column-major matrix p (a strided read; the lanes of
// a team read the same addresses).
template <int M>
__device__ __forceinline__ void ld_row(const float* p, int r, float (&v)[M]) {
  constexpr int MP = mega_mp(M);
#pragma unroll
  for (int j = 0; j < M; ++j) v[j] = p[j * MP + r];
}

// y[c] = a . B[:, c]: the lane's row of (the matrix whose row is a) B.
template <int M>
__device__ __forceinline__ void row_times(const float (&a)[M], const float* B,
                                          float (&y)[M]) {
  constexpr int MP = mega_mp(M);
#pragma unroll
  for (int c = 0; c < M; ++c) {
    float v[M];
    ld_col<M>(B + c * MP, v);
    y[c] = dot<M>(a, v);
  }
}

// The lane's row y into the column-major matrix C.
template <int M>
__device__ __forceinline__ void st_row(float* C, const float (&y)[M],
                                       const Team& tm) {
  constexpr int MP = mega_mp(M);
  if (tm.rl) {
#pragma unroll
    for (int c = 0; c < M; ++c) C[c * MP + tm.row] = y[c];
  }
}

// C <- (row a) B in place or not (C may be B): every lane of the warp
// calls it (full-mask warp barriers); y returns the lane's row.
template <int M>
__device__ __forceinline__ void team_mul(const float (&a)[M], const float* B,
                                         float* C, const Team& tm,
                                         float (&y)[M]) {
  row_times<M>(a, B, y);
  __syncwarp();
  st_row<M>(C, y, tm);
  __syncwarp();
}

// H <- sum_{n <= terms} B^n / n! by Horner (inv[k] = 1 / k), then R <- H^(2^s)
// by s squarings in place (R may be H, and is where s = 0 leaves H); pr:
// the lane's row of the result.  Every lane of the warp calls it.
template <int M>
__device__ __forceinline__ void team_propagator(const float (&b)[M], float* H,
                                                float* R, const float* inv,
                                                int terms, int scaling,
                                                const Team& tm,
                                                float (&pr)[M]) {
  const float c0 = inv[terms];
#pragma unroll
  for (int c = 0; c < M; ++c) pr[c] = (c == tm.row ? 1.0f : 0.0f) + b[c] * c0;
  st_row<M>(H, pr, tm);
  __syncwarp();
  for (int k = terms - 1; k >= 1; --k) {
    const float ck = inv[k];
    row_times<M>(b, H, pr);
#pragma unroll
    for (int c = 0; c < M; ++c) pr[c] = (c == tm.row ? 1.0f : 0.0f) + pr[c] * ck;
    __syncwarp();
    st_row<M>(H, pr, tm);
    __syncwarp();
  }
  if (scaling > 0 && R != H) {
    st_row<M>(R, pr, tm);
    __syncwarp();
  }
  for (int j = 0; j < scaling; ++j) {
    float y[M];
    team_mul<M>(pr, R, R, tm, y);
#pragma unroll
    for (int c = 0; c < M; ++c) pr[c] = y[c];
  }
}

// Column chains through the block products CT [G][mat] in shared memory:
// chain c < M walks column c of the identity through C_0 .. C_{n-1}
// (the prefix C_{n-1} ... C_0, into column c of X); chain M + c walks
// column c of g (row-major [M][M] in device memory, null: none) back
// through C_{G-1}^T .. C_{m+1}^T (into column c of N).  The chains go to
// the block's teams in turn; every lane of the block calls it.
template <int M>
__device__ __forceinline__ void block_chains(const float* CT, int G, int n,
                                             int m, const float* g, float* X,
                                             float* N, int teams,
                                             const Team& tm) {
  constexpr int MP = mega_mp(M);
  constexpr int L = team_lanes(M);
  const long mat = (long)M * MP;
  const int nch = g != nullptr ? 2 * M : M;
  for (int base = 0; base < nch; base += teams) {
    const int ch = base + tm.idx;
    const bool fwd = ch < M;
    const int c = fwd ? ch : ch < nch ? ch - M : 0;
    float x = fwd ? (tm.row == c ? 1.0f : 0.0f)
                  : (ch < nch ? g[tm.row * M + c] : 0.0f);
    for (int q = 0; q + 1 < G || q < n; ++q) {
      float xv[M];
#pragma unroll
      for (int j = 0; j < M; ++j) xv[j] = __shfl_sync(kFullMask, x, j, L);
      if (fwd) {
        if (q < n) {
          const float* C = CT + q * mat;
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j < M; ++j) y += C[j * MP + tm.row] * xv[j];
          x = y;
        }
      } else {
        const int bq = G - 1 - q;
        if (bq > m) {
          float cv[M];
          ld_col<M>(CT + bq * mat + tm.row * MP, cv);
          x = dot<M>(cv, xv);
        }
      }
    }
    if (tm.rl && ch < nch) (fwd ? X : N)[c * MP + tm.row] = x;
  }
}

}  // namespace qoc
