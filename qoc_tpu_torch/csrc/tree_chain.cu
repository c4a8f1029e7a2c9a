// Tree chain kernels: the full chain product of per-step Taylor
// propagators (kernel 1, one cluster of blocks) and its exact gradient in
// the weights (kernel 2), with their C entry points, which
// qoc_tpu_torch/ops/_cuda.py loads with ctypes.
//
// Replace qoc_tpu/ops/pallas_tree.py::_fwd_kernel / _fwd_call (kernel 1)
// and ::_bwd_kernel / _bwd_call (kernel 2).  The design, the association
// and the bound are in tree_chain.cuh.

#include <cuda_runtime.h>

#include "tree_chain.cuh"

namespace qoc {

// mats [K][M][M] -> S [K][M][M + 1] and inv[k] = 1 / k (k = 1..terms), by
// the block's threads.
template <int M>
__device__ __forceinline__ void tree_stage(const float* mats, int K,
                                           int terms, float* S, float* inv) {
  for (long i = threadIdx.x; i < (long)K * M * (M + 1); i += blockDim.x) {
    const int k = (int)(i / (M * (M + 1))), r = (int)(i % (M * (M + 1)));
    const int ii = r / (M + 1), jj = r % (M + 1);
    S[i] = jj < M ? mats[((long)k * M + ii) * M + jj] : 0.0f;
  }
  for (int k = threadIdx.x; k <= terms; k += blockDim.x)
    inv[k] = k ? (float)(1.0 / (double)k) : 0.0f;
}

// Up the block's tree: node (l+1, j) = node (l, 2j+1) node (l, 2j), over
// nseg leaves at `tree`; a block barrier per level.
template <int M>
__device__ __forceinline__ void tree_up(float* tree, int nseg, long mat,
                                        const Team& tm) {
  long off = 0;   // level l's first node
  for (int cnt = nseg; cnt > 1; cnt >>= 1) {
    const long up = off + cnt;
    if (tm.idx < cnt / 2) {
      float ar[M], y[M];
      ld_row<M>(tree + (off + 2L * tm.idx + 1) * mat, tm.row, ar);
      row_times<M>(ar, tree + (off + 2L * tm.idx) * mat, y);
      st_row<M>(tree + (up + tm.idx) * mat, y, tm);
    }
    off = up;
    __syncthreads();
  }
}

// mats [K][M][M], w [K][Tp] -> E [M][M] = P_{Tp-1} ... P_0 and the
// residuals res [G teams + G][M][M]: each segment's product, then each
// block's.  clocks (null unless asked for): [G][kTreeFwdPhases]
// int64, to which thread 0 of each block adds its clock64 cycles per
// phase.  Launched as one cluster of tree_geometry(...).G blocks.
template <int M>
__global__ void __launch_bounds__(tree_max_threads(M), 1)
tree_forward_kernel(const float* __restrict__ mats,
                    const float* __restrict__ w, int K, int Tp, int order,
                    int scaling, float* __restrict__ E,
                    float* __restrict__ res, long long* __restrict__ clocks) {
  constexpr int MP = mega_mp(M);
  constexpr int L = team_lanes(M);
  constexpr int MM = M * M;
  extern __shared__ __align__(16) float smem[];
  const int G = (int)cluster_blocks();
  const int rank = (int)cluster_rank();
  const TreeGeometry geo = tree_layout(G, M, Tp, K, order, blockDim.x);
  float* seg = res;                                   // [G teams][M][M]
  float* blk = res + (long)G * geo.teams * MM;        // [G][M][M]
  const long mat = geo.mat;
  float* S = smem + geo.smats;
  float* inv = smem + geo.coef;
  float* tree = smem + geo.tree;
  float* CT = smem + geo.ct;
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int TB = geo.TB, SG = geo.S, nseg = geo.teams;
  const int t0 = rank * TB;
  const int terms = tree_terms(order);
  const float scale = ldexpf(1.0f, -scaling);
  TreeClock clk{tid == 0 && clocks != nullptr
                    ? clocks + (long)rank * kTreeFwdPhases
                    : nullptr,
                0};
  clk.tick(-1);

  tree_stage<M>(mats, K, terms, S, inv);
  Team tm;
  tm.idx = tid / L;
  tm.lane = tid % L;
  tm.row = tm.lane < M ? tm.lane : M - 1;
  tm.rl = tm.lane < M;
  float* R = smem + geo.team + tm.idx * mat;   // the team's P_t
  float* X = tree + tm.idx * mat;              // its segment's product
  const int lo = tm.idx * SG;
  {
    float ir[M];
#pragma unroll
    for (int c = 0; c < M; ++c) ir[c] = c == tm.row ? 1.0f : 0.0f;
    st_row<M>(X, ir, tm);
  }
  __syncthreads();

  // ---- each team's segment product, walked from the identity ----
  for (int q = 0; q < SG; ++q) {
    const int tl = lo + q;
    float b[M], bc[M], pr[M], y[M];
    if (tl < TB) {
      tree_generator<M>(S, w, K, Tp, t0 + tl, scale, tm.row, b, bc);
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) b[j] = 0.0f;   // an empty lane: P = I
    }
    team_propagator<M>(b, R, R, inv, terms, scaling, tm, pr);
    team_mul<M>(pr, X, X, tm, y);
  }
  if (tm.rl) {
    float* out = seg + ((long)rank * nseg + tm.idx) * MM + tm.row * M;
#pragma unroll
    for (int c = 0; c < M; ++c) out[c] = X[c * MP + tm.row];
  }
  __syncthreads();
  clk.tick(0);

  // ---- the block's product ----
  tree_up<M>(tree, nseg, mat, tm);
  const float* root = tree + (2L * nseg - 2) * mat;
  for (int i = tid; i < MM; i += NT)
    blk[(long)rank * MM + i] = root[(i % M) * MP + i / M];
  clk.tick(1);

  // ---- the cluster: E = C_{G-1} ... C_0, walked by block 0 ----
  cluster_sync();   // every block's product is visible
  if (rank == 0)
    for (long i = tid; i < (long)G * mat; i += NT)
      CT[i] = *cluster_peer(root + i % mat, (unsigned)(i / mat));
  cluster_sync();   // the peers' shared memory is read: they may leave
  if (rank == 0) {
    block_chains<M>(CT, G, G, 0, nullptr, tree, nullptr, nseg, tm);
    __syncthreads();
    for (int i = tid; i < MM; i += NT) E[i] = tree[(i % M) * MP + i / M];
  }
  clk.tick(2);
}

// The forward's operands and residuals, and gbar [M][M] (the cotangent of
// E) -> wbar [K][Tp].  clocks: [G][kTreeBwdPhases] or null.  G blocks (no
// cluster: the block products come from the residuals).
template <int M>
__global__ void __launch_bounds__(tree_max_threads(M), 1)
tree_backward_kernel(const float* __restrict__ mats,
                     const float* __restrict__ w, int K, int Tp, int order,
                     int scaling, const float* __restrict__ res,
                     const float* __restrict__ gbar, float* __restrict__ wbar,
                     long long* __restrict__ clocks) {
  constexpr int MP = mega_mp(M);
  constexpr int L = team_lanes(M);
  extern __shared__ __align__(16) float smem[];
  const int G = gridDim.x;
  const int rank = blockIdx.x;
  const TreeGeometry geo = tree_layout(G, M, Tp, K, order, blockDim.x);
  const float* seg = res;
  const float* blk = res + (long)G * geo.teams * M * M;
  const long mat = geo.mat;
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int TB = geo.TB, SG = geo.S, nseg = geo.teams;
  const int t0 = rank * TB;
  const int levels = 31 - __clz(nseg);
  const int terms = tree_terms(order);
  const float scale = ldexpf(1.0f, -scaling);
  float* S = smem + geo.smats;
  float* inv = smem + geo.coef;
  float* XL = smem + geo.xl;   // the prefix X_t at each lane
  float* NB = smem + geo.nb;   // nu at each segment's start (and the end)
  float* tree = smem + geo.u;
  float* CT = tree + (2L * nseg - 1) * mat;
  TreeClock clk{tid == 0 && clocks != nullptr
                    ? clocks + (long)rank * kTreeBwdPhases
                    : nullptr,
                0};
  clk.tick(-1);

  tree_stage<M>(mats, K, terms, S, inv);
  for (long i = tid; i < (long)nseg * mat; i += NT) {
    const long j = i / mat;
    const int e = (int)(i % mat), r = e % MP, c = e / MP;
    tree[i] = r < M ? seg[(((long)rank * nseg + j) * M + r) * M + c] : 0.0f;
  }
  for (long i = tid; i < (long)G * mat; i += NT) {
    const long b = i / mat;
    const int e = (int)(i % mat), r = e % MP, c = e / MP;
    CT[i] = r < M ? blk[(b * M + r) * M + c] : 0.0f;
  }
  Team tm;
  tm.idx = tid / L;
  tm.lane = tid % L;
  tm.row = tm.lane < M ? tm.lane : M - 1;
  tm.rl = tm.lane < M;
  const int lo = tm.idx * SG;
  __syncthreads();
  tree_up<M>(tree, nseg, mat, tm);
  clk.tick(0);

  // ---- the prefix at the block's start, nu at its end ----
  block_chains<M>(CT, G, rank, rank, gbar, XL, NB + (long)nseg * mat, nseg,
                  tm);
  __syncthreads();
  clk.tick(1);

  // ---- down the tree: prefixes at the segment starts, nu at their ends --
  for (int l = levels - 1; l >= 0; --l) {
    const int d = 1 << l;
    const long off = 2L * nseg - (2L * nseg >> l);   // level l's first node
    if (tm.idx < nseg / (2 * d)) {
      const int a = 2 * d * tm.idx;
      float ar[M], y[M];
      ld_row<M>(tree + (off + 2L * tm.idx) * mat, tm.row, ar);
      row_times<M>(ar, XL + (long)a * SG * mat, y);
      st_row<M>(XL + (long)(a + d) * SG * mat, y, tm);
      ld_col<M>(tree + (off + 2L * tm.idx + 1) * mat + tm.row * MP, ar);
      row_times<M>(ar, NB + (long)(a + 2 * d) * mat, y);
      st_row<M>(NB + (long)(a + d) * mat, y, tm);
    }
    __syncthreads();
  }
  clk.tick(2);

  // the team's scratch (over the tree, which is no longer read): the
  // Horner value E_0, P_t or E_j, and Ebar
  float* E0 = smem + geo.u + (long)tm.idx * kTreeTeamMats * mat;
  float* R = E0 + mat;
  float* GB = R + mat;

  // ---- each team's prefixes through its segment ----
  for (int q = 0; q + 1 < SG; ++q) {
    const int tl = lo + q;
    float b[M], bc[M], pr[M], y[M];
    if (tl < TB) {
      tree_generator<M>(S, w, K, Tp, t0 + tl, scale, tm.row, b, bc);
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) b[j] = 0.0f;
    }
    team_propagator<M>(b, R, R, inv, terms, scaling, tm, pr);
    team_mul<M>(pr, XL + (long)tl * mat, XL + (long)(tl + 1) * mat, tm, y);
  }
  clk.tick(3);

  // ---- back through the segment: Pbar_t, nu_t and the Taylor reverse ----
  float* NU = NB + (long)(tm.idx + 1) * mat;   // nu, updated in place
  float nr[M];
  ld_row<M>(NU, tm.row, nr);
  for (int q = SG - 1; q >= 0; --q) {
    const int tl = lo + q;
    const bool real = tl < TB;
    float b[M], bc[M], gb[M], y[M];
    if (real) {
      tree_generator<M>(S, w, K, Tp, t0 + tl, scale, tm.row, b, bc);
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        b[j] = 0.0f;
        bc[j] = 0.0f;
      }
    }
    {
      float pr[M];
      team_propagator<M>(b, E0, R, inv, terms, scaling, tm, pr);
    }
    const float* P = scaling ? R : E0;
    // Pbar_t = nu_{t+1} X_t^T
    const float* Xt = XL + (long)tl * mat;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      float xr[M];
      ld_row<M>(Xt, c, xr);
      gb[c] = dot<M>(nr, xr);
    }
    st_row<M>(GB, gb, tm);
    if (q > 0) {   // nu_t = P_t^T nu_{t+1}
      float pc[M];
      ld_col<M>(P + tm.row * MP, pc);
      team_mul<M>(pc, NU, NU, tm, nr);
    } else {
      __syncwarp();
    }
    clk.tick(4);

    // the squarings reversed: Ebar <- Ebar E_j^T + E_j^T Ebar
    for (int j = scaling - 1; j >= 0; --j) {
      const float* Ej = E0;
      if (j > 0) {   // E_j = E_0^(2^j), recomputed in R
        float er[M];
        ld_row<M>(E0, tm.row, er);
        st_row<M>(R, er, tm);
        __syncwarp();
        for (int i = 0; i < j; ++i) {
          team_mul<M>(er, R, R, tm, y);
#pragma unroll
          for (int c = 0; c < M; ++c) er[c] = y[c];
        }
        Ej = R;
      }
      float ec[M];
      ld_col<M>(Ej + tm.row * MP, ec);
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float er[M], gv[M];
        ld_row<M>(Ej, c, er);
        ld_col<M>(GB + c * MP, gv);
        y[c] = dot<M>(gb, er) + dot<M>(ec, gv);
      }
      __syncwarp();
      st_row<M>(GB, y, tm);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < M; ++c) gb[c] = y[c];
    }
    // Horner on [[X, G], [0, X]], X = B^T (the lane's row: bc), G = Ebar
    // (gb): R12 in E0, R11 in R
    float r12[M];
    {
      const float co = inv[terms];
      float r11[M];
#pragma unroll
      for (int c = 0; c < M; ++c) {
        r12[c] = gb[c] * co;
        r11[c] = (c == tm.row ? 1.0f : 0.0f) + bc[c] * co;
      }
      st_row<M>(E0, r12, tm);
      st_row<M>(R, r11, tm);
      __syncwarp();
      for (int k = terms - 1; k >= 1; --k) {
        const float ck = inv[k];
#pragma unroll
        for (int c = 0; c < M; ++c) {
          float v12[M], v11[M];
          ld_col<M>(E0 + c * MP, v12);
          ld_col<M>(R + c * MP, v11);
          r12[c] = (dot<M>(bc, v12) + dot<M>(gb, v11)) * ck;
          r11[c] = (c == tm.row ? 1.0f : 0.0f) + dot<M>(bc, v11) * ck;
        }
        __syncwarp();
        st_row<M>(E0, r12, tm);
        st_row<M>(R, r11, tm);
        __syncwarp();
      }
    }
    // wbar[k, t] = <mats_k, Abar_t>, Abar = 2^-s R12
    for (int k = 0; k < K; ++k) {
      const float* Sk = S + k * M * (M + 1);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) part += Sk[tm.row * (M + 1) + j] * r12[j];
      const float wb = team_sum<L>(tm.rl ? part * scale : 0.0f);
      if (real && tm.lane == k % L) wbar[(long)k * Tp + t0 + tl] = wb;
    }
    clk.tick(5);
  }
}

}  // namespace qoc

// ---- host launchers (plain C interface) ----------------------------------

namespace {

bool tree_args_ok(int K, int Tp, int order, int scaling) {
  return K >= 1 && Tp >= 2 && !(Tp & (Tp - 1)) && order >= 0 &&
         scaling >= 0 && scaling <= 30;
}

}  // namespace

// One cluster of tree_geometry(...).G blocks on `stream`; returns the
// launch's error (cudaErrorInvalidValue outside the kernels' bounds).
extern "C" int qoc_tree_forward(const float* mats, const float* w, int K,
                                int M, int Tp, int order, int scaling,
                                float* E, float* res, long long* clocks,
                                void* stream) {
  if (!tree_args_ok(K, Tp, order, scaling)) return (int)cudaErrorInvalidValue;
  const qoc::TreeGeometry geo = qoc::tree_geometry(M, Tp, K, order);
  if (geo.G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)geo.total_fwd * sizeof(float);
  QOC_DISPATCH_M(M, {
    auto kernel = qoc::tree_forward_kernel<kM>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(geo.G);
    cfg.blockDim = dim3(geo.NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = geo.G;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, mats, w, K, Tp, order, scaling, E,
                             res, clocks);
    if (err != cudaSuccess) return (int)err;
  });
  return (int)cudaGetLastError();
}

// G blocks of the same geometry on `stream`.
extern "C" int qoc_tree_backward(const float* mats, const float* w, int K,
                                 int M, int Tp, int order, int scaling,
                                 const float* res, const float* gbar,
                                 float* wbar, long long* clocks,
                                 void* stream) {
  if (!tree_args_ok(K, Tp, order, scaling)) return (int)cudaErrorInvalidValue;
  const qoc::TreeGeometry geo = qoc::tree_geometry(M, Tp, K, order);
  if (geo.G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)geo.total_bwd * sizeof(float);
  QOC_DISPATCH_M(M, {
    auto kernel = qoc::tree_backward_kernel<kM>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<geo.G, geo.NT, smem, (cudaStream_t)stream>>>(
        mats, w, K, Tp, order, scaling, res, gbar, wbar, clocks);
  });
  return (int)cudaGetLastError();
}

extern "C" const char* qoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
