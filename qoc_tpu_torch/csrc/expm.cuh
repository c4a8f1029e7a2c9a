// Batched truncated Taylor exponential and its exact reverse (kernels 7
// and 8; launches and C entry points in expm.cu).
//
// Replaces qoc_tpu/ops/pallas_expm.py::_fwd_kernel / _bwd_kernel behind
// _call.  Same function as the port's taylor_expm (and qoc_tpu's):
//
//   E_t = (sum_{n <= order} (A_t / 2^s)^n / n!)^(2^s),  A^n = A A^(n-1)
//
// Bound.  Both kernels are chains of dependent M x M products per
// timestep (config 4: M = 120, order 14, s = 0: 13 forward products and 38
// backward ones of 1.7 M FMAs each) against 2-3 M^2 floats of input and
// output: compute-bound in float32 FMAs.  No tensor cores: the only
// float32 path of wgmma is TF32, which the port forbids.  So the design
// keeps operands on chip, keeps enough warps per SM to hide the latency of
// shared memory, and feeds the FMA pipe with few shared-memory loads per
// FMA.
//
// Products.  A thread owns an 8 x 8 register tile (8 x 4 in kernel 8's
// shared path): rows i0..i0+3 and h+i0..h+i0+3, columns likewise (h = M/2
// on the shared path, 64 in a 128 x 128 macro tile on the staged path), so
// that per step of the reduction it loads four float4 (two of the left
// operand's column k, two of the right operand's row k) for 64 FMAs, and
// the lanes of a warp read neighbouring addresses.  The left operand is
// always read from its transpose (L^T[k][i] contiguous in i); transposed
// operands are transposed once, where they are written or staged, so the
// inner loop is one loop.  Both series run by Horner from the top term,
// which needs no power of A and no running sum:
//
//   p(B) = I + B (I + B/2 (... (I + B/order))),  R <- I + B R / k.
//
// Shared path (M <= kExpmSharedMaxM = 120, one block per timestep).
//   Kernel 7 keeps (A/2^s)^T and R in 2 M^2 floats (115 KB at M = 120), so
//   two blocks share an SM (128 registers a thread); a new R is computed
//   into registers and stored in place after a barrier.  Squarings write
//   R^T over the left operand and square the same way.
//   Kernel 8 (s = 0) keeps no power of A either.  With X = A^T and G =
//   Ebar, the cotangent of A is the upper-right block of p([[X, G], [0,
//   X]]): R12 <- (X R12 + G R11) / k with the old R11, then R11 <- I + X
//   R11 / k, for k = order .. 1.  Its live set is four M^2 floats (A, G^T,
//   R11, R12: 230 KB at M = 120, one block per SM), so its 512-thread
//   block takes 8 x 4 tiles and accumulates both new tiles together (96
//   FMAs per six float4 loads).  It reads A and Ebar, writes Abar and
//   takes no scratch.
//
// Staged path (kernel 7 above M = 120; kernel 8 above M = 120 or with s >
// 0).  The chain's matrices live in a device scratch sized by the resident
// grid (at most kExpmMaxGrid blocks, two per SM, walking the timesteps),
// never by T.  Every product is tiled: 128 x 128 macro tiles, the
// reduction in slices of kSlice = 32 staged through a double-buffered
// shared-memory ring filled with cp.async (16-byte copies where the staged
// layout is the stored one, 4-byte copies that transpose otherwise).
// While T leaves resident blocks idle, a cluster of up to 8 blocks shares
// each timestep: its blocks split the macro tiles and meet at cluster
// barriers.  Kernel 8 with s > 0 recomputes the s pre-squaring E's with
// the forward's series into that scratch, reverses the squarings (Ebar <-
// Ebar Es^T + Es^T Ebar, one product of depth 2M), then runs the same
// Horner recurrence.

#pragma once

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace qoc {

constexpr int kExpmThreads = 256;         // kernel 7 and the staged path
constexpr int kExpmBackwardThreads = 512; // kernel 8's shared path
// the largest M whose four shared-path buffers of kernel 8 fit the 227 KB
// (232448 B) of dynamic shared memory a block may take: 4 * 120^2 * 4 B
constexpr int kExpmSharedMaxM = 120;
// resident blocks of the staged path: two per SM of an H100 SXM
constexpr int kExpmMaxGrid = 2 * 132;
constexpr int kTile = 128;                     // staged macro tile
constexpr int kSlice = 32;                     // staged reduction slice
constexpr int kLd = kTile + 4;                 // staged row stride
constexpr int kStage = 2 * kSlice * kLd;       // floats of one ring stage
constexpr int kStagedSmemBytes = 2 * kStage * (int)sizeof(float);
constexpr int kForwardSlots = 3;               // A and two work buffers
constexpr int kBackwardSlots = 5;              // A and four work buffers

// Threads of a shared-path block: one per 8 x NC tile (NC = 8 for kernel
// 7, 4 for kernel 8), in whole warps.
__host__ __device__ inline int expm_shared_threads(int M, int NC) {
  const int tiles = (M / 8) * (M / NC);
  return (tiles + 31) / 32 * 32;
}

__host__ __device__ inline bool expm_forward_shared(int M) {
  return M <= kExpmSharedMaxM;
}

__host__ __device__ inline bool expm_backward_shared(int M, int scaling) {
  return M <= kExpmSharedMaxM && scaling == 0;
}

// Blocks of a launch: one per timestep on the shared path (no scratch);
// on the staged path one cluster of expm_cluster(T, M) blocks per
// timestep, at most kExpmMaxGrid blocks.
__host__ __device__ inline int expm_grid(int T, bool shared) {
  return shared || T < kExpmMaxGrid ? T : kExpmMaxGrid;
}

// Blocks per timestep on the staged path: more than one (a power of two,
// at most 8 and at most the macro tiles of a product) only while the
// timesteps alone leave resident blocks idle.
__host__ __device__ inline int expm_cluster(int T, int M) {
  const int nb = (M + kTile - 1) / kTile;
  int c = 1;
  while (2 * c <= 8 && 2 * c <= nb * nb && 2 * c * T <= kExpmMaxGrid) c *= 2;
  return c;
}

// Floats of device scratch a launch needs (0 on the shared path): slots
// of M x M per resident block, independent of T once T >= kExpmMaxGrid.
__host__ __device__ inline long expm_scratch_floats(int T, int M,
                                                    int scaling,
                                                    bool backward) {
  const bool shared = backward ? expm_backward_shared(M, scaling)
                               : expm_forward_shared(M);
  if (shared) return 0;
  const int slots = backward ? kBackwardSlots + scaling : kForwardSlots;
  return (long)expm_grid(T, false) * slots * M * M;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a b^T for a = (a0, a1), b = (b0, b1): 64 FMAs from registers
__device__ __forceinline__ void outer8(const float4 a0, const float4 a1,
                                       const float4 b0, const float4 b1,
                                       float (&acc)[8][8]) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// f(i, j, acc[r][c]) for each in-range element of a thread's 8 x 8 tile:
// rows ib + {0..3} and ib + h + {0..3}, columns likewise from jb.
template <class F>
__device__ __forceinline__ void each_out(const float (&acc)[8][8], int ib,
                                         int jb, int h, int M, F f) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ib + (r < 4 ? 0 : h) + (r & 3);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = jb + (c < 4 ? 0 : h) + (c & 3);
      if (i < M && j < M) f(i, j, acc[r][c]);
    }
  }
}

// ---- shared path ----------------------------------------------------------

// A thread's 8 x NC tile on the shared path: rows i0.., h+i0..; columns
// j0.. and, for NC = 8, h+j0..  (M/8) x (M/NC) threads.
struct Owner {
  int i0, j0, h;
  bool active;
};

template <int NC>
__device__ __forceinline__ Owner shared_owner(int M) {
  const int tpc = M / NC;   // threads along a row of tiles
  const int tid = threadIdx.x;
  return Owner{4 * (tid / tpc), 4 * (tid % tpc), M / 2,
               tid < (M / 8) * tpc};
}

// Row r of a thread's tile, and column c of an 8- or 4-column tile.
__device__ __forceinline__ int tile_row(const Owner& o, int r) {
  return o.i0 + (r < 4 ? 0 : o.h) + (r & 3);
}

template <int NC>
__device__ __forceinline__ int tile_col(const Owner& o, int c) {
  return o.j0 + (NC == 8 && c >= 4 ? o.h : 0) + (c & 3);
}

// acc += L R over the full depth M; LT = L^T and R row-major, in shared
// memory.  The next step's operands are loaded before this step's FMAs.
__device__ __forceinline__ void smem_mm(const float* LT, const float* R,
                                        int M, const Owner& o,
                                        float (&acc)[8][8]) {
  float4 a0 = ld4(LT + o.i0), a1 = ld4(LT + o.h + o.i0);
  float4 b0 = ld4(R + o.j0), b1 = ld4(R + o.h + o.j0);
  for (int k = 1; k <= M; ++k) {
    const int kn = k < M ? k : k - 1;   // the last step reloads its own
    const float* l = LT + kn * M;
    const float* r = R + kn * M;
    const float4 na0 = ld4(l + o.i0), na1 = ld4(l + o.h + o.i0);
    const float4 nb0 = ld4(r + o.j0), nb1 = ld4(r + o.h + o.j0);
    outer8(a0, a1, b0, b1, acc);
    a0 = na0;
    a1 = na1;
    b0 = nb0;
    b1 = nb1;
  }
}

// One Horner step's products on 8 x 4 tiles: acc12 += X R12 + G R11 and,
// with kR11, acc11 += X R11.  XT = X^T, GT = G^T, R12, R11 row-major, in
// shared memory.
template <bool kR11>
__device__ __forceinline__ void horner_mm(const float* XT, const float* GT,
                                          const float* R12, const float* R11,
                                          int M, const Owner& o,
                                          float (&acc12)[8][4],
                                          float (&acc11)[8][4]) {
#pragma unroll 2
  for (int k = 0; k < M; ++k) {
    const float* x = XT + k * M;
    const float* g = GT + k * M;
    const float4 x0 = ld4(x + o.i0), x1 = ld4(x + o.h + o.i0);
    const float4 g0 = ld4(g + o.i0), g1 = ld4(g + o.h + o.i0);
    const float4 b12 = ld4(R12 + k * M + o.j0);
    const float4 b11 = ld4(R11 + k * M + o.j0);
    const float xa[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float p[4] = {b12.x, b12.y, b12.z, b12.w};
    const float q[4] = {b11.x, b11.y, b11.z, b11.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc12[r][c] = fmaf(ga[r], q[c], fmaf(xa[r], p[c], acc12[r][c]));
        if (kR11) acc11[r][c] = fmaf(xa[r], q[c], acc11[r][c]);
      }
  }
}

// Kernel 7, M <= kExpmSharedMaxM.  A [T][M][M] -> E [T][M][M]; dynamic
// shared memory 2 M^2 floats (two blocks per SM at M = 120); inv =
// 2^-scaling.  The series by Horner, R <- I + A0 R / k for k = order ..
// 1, then the squarings R <- R R.
__global__ void __launch_bounds__(kExpmThreads, 2)
expm_forward_shared_kernel(const float* __restrict__ A, int T, int M,
                           int order, int scaling, float inv,
                           float* __restrict__ E) {
  extern __shared__ __align__(16) float expm_smem[];
  const int MM = M * M;
  float* LT = expm_smem;        // the left operand, transposed
  float* R = expm_smem + MM;    // the right operand, row-major
  const Owner o = shared_owner<8>(M);
  const int n = order > 1 ? order : 1;   // order 0 keeps I + A too
  const float rn = 1.f / (float)n;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const float* At = A + (long)t * MM;
    __syncthreads();   // the previous timestep's reads are done
    for (int e = threadIdx.x; e < MM; e += blockDim.x) {
      const float a = At[e] * inv;   // exact: inv is a power of two
      LT[(e % M) * M + e / M] = a;
      R[e] = (e / M == e % M ? 1.f : 0.f) + a * rn;
    }
    __syncthreads();
    float acc[8][8];
    for (int k = n - 1; k >= 1; --k) {
      const float rk = 1.f / (float)k;
      zero(acc);
      if (o.active) smem_mm(LT, R, M, o, acc);
      __syncthreads();
      if (o.active) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float* row = R + tile_row(o, r) * M;
#pragma unroll
          for (int c = 0; c < 8; ++c) row[tile_col<8>(o, c)] = acc[r][c] * rk;
        }
        if (o.i0 == o.j0)   // the diagonal runs through this tile
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = tile_row(o, r);
            R[i * M + i] += 1.f;
          }
      }
      __syncthreads();
    }
    // squarings: R <- R R, with R^T written over the left operand first
    for (int s = 0; s < scaling; ++s) {
      if (o.active) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int i = tile_row(o, r), j = tile_col<8>(o, c);
            LT[j * M + i] = R[i * M + j];
          }
      }
      __syncthreads();
      zero(acc);
      if (o.active) smem_mm(LT, R, M, o, acc);
      __syncthreads();
      if (o.active) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            R[tile_row(o, r) * M + tile_col<8>(o, c)] = acc[r][c];
      }
      __syncthreads();
    }
    float* Et = E + (long)t * MM;
    for (int e = threadIdx.x; e < MM; e += blockDim.x) Et[e] = R[e];
  }
}

// Kernel 8, M <= kExpmSharedMaxM and s = 0.  A, G = Ebar [T][M][M] ->
// Abar [T][M][M]; dynamic shared memory 4 M^2 floats; no scratch.  8 x 4
// tiles, so that up to 15 warps share the SM's one block.
__global__ void __launch_bounds__(kExpmBackwardThreads, 1)
expm_backward_shared_kernel(const float* __restrict__ A,
                            const float* __restrict__ G, int T, int M,
                            int order, float* __restrict__ Abar) {
  extern __shared__ __align__(16) float expm_smem[];
  const int MM = M * M;
  float* XT = expm_smem;          // X^T = A
  float* GT = expm_smem + MM;     // G^T
  float* R11 = expm_smem + 2 * MM;
  float* R12 = expm_smem + 3 * MM;
  const Owner o = shared_owner<4>(M);
  const int n = order > 1 ? order : 1;   // order 0 keeps I + A too
  const float rn = 1.f / (float)n;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const float* At = A + (long)t * MM;
    const float* Gt = G + (long)t * MM;
    __syncthreads();   // the previous timestep's reads are done
    for (int e = threadIdx.x; e < MM; e += blockDim.x) {
      XT[e] = At[e];
      GT[(e % M) * M + e / M] = Gt[e];
    }
    __syncthreads();
    // the top term: R12 = G / n, R11 = I + X / n
    for (int e = threadIdx.x; e < MM; e += blockDim.x) {
      const int i = e / M, j = e % M;
      R12[e] = GT[j * M + i] * rn;
      R11[e] = (i == j ? 1.f : 0.f) + XT[j * M + i] * rn;
    }
    __syncthreads();
    for (int k = n - 1; k >= 1; --k) {
      const float rk = 1.f / (float)k;
      float acc12[8][4], acc11[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc12[r][c] = acc11[r][c] = 0.f;
      if (o.active) {
        if (k > 1)
          horner_mm<true>(XT, GT, R12, R11, M, o, acc12, acc11);
        else
          horner_mm<false>(XT, GT, R12, R11, M, o, acc12, acc11);
      }
      __syncthreads();
      if (o.active) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = tile_row(o, r), j = tile_col<4>(o, c);
            R12[i * M + j] = acc12[r][c] * rk;
            if (k > 1)
              R11[i * M + j] = (i == j ? 1.f : 0.f) + acc11[r][c] * rk;
          }
      }
      __syncthreads();
    }
    float* Abt = Abar + (long)t * MM;
    for (int e = threadIdx.x; e < MM; e += blockDim.x) Abt[e] = R12[e];
  }
}

// ---- staged path ----------------------------------------------------------

// A logical operand X[i][k] = t ? p[k*M + i] : p[i*M + k].
struct Operand {
  const float* p;
  bool t;
};

struct Term {
  Operand L, R;
};

// Stage S[kk][xx] = Y[x0 + xx][k0 + kk] for kk < kSlice, xx < kTile (zero
// outside M), where Y[x][k] = xfast ? p[k*M + x] : p[x*M + k].
__device__ __forceinline__ void stage(float* S, const float* p, bool xfast,
                                      int M, int x0, int k0) {
  if (xfast) {   // contiguous along x: 16-byte copies
    for (int c = threadIdx.x; c < kSlice * kTile / 4; c += blockDim.x) {
      const int kk = c / (kTile / 4), xx = 4 * (c % (kTile / 4));
      const int k = k0 + kk, x = x0 + xx;
      const bool ok = k < M && x < M;
      cp_async16(S + kk * kLd + xx, ok ? p + (long)k * M + x : p, ok);
    }
  } else {       // contiguous along k: 4-byte copies that transpose
    for (int e = threadIdx.x; e < kSlice * kTile; e += blockDim.x) {
      const int kk = e % kSlice, xx = e / kSlice;
      const int k = k0 + kk, x = x0 + xx;
      const bool ok = k < M && x < M;
      cp_async4(S + kk * kLd + xx, ok ? p + (long)x * M + k : p, ok);
    }
  }
}

// sum over the terms of L R, macro tile by macro tile (the cluster's
// blocks take every cluster_blocks()-th); epi(acc, ib, jb) receives each
// thread's 8 x 8 tile (rows ib.., ib + 64..; columns jb.., jb + 64..).
// Ends with a cluster barrier, so what epi wrote is visible to the
// cluster.  ring: 2 kStage floats of shared memory.
template <class Epi>
__device__ void staged_mm(const Term* terms, int nterms, int M, float* ring,
                          Epi epi) {
  const int nk = (M + kSlice - 1) / kSlice;
  const int nb = (M + kTile - 1) / kTile;
  const int total = nterms * nk;
  const int ti = 4 * (threadIdx.x / 16), tj = 4 * (threadIdx.x % 16);
  for (int b = cluster_rank(); b < nb * nb; b += cluster_blocks()) {
    const int i0 = (b / nb) * kTile, j0 = (b % nb) * kTile;
    auto fill = [&](int s) {   // start the copies of slice s
      const Term& tm = terms[s / nk];
      const int k0 = (s % nk) * kSlice;
      float* S = ring + (s & 1) * kStage;
      stage(S, tm.L.p, tm.L.t, M, i0, k0);
      stage(S + kSlice * kLd, tm.R.p, !tm.R.t, M, j0, k0);
      cp_async_commit();
    };
    float acc[8][8];
    zero(acc);
    fill(0);
    for (int s = 0; s < total; ++s) {
      if (s + 1 < total) {
        fill(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* Ls = ring + (s & 1) * kStage;
      const float* Rs = Ls + kSlice * kLd;
      // the next step's operands are loaded before this step's FMAs
      float4 a0 = ld4(Ls + ti), a1 = ld4(Ls + 64 + ti);
      float4 b0 = ld4(Rs + tj), b1 = ld4(Rs + 64 + tj);
#pragma unroll
      for (int kk = 1; kk <= kSlice; ++kk) {
        const int kn = (kk < kSlice ? kk : kSlice - 1) * kLd;
        const float4 na0 = ld4(Ls + kn + ti), na1 = ld4(Ls + kn + 64 + ti);
        const float4 nb0 = ld4(Rs + kn + tj), nb1 = ld4(Rs + kn + 64 + tj);
        outer8(a0, a1, b0, b1, acc);
        a0 = na0;
        a1 = na1;
        b0 = nb0;
        b1 = nb1;
      }
      __syncthreads();   // the stage is free for the slice after next
    }
    epi(acc, i0 + ti, j0 + tj);
  }
  cluster_sync();
}

// Element loops of the staged path, split over the cluster's blocks.
__device__ __forceinline__ long elem_first() {
  return (long)cluster_rank() * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long elem_stride() {
  return (long)cluster_blocks() * blockDim.x;
}

// out = sum over the terms of L R, out[i][j] = f(i, j, value)
template <class F>
__device__ __forceinline__ void staged_product(const Term* terms, int nterms,
                                               int M, float* ring, F f) {
  staged_mm(terms, nterms, M, ring, [&](const float (&acc)[8][8], int ib,
                                        int jb) {
    each_out(acc, ib, jb, 64, M, f);
  });
}

// The series p(A0) by Horner, R <- I + A0 R / k for k = order .. 1, through
// the buffers W0 / W1; returns the one that holds it.
__device__ __forceinline__ float* staged_series(const float* A0, float* W0,
                                                float* W1, int M, int order,
                                                float* ring) {
  const int n = order > 1 ? order : 1;   // order 0 keeps I + A too
  const float rn = 1.f / (float)n;
  const long MM = (long)M * M;
  float* R = W0;
  for (long e = elem_first(); e < MM; e += elem_stride())
    R[e] = (e / M == e % M ? 1.f : 0.f) + A0[e] * rn;
  cluster_sync();
  for (int k = n - 1; k >= 1; --k) {
    const float rk = 1.f / (float)k;
    float* out = R == W0 ? W1 : W0;
    const Term tm{{A0, false}, {R, false}};
    staged_product(&tm, 1, M, ring, [&](int i, int j, float v) {
      out[i * M + j] = (i == j ? 1.f : 0.f) + v * rk;
    });
    R = out;
  }
  return R;
}

// A0 = At * inv into the A0 slot (exact: inv is a power of two).
__device__ __forceinline__ void staged_load(const float* At, float inv,
                                            int M, float* A0) {
  const long MM = (long)M * M;
  for (long e = elem_first(); e < MM; e += elem_stride())
    A0[e] = At[e] * inv;
}

// Kernel 7 above kExpmSharedMaxM.  One cluster of blocks per timestep;
// scratch: kForwardSlots M x M per cluster (A0 and two work buffers).
__global__ void __launch_bounds__(kExpmThreads, 2)
expm_forward_staged_kernel(const float* __restrict__ A, int T, int M,
                           int order, int scaling, float inv,
                           float* __restrict__ E, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float expm_smem[];
  const long MM = (long)M * M;
  const int c = blockIdx.x / cluster_blocks();
  const int clusters = gridDim.x / cluster_blocks();
  float* slot = scratch + c * kForwardSlots * MM;
  float* A0 = slot;
  for (int t = c; t < T; t += clusters) {
    cluster_sync();   // the previous timestep's reads are done
    staged_load(A + t * MM, inv, M, A0);
    cluster_sync();
    float* Es = staged_series(A0, slot + MM, slot + 2 * MM, M, order,
                              expm_smem);
    // squarings: E <- E E into the other buffer
    for (int s = 0; s < scaling; ++s) {
      float* dst = Es == slot + MM ? slot + 2 * MM : slot + MM;
      const Term tm{{Es, false}, {Es, false}};
      staged_product(&tm, 1, M, expm_smem,
                     [&](int i, int j, float v) { dst[i * M + j] = v; });
      Es = dst;
    }
    float* Et = E + t * MM;
    for (long e = elem_first(); e < MM; e += elem_stride()) Et[e] = Es[e];
  }
}

// Kernel 8 above kExpmSharedMaxM or with s > 0.  One cluster of blocks per
// timestep; scratch: kBackwardSlots + scaling M x M per cluster: A0, four
// work buffers B, and s more (the pre-squaring E's after the first, and
// one spare).
__global__ void __launch_bounds__(kExpmThreads, 2)
expm_backward_staged_kernel(const float* __restrict__ A,
                            const float* __restrict__ G, int T, int M,
                            int order, int scaling, float inv,
                            float* __restrict__ Abar,
                            float* __restrict__ scratch) {
  extern __shared__ __align__(16) float expm_smem[];
  const long MM = (long)M * M;
  const int c = blockIdx.x / cluster_blocks();
  const int clusters = gridDim.x / cluster_blocks();
  float* slot = scratch + c * (kBackwardSlots + scaling) * MM;
  float* A0 = slot;
  float* B[4] = {slot + MM, slot + 2 * MM, slot + 3 * MM, slot + 4 * MM};
  const int n = order > 1 ? order : 1;   // order 0 keeps I + A too
  const float rn = 1.f / (float)n;
  for (int t = c; t < T; t += clusters) {
    const float* Gt = G + t * MM;
    float* Abt = Abar + t * MM;
    cluster_sync();   // the previous timestep's reads are done
    staged_load(A + t * MM, inv, M, A0);
    cluster_sync();
    const float* Gc = Gt;   // the cotangent of the series
    float* R[4] = {B[0], B[1], B[2], B[3]};
    if (scaling) {
      // the pre-squaring E's: Es(0) = p(A0), Es(j) = Es(j-1)^2
      float* Es0 = staged_series(A0, B[0], B[1], M, order, expm_smem);
      auto Esq = [&](int j) { return j == 0 ? Es0 : slot + (4 + j) * MM; };
      for (int j = 1; j < scaling; ++j) {
        const Term tm{{Esq(j - 1), false}, {Esq(j - 1), false}};
        float* dst = Esq(j);
        staged_product(&tm, 1, M, expm_smem,
                       [&](int i, int jj, float v) { dst[i * M + jj] = v; });
      }
      // squarings reverse: Ebar <- Ebar Es^T + Es^T Ebar
      for (int j = scaling - 1; j >= 0; --j) {
        float* dst = Gc == B[2] ? B[3] : B[2];
        const Term tm[2] = {{{Gc, false}, {Esq(j), true}},
                            {{Esq(j), true}, {Gc, false}}};
        staged_product(tm, 2, M, expm_smem,
                       [&](int i, int jj, float v) { dst[i * M + jj] = v; });
        Gc = dst;
      }
      R[0] = Es0 == B[0] ? B[1] : B[0];
      R[1] = Es0;
      R[2] = Gc == B[2] ? B[3] : B[2];
      R[3] = slot + (4 + scaling) * MM;
    }
    // Horner: R12 = G / n, R11 = I + X / n with X = A0^T, then the steps
    float *R12 = R[0], *R11 = R[1], *R12n = R[2], *R11n = R[3];
    for (long e = elem_first(); e < MM; e += elem_stride()) {
      const int i = (int)(e / M), j = (int)(e % M);
      R12[e] = Gc[e] * rn;
      R11[e] = (i == j ? 1.f : 0.f) + A0[(long)j * M + i] * rn;
    }
    cluster_sync();
    if (n == 1) {
      for (long e = elem_first(); e < MM; e += elem_stride())
        Abt[e] = R12[e] * inv;
      continue;
    }
    for (int k = n - 1; k >= 1; --k) {
      const float rk = 1.f / (float)k;
      const Term t12[2] = {{{A0, true}, {R12, false}},
                           {{Gc, false}, {R11, false}}};
      if (k == 1) {
        staged_product(t12, 2, M, expm_smem, [&](int i, int j, float v) {
          Abt[i * M + j] = v * inv;
        });
        break;
      }
      float* d12 = R12n;
      float* d11 = R11n;
      staged_product(t12, 2, M, expm_smem,
                     [&](int i, int j, float v) { d12[i * M + j] = v * rk; });
      const Term t11{{A0, true}, {R11, false}};
      staged_product(&t11, 1, M, expm_smem, [&](int i, int j, float v) {
        d11[i * M + j] = (i == j ? 1.f : 0.f) + v * rk;
      });
      R12n = R12;
      R11n = R11;
      R12 = d12;
      R11 = d11;
    }
  }
}

}  // namespace qoc
