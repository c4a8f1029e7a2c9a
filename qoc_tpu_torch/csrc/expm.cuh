// Batched truncated Taylor exponential and its exact reverse, one block per
// timestep (kernels 7 and 8; launches and C entry points in expm.cu).
//
// Replaces qoc_tpu/ops/pallas_expm.py::_fwd_kernel / _bwd_kernel behind
// _call.  Same function as the port's taylor_expm (and qoc_tpu's):
//
//   E_t = (sum_{n <= order} (A_t / 2^s)^n / n!)^(2^s),  A^n = A A^(n-1)
//
// Bound.  A chain of (order - 1) + s dependent M x M products per step:
// compute-bound in float32 FMAs (config 4: M = 120, order 14, 13 products
// of 1.7 M FMAs per step) against 2 M^2 floats of input and output.  No
// tensor cores: the only float32 path of wgmma is TF32, which the port
// forbids.  So the design keeps the whole series on chip where it fits.
//
// Layout.  A block owns one timestep and four M x M buffers: the scaled A,
// the running power and its successor (ping-pong), and the sum E.  For M <=
// kExpmSharedMaxM all four live in dynamic shared memory (4 M^2 floats, at
// M = 120 230 KB of the 227 KB a block may take), so only A is read from
// device memory and only E written, as the TPU kernel keeps its block in
// VMEM.  Above that (to the gate's M = 512) they live in a device-memory
// scratch of the same shape per timestep, served by L1/L2.
//
// Products.  Each thread owns output tiles of kRows x kCols (8 x 4), tile
// tau = thread, thread + blockDim, ...; per 4-deep slice of the reduction
// it loads 8 + 4 float4 and does 128 FMAs from registers.  Transposed
// operands (the reverse sweep's X Y^T and X^T Y) are read by swapping the
// indices; there are no transposed copies.  Results go through a per-element
// epilogue, so the series sum, the ping-pong store and the reverse's
// accumulations each cost no extra pass.

#pragma once

#include <cuda_runtime.h>

namespace qoc {

constexpr int kExpmThreads = 512;
constexpr int kRows = 8;
constexpr int kCols = 4;
// the largest M whose four buffers fit the 227 KB (232448 B) of dynamic
// shared memory a block may take: 4 * 120^2 * 4 B = 230400 B
constexpr int kExpmSharedMaxM = 120;

__host__ __device__ inline int expm_threads(int M) {
  const int tiles = (M / kRows) * (M / kCols);
  const int t = (tiles + 31) / 32 * 32;
  return t < kExpmThreads ? t : kExpmThreads;
}

// op(X) op(Y) for row-major M x M X, Y (op = transpose where TX / TY);
// epi(index i*M + j, value) receives each element of the product.  M % 8
// == 0 and 16-byte aligned X, Y.  No barrier inside: the caller
// synchronises before anything reads what epi wrote.
template <bool TX, bool TY, class Epi>
__device__ __forceinline__ void block_mm(const float* X, const float* Y,
                                         int M, Epi epi) {
  const int cbs = M / kCols;
  const int tiles = (M / kRows) * cbs;
  for (int tau = threadIdx.x; tau < tiles; tau += blockDim.x) {
    const int i0 = (tau / cbs) * kRows;
    const int j0 = (tau % cbs) * kCols;
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < M; k += 4) {
      float a[kRows][4], b[4][kCols];
      if (TX) {   // X^T[i][k] = X[k][i]: rows i0.. contiguous in X's row k
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* x =
              reinterpret_cast<const float4*>(X + (long)(k + kk) * M + i0);
          const float4 lo = x[0], hi = x[1];
          a[0][kk] = lo.x; a[1][kk] = lo.y; a[2][kk] = lo.z; a[3][kk] = lo.w;
          a[4][kk] = hi.x; a[5][kk] = hi.y; a[6][kk] = hi.z; a[7][kk] = hi.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(X + (long)(i0 + r) * M + k);
          a[r][0] = x.x; a[r][1] = x.y; a[r][2] = x.z; a[r][3] = x.w;
        }
      }
      if (TY) {   // Y^T[k][j] = Y[j][k]: k.. contiguous in Y's row j
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 y =
              *reinterpret_cast<const float4*>(Y + (long)(j0 + c) * M + k);
          b[0][c] = y.x; b[1][c] = y.y; b[2][c] = y.z; b[3][c] = y.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 y =
              *reinterpret_cast<const float4*>(Y + (long)(k + kk) * M + j0);
          b[kk][0] = y.x; b[kk][1] = y.y; b[kk][2] = y.z; b[kk][3] = y.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[r][c] = fmaf(a[r][kk], b[kk][c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        epi((long)(i0 + r) * M + j0 + c, acc[r][c]);
  }
}

// Kernel 7.  A [T][M][M] -> E [T][M][M].  kShared: the four buffers in
// dynamic shared memory (M <= kExpmSharedMaxM); else in scratch
// [T][4][M][M].  inv = 2^-scaling.
template <bool kShared>
__global__ void __launch_bounds__(kExpmThreads)
expm_forward_kernel(const float* __restrict__ A, int M, int order,
                    int scaling, float inv, float* __restrict__ E,
                    float* __restrict__ scratch) {
  extern __shared__ __align__(16) float expm_smem[];
  const long MM = (long)M * M;
  float* base = kShared ? expm_smem : scratch + blockIdx.x * 4 * MM;
  float* As = base;
  float* P = base + MM;
  float* Q = base + 2 * MM;
  float* Es = base + 3 * MM;
  const float* At = A + blockIdx.x * MM;
  for (long e = threadIdx.x; e < MM; e += blockDim.x) {
    const float a = At[e] * inv;   // exact: inv is a power of two
    As[e] = a;
    P[e] = a;
    Es[e] = (e / M == e % M) ? 1.f + a : a;   // E = I + A
  }
  __syncthreads();
  double fac = 1.0;
  for (int n = 2; n <= order; ++n) {
    fac *= n;
    const float rf = 1.f / (float)fac;
    float* dst = Q;
    block_mm<false, false>(As, P, M, [&](long e, float v) {
      dst[e] = v;
      Es[e] += v * rf;
    });
    __syncthreads();
    Q = P;
    P = dst;
  }
  // squarings: E <- E E through the free power buffer
  for (int s = 0; s < scaling; ++s) {
    float* dst = P;
    block_mm<false, false>(Es, Es, M, [&](long e, float v) { dst[e] = v; });
    __syncthreads();
    P = Es;
    Es = dst;
  }
  float* Et = E + blockIdx.x * MM;
  for (long e = threadIdx.x; e < MM; e += blockDim.x) Et[e] = Es[e];
}

// Buffers per timestep of kernel 8's scratch: the scaled A, the powers
// A^2..A^(order-1), the pre-squaring E's, E, and the cotangents Ebar,
// anbar, Abar and one product buffer.
__host__ __device__ inline int expm_backward_slots(int order, int scaling) {
  return (order > 2 ? order - 2 : 0) + scaling + 6;
}

// Kernel 8.  A and Ebar [T][M][M] -> Abar [T][M][M], the exact VJP of
// kernel 7: recompute the powers and the pre-squaring E's, reverse the
// squarings (Ebar <- Ebar Es^T + Es^T Ebar), then the Taylor reverse
// (Abar += anbar A^(n-1)^T, anbar <- A^T anbar + Ebar / (n-1)!), scaled by
// 2^-s.  scratch [T][expm_backward_slots][M][M] in device memory.
__global__ void __launch_bounds__(kExpmThreads)
expm_backward_kernel(const float* __restrict__ A,
                     const float* __restrict__ G, int M, int order,
                     int scaling, float inv, float* __restrict__ Abar,
                     float* __restrict__ scratch) {
  const long MM = (long)M * M;
  const int npow = order > 2 ? order - 2 : 0;
  float* base =
      scratch + (long)blockIdx.x * expm_backward_slots(order, scaling) * MM;
  float* As = base;
  float* pw = base + MM;                 // pw[m] = A^(m+2), m < npow
  float* sq = pw + npow * MM;            // sq[s], s < scaling
  float* Ec = sq + (long)scaling * MM;
  float* Eb = Ec + MM;
  float* Nb = Eb + MM;
  float* Ab = Nb + MM;
  float* W = Ab + MM;
  auto power = [&](int m) -> const float* {   // A^(m+1)
    return m == 0 ? As : pw + (m - 1) * MM;
  };
  const float* At = A + blockIdx.x * MM;
  const float* Gt = G + blockIdx.x * MM;
  for (long e = threadIdx.x; e < MM; e += blockDim.x) {
    const float a = At[e] * inv;
    As[e] = a;
    Ec[e] = (e / M == e % M) ? 1.f + a : a;
    Eb[e] = Gt[e];
    Ab[e] = 0.f;
  }
  __syncthreads();
  double fac = 1.0;
  for (int n = 2; n <= order; ++n) {
    fac *= n;
    const float rf = 1.f / (float)fac;
    float* dst = n < order ? pw + (n - 2) * MM : W;
    block_mm<false, false>(As, power(n - 2), M, [&](long e, float v) {
      dst[e] = v;
      Ec[e] += v * rf;
    });
    __syncthreads();
  }
  for (int s = 0; s < scaling; ++s) {
    float* Es = sq + s * MM;
    for (long e = threadIdx.x; e < MM; e += blockDim.x) Es[e] = Ec[e];
    __syncthreads();
    if (s + 1 < scaling) {
      block_mm<false, false>(Es, Es, M, [&](long e, float v) { Ec[e] = v; });
      __syncthreads();
    }
  }
  // squarings reverse: Ebar <- Ebar Es^T + Es^T Ebar
  for (int s = scaling - 1; s >= 0; --s) {
    const float* Es = sq + s * MM;
    block_mm<false, true>(Eb, Es, M, [&](long e, float v) { W[e] = v; });
    block_mm<true, false>(Es, Eb, M, [&](long e, float v) { W[e] += v; });
    __syncthreads();
    float* t = Eb;
    Eb = W;
    W = t;
  }
  // Taylor reverse
  const float rfo = (float)(1.0 / fac);
  for (long e = threadIdx.x; e < MM; e += blockDim.x) Nb[e] = Eb[e] * rfo;
  __syncthreads();
  double fac_n = fac;
  for (int n = order; n >= 2; --n) {
    block_mm<false, true>(Nb, power(n - 2), M,
                          [&](long e, float v) { Ab[e] += v; });
    fac_n /= n;
    const float rf = (float)(1.0 / fac_n);
    block_mm<true, false>(As, Nb, M,
                          [&](long e, float v) { W[e] = v + Eb[e] * rf; });
    __syncthreads();
    float* t = Nb;
    Nb = W;
    W = t;
  }
  float* Abt = Abar + blockIdx.x * MM;
  for (long e = threadIdx.x; e < MM; e += blockDim.x)
    Abt[e] = (Ab[e] + Nb[e]) * inv;
}

}  // namespace qoc
