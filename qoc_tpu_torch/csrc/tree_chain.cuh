// Device functions of the tree chain: Taylor step propagators, the
// pairwise product tree, the inclusive prefix scan, and their exact
// reverse mode.
//
// Replaces the value-level functions of qoc_tpu/ops/pallas_tree.py
// (taylor_step_vals, taylor_step_backward_vals, tree_forward_vals,
// tree_backward_vals, scan_forward_vals, scan_backward_vals), which the
// tree kernels 1-2 (tree_chain.cu) run; the fused Adam segment kernel
// (mega.cuh) has a body of its own and takes only QOC_DISPATCH_M from
// here.
//
// Layout.  Every per-step matrix array is [levels][M*M][Tp] float32: for
// element e = i*M + j of the matrix at time lane t the offset is
// e*Tp + t inside a level.  One thread owns one lane at a time, so a warp
// reading element e of 32 neighbouring lanes reads 128 contiguous bytes.
//
// Work split.  One thread block runs one problem.  Threads stride over
// the lanes t < Tp (Tp may exceed blockDim), each keeping its lane's
// M x M matrices in thread-local arrays (registers, spilling to local
// memory for the larger M).  The product tree is a true pairwise tree:
// level l multiplies X[t + 2^l] @ X[t] for t = 0 mod 2^(l+1), later time
// on the left, with a block barrier between levels.  Residuals (Taylor
// powers, pre-squaring values, tree levels) live in a global scratch
// buffer that the host wrapper allocates.
//
// Bound.  At the sizes the slice runs (M <= 12, Tp <= 8192, order <= 20)
// the work is O(order * M^3 * Tp) flops on ONE streaming multiprocessor
// with a barrier per tree level, so it is latency bound; the residuals
// (a few MB) stay in L2.  Spreading a problem over more SMs, keeping the
// residuals in shared memory and warp-per-lane-group layouts are later
// work.
//
// Kernels 1-2 run kThreads threads.  No pointer here is __restrict__:
// the helpers rewrite the tree levels and the cotangent buffer in place
// between block barriers, so no read may take the non-coherent read-only
// path.

#pragma once

namespace qoc {

constexpr int kThreads = 256;   // block size of kernels 1-2

__device__ __forceinline__ int tree_levels(int Tp) {   // log2(Tp), Tp = 2^L
  return 31 - __clz(Tp);
}

// ---- per-lane M x M helpers (row-major, thread-local arrays) -------------

template <int M>
__device__ __forceinline__ void mat_load(const float* base,
                                         int Tp, int t, float* out) {
#pragma unroll
  for (int e = 0; e < M * M; ++e) out[e] = base[(long)e * Tp + t];
}

template <int M>
__device__ __forceinline__ void mat_store(float* base, int Tp, int t,
                                          const float* in) {
#pragma unroll
  for (int e = 0; e < M * M; ++e) base[(long)e * Tp + t] = in[e];
}

// C = A @ B
template <int M>
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < M; ++m) acc += A[i * M + m] * B[m * M + j];
      C[i * M + j] = acc;
    }
  }
}

// C = A @ B^T
template <int M>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float* C) {
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) acc += A[i * M + j] * B[m * M + j];
      C[i * M + m] = acc;
    }
  }
}

// C = A^T @ B
template <int M>
__device__ __forceinline__ void mm_tn(const float* A, const float* B,
                                      float* C) {
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < M; ++i) acc += A[i * M + m] * B[i * M + j];
      C[m * M + j] = acc;
    }
  }
}

// ---- Taylor step (one lane) ----------------------------------------------

// A: the lane's generator sum_k w[k,t] mats[k], NOT yet divided by
// 2^scaling.  Writes A^1..A^(order-1) into `an` (level n-1 holds A^n; A^1
// is always stored, the buffer has max(order-1, 1) levels), the values
// before each squaring into `sq`, and the step propagator
// E_t = Taylor_order(A / 2^s)^(2^s) into `E0` (tree level 0).
template <int M>
__device__ __forceinline__ void taylor_step(float* A, int order,
                                            int scaling, float* an, float* sq,
                                            float* E0, int Tp, int t) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  if (scaling) {
    const float s = (float)(1.0 / (double)(1 << scaling));
#pragma unroll
    for (int e = 0; e < MM; ++e) A[e] *= s;
  }
  float E[MM], An[MM], tmp[MM];
#pragma unroll
  for (int e = 0; e < MM; ++e) {
    E[e] = A[e];
    An[e] = A[e];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) E[i * M + i] += 1.0f;
  mat_store<M>(an, Tp, t, A);
  double factorial = 1.0;
  for (int n = 2; n <= order; ++n) {
    factorial *= n;
    mm<M>(A, An, tmp);
    const float c = (float)(1.0 / factorial);
#pragma unroll
    for (int e = 0; e < MM; ++e) {
      An[e] = tmp[e];
      E[e] += tmp[e] * c;
    }
    if (n < order) mat_store<M>(an + (n - 1) * lvl, Tp, t, An);
  }
  for (int s = 0; s < scaling; ++s) {
    mat_store<M>(sq + s * lvl, Tp, t, E);
    mm<M>(E, E, tmp);
#pragma unroll
    for (int e = 0; e < MM; ++e) E[e] = tmp[e];
  }
  mat_store<M>(E0, Tp, t, E);
}

// Reverse of taylor_step for one lane.  Ebar: cotangent of the lane's
// step propagator (overwritten).  Writes the cotangent of the generator
// sum_k w[k,t] mats[k] (before the 2^-s scaling) into Abar.
template <int M>
__device__ __forceinline__ void taylor_step_backward(
    float* Ebar, int order, int scaling, const float* an, const float* sq,
    int Tp, int t, float* Abar) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  float X[MM], t1[MM], t2[MM];
  // squarings: E' = E @ E  ->  Ebar = Ebar @ E^T + E^T @ Ebar
  for (int s = scaling - 1; s >= 0; --s) {
    mat_load<M>(sq + s * lvl, Tp, t, X);
    mm_nt<M>(Ebar, X, t1);
    mm_tn<M>(X, Ebar, t2);
#pragma unroll
    for (int e = 0; e < MM; ++e) Ebar[e] = t1[e] + t2[e];
  }
  // Taylor: E = I + sum_{n=1}^{order} A^n / n!,  A^n = A @ A^(n-1)
  float A[MM], anbar[MM];
  mat_load<M>(an, Tp, t, A);
  double factorial = 1.0;
  for (int n = 2; n <= order; ++n) factorial *= n;
  const float c0 = (float)(1.0 / factorial);
#pragma unroll
  for (int e = 0; e < MM; ++e) {
    anbar[e] = Ebar[e] * c0;   // cotangent of A^order
    Abar[e] = 0.0f;
  }
  double fac_n = factorial;
  for (int n = order; n > 1; --n) {
    mat_load<M>(an + (n - 2) * lvl, Tp, t, X);   // A^(n-1)
    mm_nt<M>(anbar, X, t1);
    fac_n /= n;                                  // (n-1)!
    const float c = (float)(1.0 / fac_n);
    mm_tn<M>(A, anbar, t2);
#pragma unroll
    for (int e = 0; e < MM; ++e) {
      Abar[e] += t1[e];
      anbar[e] = t2[e] + Ebar[e] * c;
    }
  }
#pragma unroll
  for (int e = 0; e < MM; ++e) Abar[e] += anbar[e];   // n = 1 term
  if (scaling) {
    const float s = (float)(1.0 / (double)(1 << scaling));
#pragma unroll
    for (int e = 0; e < MM; ++e) Abar[e] *= s;
  }
}

// ---- pairwise product tree (whole block) ---------------------------------

// tree: [L][MM][Tp]; level 0 holds the step propagators on entry.  Level
// l+1 receives X[t + 2^l] @ X[t] at lanes t = 0 mod 2^(l+1); the last
// level's product (the full chain P_{Tp-1} ... P_0) goes to `out` [MM].
// The caller synchronises before (level 0 written) and after (`out` read).
template <int M>
__device__ __forceinline__ void tree_forward(float* tree, int L, int Tp,
                                             float* out) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  float X[MM], Y[MM], R[MM];
  for (int l = 0; l < L; ++l) {
    const int d = 1 << l;
    const int npairs = Tp >> (l + 1);
    const float* src = tree + l * lvl;
    for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
      const int t = p << (l + 1);
      mat_load<M>(src, Tp, t, X);
      mat_load<M>(src, Tp, t + d, Y);
      mm<M>(Y, X, R);
      if (l + 1 < L) {
        mat_store<M>(tree + (l + 1) * lvl, Tp, t, R);
      } else {
#pragma unroll
        for (int e = 0; e < MM; ++e) out[e] = R[e];
      }
    }
    __syncthreads();
  }
}

// Reverse of tree_forward, in place on bar [MM][Tp]: on entry lane 0
// holds the cotangent of the full product; on exit every lane t holds the
// cotangent of step propagator t.  Synchronises after each level.
template <int M>
__device__ __forceinline__ void tree_backward(const float* tree, int L,
                                              int Tp, float* bar) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  float X[MM], Y[MM], R[MM], out[MM];
  for (int l = L - 1; l >= 0; --l) {
    const int d = 1 << l;
    const int npairs = Tp >> (l + 1);
    const float* src = tree + l * lvl;
    for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
      const int t = p << (l + 1);
      mat_load<M>(bar, Tp, t, R);
      mat_load<M>(src, Tp, t, X);
      mat_load<M>(src, Tp, t + d, Y);
      // product Y @ X: Xbar = Y^T R (lane t), Ybar = R X^T (lane t + d)
      mm_tn<M>(Y, R, out);
      mat_store<M>(bar, Tp, t, out);
      mm_nt<M>(R, X, out);
      mat_store<M>(bar, Tp, t + d, out);
    }
    __syncthreads();
  }
}

// ---- inclusive prefix scan (whole block) ---------------------------------

// levels: [L+1][MM][Tp]; level 0 holds the step propagators on entry.
// Hillis-Steele: level l+1 receives X_l[t] @ X_l[t - 2^l] at lanes
// t >= 2^l (later time on the left) and X_l[t] at lanes t < 2^l, so level
// L holds the prefix product P_t ... P_0 at every lane t.  Each level
// reads one buffer and writes the next (lane t writes while lane t + 2^l
// reads), and every level's input stays as the residual scan_backward
// reads.  Padded lanes hold identities, so their prefixes equal the full
// chain.  The caller synchronises before (level 0 written); this
// synchronises after each level.
template <int M>
__device__ __forceinline__ void scan_forward(float* levels, int L, int Tp) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  float X[MM], Y[MM];
  for (int l = 0; l < L; ++l) {
    const int d = 1 << l;
    const float* src = levels + l * lvl;
    float* dst = levels + (l + 1) * lvl;
    for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
      mat_load<M>(src, Tp, t, X);
      if (t >= d) {
        mat_load<M>(src, Tp, t - d, Y);
        for (int i = 0; i < M; ++i) {
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < M; ++m) acc += X[i * M + m] * Y[m * M + j];
            dst[(long)(i * M + j) * Tp + t] = acc;
          }
        }
      } else {
        mat_store<M>(dst, Tp, t, X);
      }
    }
    __syncthreads();
  }
}

// Reverse of scan_forward.  bin [MM][Tp] holds the cotangent of level L
// (dense over lanes) on entry; bout is scratch of the same shape.  Each
// level reads one buffer and writes the other:
//   Xbar_l[t] = (t < d ? Xbar[t] : Xbar[t] @ X_l[t-d]^T)
//             + (t + d < Tp ? X_l[t+d]^T @ Xbar[t+d] : 0).
// Returns the buffer that holds the cotangents of the step propagators.
// The caller synchronises before (bin written); this synchronises after
// each level.
template <int M>
__device__ __forceinline__ float* scan_backward(const float* levels, int L,
                                                int Tp, float* bin,
                                                float* bout) {
  constexpr int MM = M * M;
  const long lvl = (long)MM * Tp;
  float B[MM], X[MM], R[MM];
  for (int l = L - 1; l >= 0; --l) {
    const int d = 1 << l;
    const float* Xl = levels + l * lvl;
    for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
      mat_load<M>(bin, Tp, t, B);
      if (t >= d) {   // left operand of lane t's product
        mat_load<M>(Xl, Tp, t - d, X);
        mm_nt<M>(B, X, R);
      } else {        // pass-through lane
#pragma unroll
        for (int e = 0; e < MM; ++e) R[e] = B[e];
      }
      if (t + d < Tp) {   // right operand of lane t+d's product
        mat_load<M>(Xl, Tp, t + d, X);
        mat_load<M>(bin, Tp, t + d, B);
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float acc = R[m * M + j];
#pragma unroll
            for (int i = 0; i < M; ++i) acc += X[i * M + m] * B[i * M + j];
            R[m * M + j] = acc;
          }
        }
      }
      mat_store<M>(bout, Tp, t, R);
    }
    __syncthreads();
    float* tmp = bin;
    bin = bout;
    bout = tmp;
  }
  return bin;
}

// w_bar[k] = sum_ij mats[k, i, j] * Abar[i, j]
template <int M>
__device__ __forceinline__ float frobenius_dot(const float* mat,
                                               const float* Abar) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < M * M; ++e) acc += mat[e] * Abar[e];
  return acc;
}

}  // namespace qoc

// Host side: instantiate a launch for the supported M (the real-iso
// dimension 2N, N <= 6); any other M returns cudaErrorInvalidValue.
#define QOC_DISPATCH_M(M_, ...)                             \
  switch (M_) {                                             \
    case 2: { constexpr int kM = 2; __VA_ARGS__; break; }   \
    case 4: { constexpr int kM = 4; __VA_ARGS__; break; }   \
    case 6: { constexpr int kM = 6; __VA_ARGS__; break; }   \
    case 8: { constexpr int kM = 8; __VA_ARGS__; break; }   \
    case 10: { constexpr int kM = 10; __VA_ARGS__; break; } \
    case 12: { constexpr int kM = 12; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;             \
  }
