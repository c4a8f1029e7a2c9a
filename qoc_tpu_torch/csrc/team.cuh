// Small helpers of the team form, shared by the tree chain (kernels 1-2),
// the fused segment (kernel 3, mega.cuh) and the state chain and batched
// optimizer (kernels 4-6, state_chain.cuh, mega_batch.cuh): a team of L =
// team_lanes(M) lanes in one warp, lane i holding row i of every matrix or
// vector the team works on, matrices in shared memory column-major with the
// column stride mega_mp(M); sums over a team, a warp and a block in a fixed
// order; and the host's dispatch over the compiled M.

#pragma once

#include <cuda_runtime.h>

namespace qoc {

constexpr unsigned kFullMask = 0xffffffffu;

// Lanes of a column's team: the least power of two >= M (M <= 16).
__host__ __device__ constexpr int team_lanes(int M) {
  return M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// Sum over the L lanes of a team, by a butterfly: every lane gets the same
// value (float addition commutes), in a fixed order.
template <int L>
__device__ __forceinline__ float team_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off, L);
  return x;
}

__host__ __device__ constexpr int mega_mp(int M) { return (M + 3) & ~3; }

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

// Sum over a warp's 32 lanes by a butterfly (every lane the same value).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// v[0..M) <- p[0..M) (a column in shared memory, 16-byte aligned), by
// float4 reads of the padded column.
template <int M>
__device__ __forceinline__ void ld_col(const float* p, float (&v)[M]) {
#pragma unroll
  for (int q = 0; q < mega_mp(M) / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * q);
    if (4 * q + 0 < M) v[4 * q + 0] = f.x;
    if (4 * q + 1 < M) v[4 * q + 1] = f.y;
    if (4 * q + 2 < M) v[4 * q + 2] = f.z;
    if (4 * q + 3 < M) v[4 * q + 3] = f.w;
  }
}

template <int M>
__device__ __forceinline__ float dot(const float (&a)[M],
                                     const float (&b)[M]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) s += a[j] * b[j];
  return s;
}

// A team lane's place: its team, its lane, the row it computes (M - 1 for
// lanes >= M, which store nothing) and whether it owns that row.
struct Team {
  int idx, lane, row;
  bool rl;
};

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
