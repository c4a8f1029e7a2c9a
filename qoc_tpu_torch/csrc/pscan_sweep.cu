// The pscan engine's serial sweeps: launches and C entry points (the math,
// the design and the bound are in pscan_sweep.cuh), which
// qoc_tpu_torch/ops/_cuda.py loads with ctypes.  A group of
// pscan_geometry(...).cluster blocks sweeps a tile of a seed: on chip a
// cluster, one a tile; through L2 a cooperative group, as many as the SMs
// hold, each sweeping tiles in turn.

#include <cuda_runtime.h>

#include "pscan_sweep.cuh"

#define QOC_DISPATCH_V(V, ...)                 \
  switch (V) {                                 \
    case 1: { constexpr int kV = 1; __VA_ARGS__ } break; \
    case 2: { constexpr int kV = 2; __VA_ARGS__ } break; \
    case 3: { constexpr int kV = 3; __VA_ARGS__ } break; \
    case 4: { constexpr int kV = 4; __VA_ARGS__ } break; \
    case 5: { constexpr int kV = 5; __VA_ARGS__ } break; \
    case 6: { constexpr int kV = 6; __VA_ARGS__ } break; \
    case 7: { constexpr int kV = 7; __VA_ARGS__ } break; \
    case 8: { constexpr int kV = 8; __VA_ARGS__ } break; \
    default: return (int)cudaErrorInvalidValue;          \
  }

// The current device's geometry, and its groups in the grid for B seeds:
// on chip one a tile of each seed; through L2 as many as the SMs hold
// (each sweeps tiles in turn), at most one a tile.
static cudaError_t pscan_plan(int M, int V, int reps, bool reverse, int B,
                              qoc::PscanGeometry* geo, long* groups) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *geo = qoc::pscan_geometry(M, V, reps, reverse, sms);
  if (!geo->cluster || B < 1) return cudaErrorInvalidValue;
  *groups = (long)B * geo->tiles;
  if (geo->wide && *groups > sms / geo->cluster)
    *groups = sms / geo->cluster;
  return cudaSuccess;
}

// `groups` groups of geo.cluster blocks: a cluster on chip; through L2, a
// cooperative launch (every block resident) where a group has several
// blocks, with a zeroed arrival counter a group for their barrier.
template <class... Params, class... Args>
static cudaError_t pscan_launch(void (*kernel)(Params...),
                                const qoc::PscanGeometry& geo, long groups,
                                cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * geo.cluster));
  cfg.blockDim = dim3(qoc::kPscanThreads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  if (geo.wide) {
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = geo.cluster > 1;
  } else {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = geo.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
  }
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The group counters of a launch through L2 with several blocks a group
// (null otherwise), stream-ordered.
static cudaError_t pscan_counters(const qoc::PscanGeometry& geo,
                                  long groups, cudaStream_t stream,
                                  unsigned** count) {
  *count = nullptr;
  if (!geo.wide || geo.cluster == 1) return cudaSuccess;
  const size_t bytes = sizeof(unsigned) * groups;
  cudaError_t err = cudaMallocAsync((void**)count, bytes, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(*count, 0, bytes, stream);
  return err;
}

static cudaError_t pscan_release(unsigned* count, cudaStream_t stream) {
  return count ? cudaFreeAsync(count, stream) : cudaSuccess;
}

// The geometry both sweeps launch with on the current device, as 10 ints
// (cluster, rows, chunk, chunks, stages, groups, smem, wide, vt, tiles;
// cluster 0: not taken).
extern "C" void qoc_pscan_geometry(int M, int V, int reps, int reverse,
                                   int* out) {
  qoc::PscanGeometry g = {};
  long groups;
  pscan_plan(M, V, reps, reverse != 0, 1, &g, &groups);
  const int vals[10] = {g.cluster, g.rows, g.chunk, g.chunks, g.stages,
                        g.groups,  g.smem, g.wide,  g.vt,     g.tiles};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
}

// Q [B or 1][T][M][M] (q_seed floats between seeds, 0: shared), psi0 [B or
// 1][M][V] (x_seed) -> vecs [B][T reps + 1][M][V].
extern "C" int qoc_pscan_forward(const float* Q, long q_seed,
                                 const float* psi0, long x_seed, float* vecs,
                                 int B, int T, int M, int V, int reps,
                                 void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  qoc::PscanGeometry geo;
  if (T < 1) return (int)cudaErrorInvalidValue;
  long groups;
  cudaError_t err = pscan_plan(M, V, reps, false, B, &geo, &groups);
  if (err != cudaSuccess) return (int)err;
  unsigned* count;
  if ((err = pscan_counters(geo, groups, stream, &count)) != cudaSuccess)
    return (int)err;
  QOC_DISPATCH_V(geo.vt, {
    if (!geo.wide)
      err = M % 4 == 0
                ? pscan_launch(qoc::pscan_forward_kernel<kV, 4>, geo, groups,
                               stream, Q, q_seed, psi0, x_seed, vecs, T, M,
                               V, reps, geo)
                : pscan_launch(qoc::pscan_forward_kernel<kV, 2>, geo, groups,
                               stream, Q, q_seed, psi0, x_seed, vecs, T, M,
                               V, reps, geo);
    else if (M % 4 == 0)
      err = pscan_launch(qoc::pscan_forward_wide_kernel<kV, 4>, geo, groups,
                         stream, Q, q_seed, psi0, x_seed, vecs, count, B, T,
                         M, V, reps, geo);
    else if (M % 2 == 0)
      err = pscan_launch(qoc::pscan_forward_wide_kernel<kV, 2>, geo, groups,
                         stream, Q, q_seed, psi0, x_seed, vecs, count, B, T,
                         M, V, reps, geo);
    else
      err = pscan_launch(qoc::pscan_forward_wide_kernel<kV, 1>, geo, groups,
                         stream, Q, q_seed, psi0, x_seed, vecs, count, B, T,
                         M, V, reps, geo);
  });
  const cudaError_t freed = pscan_release(count, stream);
  if (err != cudaSuccess) return (int)err;
  if (freed != cudaSuccess) return (int)freed;
  return (int)cudaGetLastError();
}

// Q as for the forward, g [B or 1][T reps + 1][M][V] (g_seed) -> lams
// [B][T reps][M][V], psi0_bar [B][M][V].
extern "C" int qoc_pscan_reverse(const float* Q, long q_seed, const float* g,
                                 long g_seed, float* lams, float* psi0_bar,
                                 int B, int T, int M, int V, int reps,
                                 void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  qoc::PscanGeometry geo;
  if (T < 1) return (int)cudaErrorInvalidValue;
  long groups;
  cudaError_t err = pscan_plan(M, V, reps, true, B, &geo, &groups);
  if (err != cudaSuccess) return (int)err;
  unsigned* count;
  if ((err = pscan_counters(geo, groups, stream, &count)) != cudaSuccess)
    return (int)err;
  QOC_DISPATCH_V(geo.vt, {
    if (!geo.wide)
      err = pscan_launch(qoc::pscan_reverse_kernel<kV>, geo, groups, stream,
                         Q, q_seed, g, g_seed, lams, psi0_bar, T, M, V, reps,
                         geo);
    else
      err = pscan_launch(qoc::pscan_reverse_wide_kernel<kV>, geo, groups,
                         stream, Q, q_seed, g, g_seed, lams, psi0_bar, count,
                         B, T, M, V, reps, geo);
  });
  const cudaError_t freed = pscan_release(count, stream);
  if (err != cudaSuccess) return (int)err;
  if (freed != cudaSuccess) return (int)freed;
  return (int)cudaGetLastError();
}
