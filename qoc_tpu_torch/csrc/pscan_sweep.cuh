// The pscan engine's two serial sweeps, one launch each (launches and C
// entry points in pscan_sweep.cu).
//
// Replaces no TPU kernel: qoc_tpu runs these sweeps as lax.scan
// (qoc_tpu/ops/propagation.py, _pscan_chain_core).  The port ran them as
// a host loop of one [M, M] x [M, V] product per sub-step
// (ops/propagation.py, pscan_sweep_plain and pscan_reverse_plain): 2 x
// 1000 launches a loss-and-gradient at config 4, which the host issues far
// more slowly than the card runs them.  Same function as those loops:
//
//   forward  psi_0 = psi0, psi_{p+1} = Q_t psi_p          (t = p / reps)
//   reverse  lam_i = mu + g_{i+1}, mu <- Q_t^T lam_i      (i = P-1 .. 0)
//            psi0_bar = mu + g_0,                          P = T reps
//
// Columns.  The V columns are independent chains: they are cut into tiles
// of at most 8 (balanced: V = 13 is two tiles of 7, the last with a column
// that is computed and not stored), and the tiles of every seed are swept
// by groups of blocks side by side in one grid.
//
// Bound.  Every Q_t [M, M] is read once a sweep (config 4: 1000 x 57.6 KB)
// for M^2 V multiply-adds, so at the card's scale it is memory-bound (Q
// once at 3.35 TB/s: 17 us a sweep at config 4).  But the chain is serial:
// a tile's sweep runs on one group of blocks, and what bounds a sub-step is
// the group's exchange of the new state and its barrier.  Arithmetic is
// float32 FMA in a fixed order (no tensor cores: their float32 path is
// TF32, which the port forbids), so a second launch gives the same bits.
//
// Geometry (pscan_geometry: from M, the tile and, for the wide form, the
// card's SMs over the groups).  Two forms of one algorithm, each block
// owning a slab of the new state, with the state on chip where it fits:
//
// On chip (M even, up to 512, the tile's state and two ring stages in one
// block's shared memory).  A group is a thread block cluster: one block
// while two slabs of the whole Q_t fit the ring (M <= 150), else 2, 4 or 8
// blocks, each with rows = M / C rounded up to even (so every copy starts
// on a 16-byte boundary) and the last block the rest.  Where two slabs
// still do not fit (M > ~424), a step's slab is streamed as chunks of a
// multiple of 4 rows.  Every Q_t is in device memory before the sweep
// starts (kernel 7 made them), so Q streams ahead of the chain: a ring of
// `stages` buffers in shared memory holds the next slabs, each filled by
// one bulk copy (cp.async.bulk) that completes on the stage's transaction
// barrier.  One thread (the block's last, whose warp has the fewest rows)
// issues the copies; a stage is refilled once the barrier that ends its
// step (or its chunk) has passed, so the copies of the next stages - 1
// steps are in flight while one step is computed.  On an H100 at config 4
// a sub-step takes ~1.0 us forward and ~1.2 us reverse, the same with the
// copies left out: the copies are hidden.  (Measured at M = 120: one block
// beats clusters of 2 to 8, whose barrier costs more than the rows it
// shares out.)
//
// Through L2 (every other shape: M past 512 or odd, a chunked slab with
// sub-steps).  A group is a block for every 16 rows (at most one an SM),
// and the grid as many groups as the SMs hold, each sweeping the seeds'
// tiles in turn, launched cooperatively so that all are resident; a
// group's barrier is a counter in global memory.  Each block
// owns rows (forward) or columns (reverse) of the new state, writes them
// to the output (vecs, lams), and after the barrier every block stages the
// whole state from there (L2) into its shared memory; Q is read straight
// from device memory, each step's rows or columns once.  Its shared memory
// holds the staged state (and the reverse's partial sums), so a tile
// narrows where M is large (the reverse: 8 columns to M = 2,421, one from
// M = 9,686; M past 19,370 is not taken).
//
// Forward on chip, a sub-step.  Warp w takes R = 8 rows of the slab (4 at
// V > 2), lanes stride the columns W at a time (16- or 8-byte reads of Q
// and of the state, kept [V][M]; conflict-free), each lane sums its
// columns in order, and a reduce-scatter of shuffles leaves each row's sum
// in 32 / R lanes, which write it into the next state buffer of every
// block of the cluster (distributed shared memory).  One barrier (cluster
// or block) ends the sub-step; the slab's rows then go from shared memory
// to vecs, after the barrier, since a cluster barrier waits for the global
// stores issued before it.
//
// Reverse on chip, a sub-step.  The owners of the slab's rows (thread r:
// row r) form lam = mu + g_{i+1} in shared memory; after a block barrier
// thread g M + j sums Q[r][j] lam[r] over its group g of whole quads of
// rows (Q read in place, column j contiguous across threads; lam in
// 16-byte broadcasts; four chains), and sends that partial of mu_j to the
// block owning row j.  After the barrier each owner writes its lam to lams
// and adds the C x groups partials of its row in order.  Q_t^T is never
// formed.
//
// Through L2, a sub-step.  Forward: warp w takes the block's rows w, w +
// 16, ..., lanes stride the columns as on chip, a butterfly of shuffles
// sums each row.  Reverse: the block's columns go to threads (c, g), each
// summing Q[r][j] lam[r] over its group g of rows (eight rows at a time,
// four chains), and the owner of column j adds the groups' partials in
// order.

#pragma once

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace qoc {

constexpr int kPscanThreads = 512;
constexpr int kPscanWarps = kPscanThreads / 32;
constexpr int kPscanIssuer = kPscanThreads - 1;   // issues the copies
constexpr int kPscanMaxM = 512;        // on chip: a reverse column a thread
constexpr int kPscanMaxV = 8;          // columns a tile
constexpr int kPscanMaxCluster = 8;    // portable cluster size
constexpr int kPscanMaxStages = 8;
constexpr int kPscanRingBytes = 180224;   // 176 KiB of the ring
constexpr int kPscanSmemMax = 232448;     // dynamic shared memory a block
constexpr int kPscanHeadFloats = 32;      // the stages' barriers, 128 B
constexpr int kPscanWideRows = 16;        // through L2: least rows a block

struct PscanGeometry {
  int cluster;   // blocks a tile of a seed (its group); 0: not taken
  int rows;      // rows of Q a block owns (the wide reverse: columns); the
                 // last block the rest
  int chunk;     // on chip: rows a ring stage holds
  int chunks;    // on chip: stages a step of a full slab takes
  int stages;    // on chip: ring depth
  int groups;    // the reverse's row groups
  int smem;      // dynamic shared memory, bytes
  int wide;      // 1: the state passes through L2, the group's barrier in
                 // global memory (a cooperative launch where cluster > 1)
  int vt;        // columns a tile (the kernels' V)
  int tiles;     // tiles of the V columns
};

__host__ __device__ inline int pscan_even_div(int a, int b) {
  const int q = (a + b - 1) / b;
  return q + (q & 1);
}

// The on-chip form at M rows and a tile of V columns; cluster 0 where it
// does not take the shape.
__host__ __device__ inline PscanGeometry pscan_on_chip(int M, int V,
                                                       int reps,
                                                       bool reverse) {
  PscanGeometry g = {};
  if (M < 2 || M % 2 || M > kPscanMaxM || V < 1 || V > kPscanMaxV ||
      reps < 1)
    return g;
  const long row_bytes = 4L * M;
  int C = 1;
  while (C < kPscanMaxCluster &&
         2 * pscan_even_div(M, C) * row_bytes > kPscanRingBytes)
    C *= 2;
  const int rows = pscan_even_div(M, C);
  if (M - (C - 1) * rows < 2) return g;
  int n = 1, chunk = rows;   // several chunks: a multiple of 4 rows each
  while (2 * chunk * row_bytes > kPscanRingBytes)
    chunk = (pscan_even_div(rows, ++n) + 3) & ~3;
  const int chunks = (rows + chunk - 1) / chunk;
  if (chunks > 1 && reps > 1) return g;   // a step's Q would be read reps times
  int stages = (int)(kPscanRingBytes / (chunk * row_bytes));
  if (stages > kPscanMaxStages) stages = kPscanMaxStages;
  int groups = kPscanThreads / M;   // the reverse's: whole quads of rows
  if (groups > (rows + 3) / 4) groups = (rows + 3) / 4;
  const long state = reverse ? 2L * C * groups * V * rows + V * ((rows + 3L) & ~3L)
                             : 2L * V * M;
  const long bytes =
      4 * (kPscanHeadFloats + (long)stages * chunk * M + state);
  if (bytes > kPscanSmemMax) return g;
  g.cluster = C;
  g.rows = rows;
  g.chunk = chunk;
  g.chunks = chunks;
  g.stages = stages;
  g.groups = groups;
  g.smem = (int)bytes;
  return g;
}

// The wide reverse's shared memory: the staged lam [V][M], the groups'
// partials [G][V][own] and the owned columns' mu [V][own].
inline long pscan_wide_reverse_bytes(int M, int V, int own, int G) {
  return 4L * V * (M + (long)G * own + own);
}

// The launch of a sweep at M rows, V columns, reps sub-steps a step, on a
// card of `sms` SMs (whatever the number of seeds): the on-chip form where
// it takes the shape, else the form through L2; cluster 0 only where M is
// past what one column's staged state can hold (M > 19,370 in the
// reverse).
inline PscanGeometry pscan_geometry(int M, int V, int reps, bool reverse,
                                    int sms) {
  PscanGeometry g = {};
  if (M < 1 || V < 1 || reps < 1 || sms < 1) return g;
  int tiles = (V + kPscanMaxV - 1) / kPscanMaxV;
  int vt = (V + tiles - 1) / tiles;
  g = pscan_on_chip(M, vt, reps, reverse);
  if (g.cluster) {
    g.vt = vt;
    g.tiles = tiles;
    return g;
  }
  // the widest tile whose staging fits whatever the group (the reverse's
  // partials: G x own <= max(512, M))
  const long per_col =
      reverse ? pscan_wide_reverse_bytes(M, 1, M > kPscanThreads ? M
                                                                 : kPscanThreads,
                                         1)
              : 4L * M;
  const long fit = kPscanSmemMax / per_col;
  if (fit < 1) return g;
  if (vt > fit) {
    tiles = (int)((V + fit - 1) / fit);
    vt = (V + tiles - 1) / tiles;
  }
  long C = (M + kPscanWideRows - 1) / kPscanWideRows;
  if (C > sms) C = sms;
  const int own = (int)((M + C - 1) / C);
  C = (M + own - 1) / own;   // no block without rows
  int G = own >= kPscanThreads ? 1 : kPscanThreads / own;
  if (G > M) G = M;
  g.cluster = (int)C;
  g.rows = own;
  g.groups = G;
  g.smem = (int)(reverse ? pscan_wide_reverse_bytes(M, vt, own, G)
                         : 4L * vt * M);
  g.wide = 1;
  g.vt = vt;
  g.tiles = tiles;
  return g;
}

// A block's ring: the stage every thread reads next (and the parity of
// its barrier's phase), and, in the issuing thread (the block's last: its
// warp has the fewest rows), the next load to issue.  Loads
// run over the walk's steps in order (backwards for the reverse), each
// step's slab in chunks.  Counters, not divisions: a 64-bit division in
// the step loop costs every warp hundreds of instructions a sub-step.
struct PscanRing {
  unsigned long long* full;
  float* buf;
  const float* Q;        // the block's slab of step 0
  long step_floats;      // M * M
  int M, T, chunk, stages, nrows, nchunks;
  bool backwards;
  int stage = 0;         // the stage to read next
  unsigned phase = 0;    // the parity of its barrier's phase
  int walk = 0, c = 0;   // issuer: the next load's step (in walk order)
  long left = 0;         // and the loads left to issue

  __device__ int chunk_rows(int k) const {
    const int rest = nrows - k * chunk;
    return rest < chunk ? rest : chunk;
  }
  __device__ const float* current() const {
    return buf + stage * chunk * M;
  }
  __device__ void wait() const { mbar_wait(&full[stage], phase); }
  // issuer: the next load into stage s
  __device__ void issue(int s) {
    if (left == 0) return;
    --left;
    const long t = backwards ? T - 1 - walk : walk;
    bulk_load(buf + s * chunk * M, Q + t * step_floats + (long)c * chunk * M,
              (unsigned)(chunk_rows(c) * M * 4), &full[s]);
    if (++c == nchunks) {
      c = 0;
      ++walk;
    }
  }
  // after a barrier that every reader of the current stage has passed:
  // the issuer refills it, and every thread moves to the next
  __device__ void release() {
    if (threadIdx.x == kPscanIssuer) issue(stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The block's ring over shared memory from `smem` on, its first loads in
// flight.
__device__ inline PscanRing pscan_ring(float* smem, const float* Q,
                                       const PscanGeometry& geo, int M, int T,
                                       int nrows, bool backwards) {
  PscanRing ring;
  ring.full = reinterpret_cast<unsigned long long*>(smem);
  ring.buf = smem + kPscanHeadFloats;
  ring.Q = Q;
  ring.step_floats = (long)M * M;
  ring.M = M;
  ring.T = T;
  ring.chunk = geo.chunk;
  ring.stages = geo.stages;
  ring.nrows = nrows;
  ring.nchunks = (nrows + geo.chunk - 1) / geo.chunk;
  ring.backwards = backwards;
  if (threadIdx.x == kPscanIssuer) {
    ring.left = (long)T * ring.nchunks;
    for (int s = 0; s < geo.stages; ++s) mbar_init(&ring.full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < geo.stages; ++s) ring.issue(s);
  }
  return ring;
}

// The end of a sub-step: every block of the cluster (one block: every
// thread) has written what the next sub-step reads.
__device__ __forceinline__ void pscan_barrier(int C) {
  if (C > 1)
    cluster_sync();
  else
    __syncthreads();
}

// Each lane's partial sums of R rows -> every lane's acc[0] holds the
// total over the warp of row lane / (32 / R): log2(R) rounds that halve
// the rows a lane keeps (a lane sends the half its partner keeps), then
// xor rounds over the lanes that share a row.  A fixed order: every lane
// of a row gets the same bits.
template <int R, int V>
__device__ __forceinline__ void pscan_rows_reduce(float (&acc)[R][V],
                                                  int lane) {
#pragma unroll
  for (int half = R / 2, o = 16; half >= 1; half /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float send = upper ? acc[i][v] : acc[i + half][v];
        const float keep = upper ? acc[i + half][v] : acc[i][v];
        acc[i][v] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
#pragma unroll
  for (int o = 16 / R; o >= 1; o /= 2)
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[0][v] += __shfl_xor_sync(0xffffffffu, acc[0][v], o);
}

// W consecutive floats from shared memory (aligned to W floats)
template <int W>
__device__ __forceinline__ void load_w(float (&d)[W], const float* p);
template <>
__device__ __forceinline__ void load_w<4>(float (&d)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  d[0] = f.x;
  d[1] = f.y;
  d[2] = f.z;
  d[3] = f.w;
}
template <>
__device__ __forceinline__ void load_w<2>(float (&d)[2], const float* p) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  d[0] = f.x;
  d[1] = f.y;
}
template <>
__device__ __forceinline__ void load_w<1>(float (&d)[1], const float* p) {
  d[0] = *p;
}

// the same from device memory, through the read-only path (Q)
template <int W>
__device__ __forceinline__ void load_q(float (&d)[W], const float* p);
template <>
__device__ __forceinline__ void load_q<4>(float (&d)[4], const float* p) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = f.x;
  d[1] = f.y;
  d[2] = f.z;
  d[3] = f.w;
}
template <>
__device__ __forceinline__ void load_q<2>(float (&d)[2], const float* p) {
  const float2 f = __ldg(reinterpret_cast<const float2*>(p));
  d[0] = f.x;
  d[1] = f.y;
}
template <>
__device__ __forceinline__ void load_q<1>(float (&d)[1], const float* p) {
  d[0] = __ldg(p);
}

// W: the floats a lane reads at once (4 where M % 4 == 0, else 2); R: the
// rows a warp sums at once (fewer at larger V, for registers).
template <int V, int W>
__global__ void __launch_bounds__(kPscanThreads, 1)
    pscan_forward_kernel(const float* __restrict__ Q, long q_seed,
                         const float* __restrict__ psi0, long x_seed,
                         float* __restrict__ vecs, int T, int M, int Vf,
                         int reps, PscanGeometry geo) {
  extern __shared__ __align__(128) float smem[];
  const int C = geo.cluster;
  const unsigned rank = cluster_rank();
  const long tile = blockIdx.x / C;
  const long seed = tile / geo.tiles;
  const int v0 = (int)(tile % geo.tiles) * V, vw = min(V, Vf - v0);
  const int r0 = (int)rank * geo.rows;
  const int nrows = min(geo.rows, M - r0);
  const long step = (long)M * Vf;
  Q += seed * q_seed + (long)r0 * M;
  psi0 += seed * x_seed + v0;
  vecs += seed * ((long)T * reps + 1) * step + v0;
  PscanRing ring = pscan_ring(smem, Q, geo, M, T, nrows, false);
  float* psi = smem + kPscanHeadFloats + geo.stages * geo.chunk * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int R = V <= 2 ? 8 : 4, L = 32 / R;

  // the tile's columns (a column past the last one repeats it)
  for (int i = tid; i < M * V; i += kPscanThreads)
    psi[(i % V) * M + i / V] = psi0[(long)(i / V) * Vf + min(i % V, vw - 1)];
  for (int i = tid; i < nrows * V; i += kPscanThreads)
    if (i % V < vw)
      vecs[(long)(r0 + i / V) * Vf + i % V] =
          psi0[(long)(r0 + i / V) * Vf + i % V];
  pscan_barrier(C);   // the peers' shared memory is live before any store

  int cur = 0;
  float* out = vecs;
  for (int t = 0; t < T; ++t) {
    for (int rep = 0; rep < reps; ++rep) {
      const float* x = psi + cur * V * M;
      float* nxt = psi + (cur ^ 1) * V * M;
      out += step;
      for (int c = 0; c < ring.nchunks; ++c) {
        if (rep == 0) ring.wait();
        const float* q = ring.current();
        const int rows = ring.chunk_rows(c), row0 = r0 + c * geo.chunk;
        for (int rb = warp * R; rb < rows; rb += kPscanWarps * R) {
          float acc[R][V];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
          for (int j = W * lane; j < M; j += 32 * W) {
            float xv[V][W];
#pragma unroll
            for (int v = 0; v < V; ++v) load_w<W>(xv[v], x + v * M + j);
            float a[R][W];   // rows past the chunk read its last row
#pragma unroll
            for (int i = 0; i < R; ++i)
              load_w<W>(a[i], q + min(rb + i, rows - 1) * M + j);
#pragma unroll
            for (int w = 0; w < W; ++w)
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[i][v] = fmaf(a[i][w], xv[v][w], acc[i][v]);
          }
          pscan_rows_reduce<R, V>(acc, lane);
          const int i = lane / L, qd = lane % L, row = row0 + rb + i;
          if (rb + i < rows) {
            if (C == 1) {
              if (qd == 0) {
#pragma unroll
                for (int v = 0; v < V; ++v) nxt[v * M + row] = acc[0][v];
              }
            } else {
              for (int pr = qd; pr < C; pr += L) {
                float* dst = cluster_peer(nxt, (unsigned)pr);
#pragma unroll
                for (int v = 0; v < V; ++v) dst[v * M + row] = acc[0][v];
              }
            }
          }
        }
        if (ring.nchunks > 1) {   // reps is 1: the stage is free once read
          __syncthreads();
          ring.release();
        }
      }
      pscan_barrier(C);
      if (ring.nchunks == 1 && rep == reps - 1) ring.release();
      // the slab's rows of the new state into vecs, after the barrier (a
      // cluster barrier waits for the global stores issued before it)
      for (int i = tid; i < nrows * V; i += kPscanThreads)
        if (i % V < vw)
          out[(long)(r0 + i / V) * Vf + i % V] = nxt[(i % V) * M + r0 + i / V];
      cur ^= 1;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kPscanThreads, 1)
    pscan_reverse_kernel(const float* __restrict__ Q, long q_seed,
                         const float* __restrict__ g, long g_seed,
                         float* __restrict__ lams,
                         float* __restrict__ psi0_bar, int T, int M, int Vf,
                         int reps, PscanGeometry geo) {
  extern __shared__ __align__(128) float smem[];
  const int C = geo.cluster, G = geo.groups, ns = geo.rows;
  const unsigned rank = cluster_rank();
  const long tile = blockIdx.x / C;
  const long seed = tile / geo.tiles;
  const int v0 = (int)(tile % geo.tiles) * V, vw = min(V, Vf - v0);
  const int r0 = (int)rank * ns;
  const int nrows = min(ns, M - r0);
  const long P = (long)T * reps, step = (long)M * Vf;
  Q += seed * q_seed + (long)r0 * M;
  g += seed * g_seed + v0;
  lams += seed * P * step + v0;
  psi0_bar += seed * step + v0;
  PscanRing ring = pscan_ring(smem, Q, geo, M, T, nrows, true);
  const int slots = C * G * V * ns;          // one partial buffer
  const int nsp = (ns + 3) & ~3;
  float* lam = smem + kPscanHeadFloats + geo.stages * geo.chunk * M;
  float* part = lam + V * nsp;               // lam [V][nsp], 16-byte rows
  const int tid = threadIdx.x;
  const bool owner = tid < nrows;            // of row r0 + tid
  const int grp = tid / M, j = tid - grp * M;
  const bool summer = grp < G;               // of column j, row group grp
  const int dest = j / ns;                   // the block owning row j
  // each chunk's rows of group grp: [lo, hi) (the last chunk may be short)
  const int last = ring.chunk_rows(ring.nchunks - 1);
  // (group grp's rows: whole quads of the chunk, for 16-byte loads of lam)
  const int quads = (geo.chunk + 3) / 4, quads_last = (last + 3) / 4;
  const int lo = 4 * (grp * quads / G);
  const int hi = min(4 * ((grp + 1) * quads / G), geo.chunk);
  const int lo_last = 4 * (grp * quads_last / G);
  const int hi_last = min(4 * ((grp + 1) * quads_last / G), last);

  float mu[V], gn[V];
  const float* gi = g + P * step;            // g_{i+1} for sub-step i
  float* li = lams + P * step;
  const long at = (long)(r0 + tid) * Vf;     // the owner's row
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mu[v] = 0.f;
    gn[v] = owner ? gi[at + min(v, vw - 1)] : 0.f;
  }
  pscan_barrier(C);   // the peers' shared memory is live before any store

  int par = 0;
  for (int t = T - 1; t >= 0; --t) {
    for (int rep = reps - 1; rep >= 0; --rep) {
      gi -= step;
      li -= step;
      float l[V];
      if (owner) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          l[v] = mu[v] + gn[v];
          lam[v * nsp + tid] = l[v];
          gn[v] = gi[at + min(v, vw - 1)];   // for the next lam
        }
      }
      __syncthreads();
      float acc[4][V];   // four chains over the rows r = 0, 1, 2, 3 mod 4
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
      for (int c = 0; c < ring.nchunks; ++c) {
        if (rep == reps - 1) ring.wait();
        if (summer) {
          const float* q = ring.current() + j;
          const float* lc = lam + c * geo.chunk;
          const bool short_ = c == ring.nchunks - 1;
          const int a = short_ ? lo_last : lo, b = short_ ? hi_last : hi;
          int r = a;
          for (; r + 4 <= b; r += 4) {
            float qv[4], lv[V][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) qv[u] = q[(r + u) * M];
#pragma unroll
            for (int v = 0; v < V; ++v) load_w<4>(lv[v], lc + v * nsp + r);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[u][v] = fmaf(qv[u], lv[v][u], acc[u][v]);
          }
          for (; r < b; ++r) {
            const float qv = q[r * M];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[0][v] = fmaf(qv, lc[v * nsp + r], acc[0][v]);
          }
        }
        if (ring.nchunks > 1) {   // reps is 1: the stage is free once read
          __syncthreads();
          ring.release();
        }
      }
      float* buf = part + par * slots;
      if (summer) {
        float* dst = buf + (rank * G + grp) * V * ns + j - dest * ns;
        if (C > 1) dst = cluster_peer(dst, (unsigned)dest);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float s = (acc[0][v] + acc[1][v]) + (acc[2][v] + acc[3][v]);
          if (C > 1)
            dst[v * ns] = s;
          else
            buf[(grp * V + v) * ns + j] = s;
        }
      }
      pscan_barrier(C);
      if (ring.nchunks == 1 && rep == 0) ring.release();
      if (owner) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v < vw) li[at + v] = l[v];   // after the barrier, as vecs
          float s = 0.f;
          for (int b = 0; b < C * G; ++b) s += buf[(b * V + v) * ns + tid];
          mu[v] = s;
        }
      }
      par ^= 1;
    }
  }
  if (owner) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < vw) psi0_bar[at + v] = mu[v] + gn[v];
  }
}

// The end of a sub-step through L2: every block of the group has written
// what the next sub-step stages (a counter in global memory, `target` the
// arrivals so far; one block: a block barrier).
__device__ __forceinline__ void pscan_group_sync(unsigned* count,
                                                 unsigned& target, int C) {
  __syncthreads();
  if (C == 1) return;
  target += C;
  if (threadIdx.x == 0) {
    __threadfence();   // this block's stores before its arrival
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

// The tile's columns of state `x` ([M][Vf] in device memory, written by
// the group) into xs [V][M] in shared memory, read from L2 (a column past
// the last one repeats it).
template <int V>
__device__ __forceinline__ void pscan_stage(float* xs, const float* x,
                                            int M, int Vf, int vw) {
  for (int i = threadIdx.x; i < M * V; i += kPscanThreads)
    xs[(i % V) * M + i / V] = __ldcg(x + (long)(i / V) * Vf + min(i % V, vw - 1));
}

// Through L2 the grid is `slots` groups of C blocks (every block resident);
// slot k sweeps the seeds' tiles k, k + slots, ... in turn, so what a
// group computes, and its bits, do not depend on how many seeds share
// the launch.
template <int V, int W>
__global__ void __launch_bounds__(kPscanThreads, 1)
    pscan_forward_wide_kernel(const float* __restrict__ Q, long q_seed,
                              const float* __restrict__ psi0, long x_seed,
                              float* __restrict__ vecs,
                              unsigned* __restrict__ count, int B, int T,
                              int M, int Vf, int reps, PscanGeometry geo) {
  extern __shared__ __align__(128) float smem[];
  float* xs = smem;   // [V][M]: the state a sub-step reads
  const int C = geo.cluster;
  const int slot = blockIdx.x / C, slots = gridDim.x / C;
  const int r0 = (int)(blockIdx.x % C) * geo.rows;
  const int r1 = min(r0 + geo.rows, M);
  const long step = (long)M * Vf;
  if (count) count += slot;
  unsigned target = 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long tile = slot; tile < (long)B * geo.tiles; tile += slots) {
    const long seed = tile / geo.tiles;
    const int v0 = (int)(tile % geo.tiles) * V, vw = min(V, Vf - v0);
    const float* Qs = Q + seed * q_seed;
    const float* x0 = psi0 + seed * x_seed + v0;
    float* x = vecs + seed * ((long)T * reps + 1) * step + v0;
    for (int i = tid; i < (r1 - r0) * V; i += kPscanThreads)
      if (i % V < vw)
        x[(long)(r0 + i / V) * Vf + i % V] = x0[(long)(r0 + i / V) * Vf + i % V];
    pscan_group_sync(count, target, C);

    for (int t = 0; t < T; ++t) {
      const float* q = Qs + (long)t * M * M;
      for (int rep = 0; rep < reps; ++rep, x += step) {
        pscan_stage<V>(xs, x, M, Vf, vw);
        __syncthreads();
        for (int row = r0 + warp; row < r1; row += kPscanWarps) {
          const float* qr = q + (long)row * M;
          float acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
          for (int j = W * lane; j < M; j += 32 * W) {
            float a[W], xv[V][W];
            load_q<W>(a, qr + j);
#pragma unroll
            for (int v = 0; v < V; ++v) load_w<W>(xv[v], xs + v * M + j);
#pragma unroll
            for (int w = 0; w < W; ++w)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[v] = fmaf(a[w], xv[v][w], acc[v]);
          }
#pragma unroll
          for (int o = 16; o >= 1; o /= 2)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
          if (lane == 0) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (v < vw) x[step + (long)row * Vf + v] = acc[v];
          }
        }
        pscan_group_sync(count, target, C);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kPscanThreads, 1)
    pscan_reverse_wide_kernel(const float* __restrict__ Q, long q_seed,
                              const float* __restrict__ g, long g_seed,
                              float* __restrict__ lams,
                              float* __restrict__ psi0_bar,
                              unsigned* __restrict__ count, int B, int T,
                              int M, int Vf, int reps, PscanGeometry geo) {
  extern __shared__ __align__(128) float smem[];
  const int C = geo.cluster, G = geo.groups, ns = geo.rows;
  const int slot = blockIdx.x / C, slots = gridDim.x / C;
  const int c0 = (int)(blockIdx.x % C) * ns;   // the block's columns
  const int ncols = min(ns, M - c0);
  const long P = (long)T * reps, step = (long)M * Vf;
  if (count) count += slot;
  unsigned target = 0;
  float* ls = smem;                    // [V][M]: lam_i, staged
  float* part = ls + V * M;            // [G][V][ns]: the groups' partials
  float* mus = part + G * V * ns;      // [V][ns]: mu on the block's columns
  const int tid = threadIdx.x;
  const int cols = min(ns, kPscanThreads);
  const int grp = tid / cols, c = tid - grp * cols;
  const int rlo = (int)((long)grp * M / G), rhi = (int)((long)(grp + 1) * M / G);

  for (long tile = slot; tile < (long)B * geo.tiles; tile += slots) {
    const long seed = tile / geo.tiles;
    const int v0 = (int)(tile % geo.tiles) * V, vw = min(V, Vf - v0);
    const float* Qs = Q + seed * q_seed + c0;
    const float* gs = g + seed * g_seed + v0;
    // mu = 0 on the block's columns (each thread its own, as below)
    for (int j = tid; j < ncols; j += kPscanThreads)
#pragma unroll
      for (int v = 0; v < V; ++v) mus[v * ns + j] = 0.f;
    const float* gi = gs + P * step;   // g_{i+1} for sub-step i
    float* li = lams + seed * P * step + v0 + P * step;
    for (long i = P - 1; i >= 0; --i) {
      li -= step;
      // the owners' lam_i = mu + g_{i+1}
      for (int j = tid; j < ncols; j += kPscanThreads)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v < vw) {
            const long at = (long)(c0 + j) * Vf + v;
            li[at] = mus[v * ns + j] + gi[at];
          }
      gi -= step;
      pscan_group_sync(count, target, C);
      pscan_stage<V>(ls, li, M, Vf, vw);
      __syncthreads();
      const float* q = Qs + (i / reps) * M * M;
      if (grp < G) {
        for (int j = c; j < ncols; j += cols) {
          const float* qc = q + j;
          float acc[4][V];   // four chains over the rows r = 0, 1, 2, 3 mod 4
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
          int r = rlo;
          for (; r + 8 <= rhi; r += 8) {
            float qv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) qv[u] = __ldg(qc + (long)(r + u) * M);
#pragma unroll
            for (int u = 0; u < 8; ++u)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[u & 3][v] = fmaf(qv[u], ls[v * M + r + u], acc[u & 3][v]);
          }
          for (; r < rhi; ++r) {
            const float qv = __ldg(qc + (long)r * M);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[0][v] = fmaf(qv, ls[v * M + r], acc[0][v]);
          }
#pragma unroll
          for (int v = 0; v < V; ++v)
            part[(grp * V + v) * ns + j] =
                (acc[0][v] + acc[1][v]) + (acc[2][v] + acc[3][v]);
        }
      }
      __syncthreads();
      for (int j = tid; j < ncols; j += kPscanThreads)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float s = 0.f;
          for (int b = 0; b < G; ++b) s += part[(b * V + v) * ns + j];
          mus[v * ns + j] = s;
        }
    }
    float* bar = psi0_bar + seed * step + v0;
    for (int j = tid; j < ncols; j += kPscanThreads)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < vw) {
          const long at = (long)(c0 + j) * Vf + v;
          bar[at] = mus[v * ns + j] + gs[at];
        }
  }
}

}  // namespace qoc
