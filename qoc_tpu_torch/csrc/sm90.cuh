// Hopper (sm_90) device helpers: asynchronous global -> shared copies
// (cp.async, with zero fill: a copy whose source is out of range reads
// nothing and writes zeros), thread block clusters (rank, size, the
// cluster barrier and reads of another block's shared memory), and bulk
// copies that complete on transaction barriers (mbarrier).

#pragma once

#include <cuda_runtime.h>

namespace qoc {

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only (a staged slice is read once per block)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes (the transposing copies)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This block's rank in its cluster, and the cluster's blocks (1 for a
// launch without clusters).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The address of `p` (this block's shared memory) in the shared memory of
// the cluster's block `rank` (distributed shared memory): a generic
// pointer that plain loads read through the cluster's network.
template <class T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// Every thread of the cluster's blocks: what each wrote before (global and
// shared memory) is visible to all after (release / acquire at cluster
// scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Transaction barriers (mbarrier) and bulk copies (cp.async.bulk, the
// copy engine's contiguous form of TMA).  A barrier in shared memory
// counts arrivals and bytes; a phase ends when both reach what was set.
__device__ __forceinline__ unsigned smem_addr(const unsigned long long* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread, before any use (then mbar_init_fence and a barrier).
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: arrive on `bar` expecting `bytes`, and copy them from global
// memory into this block's shared memory; the copy's completion counts the
// bytes.  dst, src and bytes are multiples of 16 bytes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Until the phase of parity `parity` of `bar` has ended; what the phase's
// copies wrote is then visible to the caller.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

}  // namespace qoc
