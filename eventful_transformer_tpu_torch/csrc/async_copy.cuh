// Hopper's asynchronous copies, as inline PTX: mbarriers, the bulk copy
// engine (TMA's cp.async.bulk, one contiguous run of bytes, no tensor map)
// and the fence between the generic and the async proxy. Shared by the
// wgmma GEMM core (gemm_tc.cuh) and the bulk row-copy kernels of rows 18
// (scatter_blend.cu) and 20 (scatter.cu's gather).
//
// A bulk copy moves a multiple of 16 bytes between 16-byte aligned
// addresses. A load from device memory signals its bytes to an mbarrier
// (complete_tx); a store from shared memory joins the issuing thread's bulk
// group, which that thread waits on before the bytes may be overwritten or
// the block may exit (wait_group.read); the grid's end makes them visible.
// Writes by threads to shared memory that a bulk store then reads need
// fence_proxy_async() between them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace etk {

constexpr int kRowCopyMaxStages = 8;  // ring stages of the bulk row-copy kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// mbarrier.init's writes visible to the async proxy (the copies' complete_tx)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ``bytes`` from device memory at ``src`` to shared memory at ``dst``, their
// arrival signalled to the mbarrier ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ``bytes`` from shared memory at ``src`` to device memory at ``dst``, in
// the calling thread's current bulk group (bulk_commit closes it)
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most ``N`` of the calling thread's bulk groups still read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}


// Orders the calling thread's shared-memory accesses through the generic
// proxy (its loads and stores) and the async proxy (bulk copies, TMA, wgmma):
// writes before it visible to bulk copies after it, and the other way.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Raise ``kernel``'s limit of dynamic shared memory to ``bytes`` where a
// launch needs more than the 48 KB a block takes in all by default, and
// only then: a kernel allowed more than it uses may run with more of the
// SM's memory as shared memory and less as L1. ``limit`` is the call
// site's record of the limit (0 before its first call). Returns the CUDA
// error, 0 on success.
template <typename Kernel>
int fit_dynamic_smem(Kernel kernel, size_t bytes, size_t& limit) {
  cudaError_t err = cudaSuccess;
  if (limit == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    limit = 48 * 1024 - attr.sharedSizeBytes;
  }
  if (bytes <= limit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) limit = bytes;
  return (int)err;
}

}  // namespace etk
