// Shared helpers for the direct-access kernels: cp.async (Ampere+ async
// global->shared copies, 16 bytes per thread, zero-filled past the source
// size), element conversion, and the check that a remote-tier pointer is
// pinned host memory mapped into the device's address space.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Error codes returned to the Python wrappers (besides cudaError_t values,
// which are all positive).
#define DAK_ERR_NOT_MAPPED_HOST (-1)   // remote pointer is not mapped host memory
#define DAK_ERR_BAD_ARGUMENT (-2)      // shape or launch parameter out of range

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src,
                                            int src_bytes) {
  uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` committed groups are still in flight.  The PTX
// operand must be an immediate, so dispatch over the ring depths we allow.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

#define DAK_MAX_WINDOW 8

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The device-side address of a remote-tier buffer.  Under unified virtual
// addressing pinned memory from cudaHostAlloc is mapped at its host address,
// but memory pinned some other way need not be mapped at all, so every
// launch checks: the pointer must be host memory with a device mapping.
static inline int dak_mapped_host_ptr(const void* host_ptr, const void** dev_ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host_ptr);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free error so later checks are clean
    return DAK_ERR_NOT_MAPPED_HOST;
  }
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return DAK_ERR_NOT_MAPPED_HOST;
  *dev_ptr = attr.devicePointer;
  return 0;
}
