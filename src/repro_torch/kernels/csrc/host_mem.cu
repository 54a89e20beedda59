// Pinned, device-mapped host memory for the remote tier.
//
// Not a kernel: the allocation behind `kernels._build.pinned_empty`.  Each
// remote tier gets one cudaHostAlloc of exactly its size (mapped, portable),
// instead of the caching host allocator's power-of-two blocks, which would
// pin far more host memory than a model's remote weights need.
#include "dak_common.cuh"

extern "C" int dak_host_alloc(size_t bytes, void** out) {
  return cudaHostAlloc(out, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
}

extern "C" int dak_host_free(void* ptr) { return cudaFreeHost(ptr); }

// 0 when `ptr` is host memory mapped into the device's address space.
extern "C" int dak_check_mapped(const void* ptr) {
  const void* dev = nullptr;
  return dak_mapped_host_ptr(ptr, &dev);
}
