// Hopper bulk-copy helpers shared by the direct-access kernels: mbarriers
// that count bytes, 1-D bulk copies (cp.async.bulk) and 2- to 4-D tensor
// copies (TMA, cp.async.bulk.tensor) from global memory into shared memory,
// a 3-D tensor copy multicast to the CTAs of a thread-block cluster, the
// cluster's barrier and remote mbarrier arrivals, and the host-side
// encoding of tensor maps.  Global memory here includes
// pinned host memory mapped into the device: under unified addressing a
// bulk or tensor copy reads it over the host link like any other address.
//
// `cuTensorMapEncodeTiled` is a driver function; it is fetched through the
// runtime's driver entry point, so no library needs `-lcuda`.
#pragma once

#include <cuda.h>

#include "dak_common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival (the thread that also posts the byte count) per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and announce `bytes` of copies that will complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with parity `parity` of `bar` has completed.  A copy
// that never completes (a byte count that does not match what was issued)
// traps after some seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// A plain arrival (no byte count), for phases whose data threads store
// themselves; it releases their earlier shared-memory stores to the waiters.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* smem_dst, const void* gmem_src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of `tmap` at (column c0, row c1) into shared memory, completing on
// `bar`; rows past the tensor's edge arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* smem_dst, const CUtensorMap* tmap, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a 3-D or 4-D map at coordinates (c0 innermost, ...): elements
// past the map's bounds arrive as zeros and are not read, and the whole
// box's bytes count toward `bar`'s transaction.
__device__ __forceinline__ void tma_load_3d(void* smem_dst, const CUtensorMap* tmap, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* smem_dst, const CUtensorMap* tmap, int c0,
                                            int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box of a 3-D map at (c0, c1, c2) into shared memory at the same
// CTA-relative offset in every CTA of the cluster whose bit is set in
// `cta_mask` (bit r is cluster rank r), read from global memory once; the
// bytes complete on the mbarrier at `bar`'s offset in each of those CTAs.
__device__ __forceinline__ void tma_load_3d_multicast(void* smem_dst, const CUtensorMap* tmap,
                                                      int c0, int c1, int c2, uint64_t* bar,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "h"(cta_mask), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every CTA of the cluster arrives, then waits for all;
// shared-memory writes and mbarrier arrivals before it are visible after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar`'s offset in the shared memory of
// cluster rank `cta`.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

typedef CUresult (*dak_encode_tiled_fn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                        const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                        const cuuint32_t*, CUtensorMapInterleave,
                                        CUtensorMapSwizzle, CUtensorMapL2promotion,
                                        CUtensorMapFloatOOBfill);

// A tensor of `rank` (2..5) dimensions of 2- or 4-byte elements, dims[0]
// innermost and contiguous, dimension i > 0 `pitch_bytes[i - 1]` bytes
// apart, read in boxes of box[0] x ...; bytes past the bounds are filled
// with zeros.  With CU_TENSOR_MAP_SWIZZLE_128B (a box row of 128 bytes, a
// destination aligned to 1024 bytes) the 16-byte piece j of box row r
// lands at piece j ^ (r % 8) of that row.  Returns 0 or DAK_ERR_TENSOR_MAP.
static inline int dak_encode(CUtensorMap* map, const void* base, int elem_bytes, int rank,
                             const uint64_t* dims, const uint64_t* pitch_bytes,
                             const uint32_t* box,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  static dak_encode_tiled_fn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      cudaGetLastError();
      return DAK_ERR_TENSOR_MAP;
    }
    encode = reinterpret_cast<dak_encode_tiled_fn>(fn);
  }
  if ((elem_bytes != 2 && elem_bytes != 4) || rank < 2 || rank > 5) return DAK_ERR_TENSOR_MAP;
  const CUtensorMapDataType type =
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) st[i] = pitch_bytes[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), d, st, bx, es,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : DAK_ERR_TENSOR_MAP;
}

// A row-major [rows, cols] matrix whose rows are `pitch_bytes` apart, read
// in boxes of box_rows x box_cols.
static inline int dak_encode_2d(CUtensorMap* map, const void* base, int elem_bytes,
                                uint64_t cols, uint64_t rows, uint64_t pitch_bytes,
                                uint32_t box_cols, uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows};
  const uint32_t box[2] = {box_cols, box_rows};
  return dak_encode(map, base, elem_bytes, 2, dims, &pitch_bytes, box);
}
