// Host-link read probe: how fast can kernels read pinned, device-mapped host
// memory, and what does the rate depend on?
//
// Not a port of a TPU kernel and not on any serving path: a measurement
// kernel that `chip_smoke.py` sweeps to choose how the direct-access
// kernels read their remote tier.  It reads a [rows, pitch] byte matrix
// (the shape of a remote weight tier, K rows of N columns) once, in chunks of
// `row_bytes`-wide column strips, `stage_bytes` per chunk, through a ring of
// STAGES chunks per CTA, so each CTA keeps up to STAGES * stage_bytes in
// flight.  Chunks (strip fastest) go to the CTAs either round robin, so all
// CTAs walk down the rows together as a whole-K GEMM's tiles do, or as one
// contiguous run per CTA, so the CTAs read far-apart rows at once as the
// pieces of a K split do.  Three copy forms:
//   0  cp.async, 16 bytes per thread per copy (as the whole-K GEMM tiles read);
//   1  cp.async.bulk, one 1-D bulk copy per row of a chunk;
//   2  cp.async.bulk.tensor, one 2-D TMA box per chunk.
// Every landed chunk is summed as 32-bit words into a 64-bit checksum, so
// the caller can tell that each form read every byte.
#include "tma.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int THREADS = 128;

template <int FORM>
__global__ void __launch_bounds__(THREADS) host_probe_kernel(
    __grid_constant__ const CUtensorMap tmap, const unsigned char* __restrict__ buf, int rows,
    int pitch, int row_bytes, int stage_bytes, int contiguous, unsigned long long* checksum) {
  extern __shared__ __align__(128) unsigned char smem[];     // [STAGES][stage_bytes], bars
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes);
  const int tid = threadIdx.x;
  const int rps = stage_bytes / row_bytes;         // rows per chunk
  const int n_strips = pitch / row_bytes;
  const int n_chunks = n_strips * (rows / rps);
  const int per_cta = (n_chunks + gridDim.x - 1) / gridDim.x;   // contiguous runs
  const int first = blockIdx.x * per_cta;
  const int n_mine =
      contiguous ? (first >= n_chunks ? 0 : n_chunks - first < per_cta ? n_chunks - first : per_cta)
                 : ((int)blockIdx.x < n_chunks ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0);

  if (FORM != 0 && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto issue = [&](int i) {       // the CTA's i-th chunk into stage i % STAGES
    const int c = contiguous ? first + i : blockIdx.x + i * gridDim.x;
    const int strip = c % n_strips, rb = c / n_strips;
    unsigned char* dst = smem + (i % STAGES) * stage_bytes;
    const unsigned char* src = buf + (size_t)rb * rps * pitch + (size_t)strip * row_bytes;
    if constexpr (FORM == 0) {
      const int per_row = row_bytes / 16;
      for (int p = tid; p < stage_bytes / 16; p += THREADS)
        cp_async_16(dst + p * 16, src + (size_t)(p / per_row) * pitch + (p % per_row) * 16, 16);
    } else if (tid < 32) {
      uint64_t* bar = &bars[i % STAGES];
      if (tid == 0) mbar_expect_tx(bar, stage_bytes);
      __syncwarp();
      if constexpr (FORM == 1) {
        for (int r = tid; r < rps; r += 32)
          bulk_copy_g2s(dst + r * row_bytes, src + (size_t)r * pitch, row_bytes, bar);
      } else {
        if (tid == 0) tma_load_2d(dst, &tmap, strip * row_bytes / 4, rb * rps, bar);
      }
    }
  };

  for (int i = 0; i < STAGES; ++i) {
    if (i < n_mine) issue(i);
    if constexpr (FORM == 0) cp_async_commit();
  }
  unsigned long long sum = 0;
  for (int i = 0; i < n_mine; ++i) {
    if constexpr (FORM == 0) {
      cp_async_wait(STAGES - 1);
    } else {
      mbar_wait(&bars[i % STAGES], (i / STAGES) & 1);
    }
    __syncthreads();
    const uint32_t* words = reinterpret_cast<const uint32_t*>(smem + (i % STAGES) * stage_bytes);
    for (int w = tid; w < stage_bytes / 4; w += THREADS) sum += words[w];
    __syncthreads();              // the stage is read; it may be refilled
    if (i + STAGES < n_mine) issue(i + STAGES);
    if constexpr (FORM == 0) cp_async_commit();
  }
  atomicAdd(checksum, sum);
}

}  // namespace

// Read the [rows, pitch]-byte matrix at mapped host pointer `host` once.
// form: 0 cp.async, 1 bulk, 2 TMA; row_bytes a multiple of 16 dividing
// pitch; stage_bytes a multiple of row_bytes whose row count divides rows
// (and is at most 256 for TMA); contiguous: 0 round robin, 1 one run of
// chunks per CTA.  Adds the sum of the matrix's 32-bit words
// to *checksum (device memory).  Returns 0, a cudaError_t, or DAK_ERR_*.
extern "C" int dak_host_read_probe(const void* host, int rows, int pitch, int form, int ctas,
                                   int row_bytes, int stage_bytes, int contiguous,
                                   unsigned long long* checksum, void* stream) {
  if (rows <= 0 || pitch <= 0 || ctas <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      pitch % row_bytes || stage_bytes % row_bytes || rows % (stage_bytes / row_bytes) ||
      form < 0 || form > 2 || (form == 2 && stage_bytes / row_bytes > 256) ||
      (size_t)STAGES * stage_bytes > 200 * 1024)
    return DAK_ERR_BAD_ARGUMENT;
  const void* dev = nullptr;
  if (int e = dak_mapped_host_ptr(host, &dev)) return e;
  CUtensorMap tmap{};
  if (form == 2) {
    // 4-byte elements, so a 512-byte row is a box of 128 (a box side is at most 256)
    if (int e = dak_encode_2d(&tmap, dev, 4, pitch / 4, rows, pitch, row_bytes / 4,
                              stage_bytes / row_bytes))
      return e;
  }
  const size_t smem = (size_t)STAGES * stage_bytes + STAGES * sizeof(uint64_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kern) -> int {
    if (smem > 48 * 1024) {
      cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<ctas, THREADS, smem, s>>>(tmap, static_cast<const unsigned char*>(dev), rows, pitch,
                                     row_bytes, stage_bytes, contiguous, checksum);
    return cudaGetLastError();
  };
  if (form == 0) return run(host_probe_kernel<0>);
  if (form == 1) return run(host_probe_kernel<1>);
  return run(host_probe_kernel<2>);
}
