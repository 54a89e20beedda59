// SplitK_GEMM on Hopper: y[M, N_loc+N_rem] = x[M,K] @ [w_local | w_remote].
//
// Replaces: src/repro/kernels/splitk_gemm.py `_kernel` (pallas_call at :180,
// wrapper `splitk_gemm` :133), reached through `ops.tiered_matmul`.
//
// Bound on this card: bytes.  A decode step multiplies a handful of rows
// (M = live batch) by every weight once, so each weight byte feeds M
// multiply-adds, far below the ~295 FLOP/byte an H100 needs before its
// math units are the limit.  Local tiles stream from HBM (3.35 TB/s);
// remote tiles stream from pinned host memory over the PCIe host link
// (64 GB/s nominal for Gen5 x16), so the remote tier's bytes over the link
// rate is the floor, and the local tier finishes long before it.
//
// What the design does about it:
//  * Direct access: a remote tile reads its K-chunks straight from the
//    mapped host pointer into shared memory (cp.async), never staging the
//    remote tier into HBM.  Each output tile reads only its home tier.
//  * Host-first order: blockIdx.x < n_rem_tiles are the remote tiles, so
//    the hardware issues the long-latency host reads first and the local
//    tiles fill the SMs behind them (`host_first_order` in the reference).
//  * `window` is the depth of the shared-memory ring: up to `window`
//    K-chunks of a tile are in flight at once (cp.async commit/wait groups),
//    the congestion window of the paper mapped onto one CTA.
//  * Each weight byte is read once per m-tile: BM = 16 covers a decode
//    batch in one m-tile, BM = 64 or 128 a whole-prompt prefill of up to
//    that many tokens; longer prompts re-read the weight ceil(M/128) times.
//  * Plain FMA into fp32 registers: at these intensities the math is not
//    the limit, so wgmma/TMA wait for a later change.
// Ragged M, N and K edges are masked here (zero-filled cp.async); a tier
// may be empty.
#include "dak_common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int TN = 4;                 // output columns per thread
constexpr int COL_THREADS = BN / TN;  // 16 threads across a tile's columns
constexpr int ROW_GROUPS = THREADS / COL_THREADS;  // 16

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS) splitk_gemm_kernel(
    const T* __restrict__ x,    // [M, K] device
    const T* __restrict__ wl,   // [K, n_loc] device
    const T* __restrict__ wr,   // [K, n_rem] mapped host
    T* __restrict__ y,          // [M, n_loc + n_rem] device
    int M, int K, int n_loc, int n_rem, int n_rem_tiles, int stages) {
  constexpr int RM = BM / ROW_GROUPS;   // output rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [stages][BM][BK]
  T* ws = xs + stages * BM * BK;             // [stages][BK][BN]

  const int tile = blockIdx.x;
  const bool remote = tile < n_rem_tiles;
  const T* __restrict__ w = remote ? wr : wl;
  const int n_w = remote ? n_rem : n_loc;
  const int col0 = (remote ? tile : tile - n_rem_tiles) * BN;   // within the tier
  const int out_col0 = (remote ? n_loc : 0) + col0;
  const int ldy = n_loc + n_rem;
  const int m0 = blockIdx.y * BM;
  const int n_k = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  auto load_stage = [&](int kk, int slot) {
    const int k0 = kk * BK;
    T* xd = xs + slot * BM * BK;
    T* wd = ws + slot * BK * BN;
    if constexpr (VEC) {
      constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte copy
      for (int c = tid; c < BM * BK / EPC; c += THREADS) {
        const int r = c / (BK / EPC), cc = (c % (BK / EPC)) * EPC;
        const int gm = m0 + r, gk = k0 + cc;
        const bool ok = gm < M && gk < K;
        cp_async_16(xd + r * BK + cc, ok ? x + (size_t)gm * K + gk : x, ok ? 16 : 0);
      }
      for (int c = tid; c < BK * BN / EPC; c += THREADS) {
        const int r = c / (BN / EPC), cc = (c % (BN / EPC)) * EPC;
        const int gk = k0 + r, gn = col0 + cc;
        const bool ok = gk < K && gn < n_w;
        cp_async_16(wd + r * BN + cc, ok ? w + (size_t)gk * n_w + gn : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, cc = e % BK;
        const int gm = m0 + r, gk = k0 + cc;
        xd[e] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : from_f32<T>(0.f);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, cc = e % BN;
        const int gk = k0 + r, gn = col0 + cc;
        wd[e] = (gk < K && gn < n_w) ? w[(size_t)gk * n_w + gn] : from_f32<T>(0.f);
      }
    }
  };

  // Prologue: fill the window.  One commit group per stage, empty ones
  // included, so the wait count below is the same on every iteration.
  for (int s = 0; s < stages; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  const int tx = tid % COL_THREADS, ty = tid / COL_THREADS;
  float acc[RM][TN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int kk = 0; kk < n_k; ++kk) {
    const int slot = kk % stages;
    cp_async_wait(stages - 1);   // chunk kk has landed
    __syncthreads();
    const T* xd = xs + slot * BM * BK;
    const T* wd = ws + slot * BK * BN;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[TN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = to_f32(xd[(ty * RM + r) * BK + k]);
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = to_f32(wd[k * BN + tx * TN + c]);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();             // everyone is done with this slot
    if (kk + stages < n_k) load_stage(kk + stages, slot);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int gm = m0 + ty * RM + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = col0 + tx * TN + c;
      if (gn < n_w) y[(size_t)gm * ldy + out_col0 + tx * TN + c] = from_f32<T>(acc[r][c]);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int BM, bool VEC>
int launch(const T* x, const T* wl, const T* wr, T* y, int M, int K, int n_loc,
           int n_rem, int stages, cudaStream_t stream) {
  const int n_loc_tiles = (n_loc + BN - 1) / BN, n_rem_tiles = (n_rem + BN - 1) / BN;
  const size_t smem = (size_t)stages * (BM * BK + BK * BN) * sizeof(T);
  auto kern = splitk_gemm_kernel<T, BM, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_loc_tiles + n_rem_tiles, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(x, wl, wr, y, M, K, n_loc, n_rem,
                                        n_rem_tiles, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wl, const void* wr, void* y, int M, int K,
             int n_loc, int n_rem, int stages, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  const bool vec = K % EPC == 0 && n_loc % EPC == 0 && n_rem % EPC == 0 &&
                   aligned16(x) && aligned16(wl) && aligned16(wr);
  const T* xt = static_cast<const T*>(x);
  const T* wlt = static_cast<const T*>(wl);
  const T* wrt = static_cast<const T*>(wr);
  T* yt = static_cast<T*>(y);
  if (M <= 16)
    return vec ? launch<T, 16, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
               : launch<T, 16, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
  if (M <= 64)
    return vec ? launch<T, 64, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
               : launch<T, 64, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
  return vec ? launch<T, 128, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
             : launch<T, 128, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  w_remote must be mapped host memory
// when n_rem > 0.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_gemm(const void* x, const void* w_local, const void* w_remote,
                               void* y, int M, int K, int n_loc, int n_rem, int window,
                               int dtype, void* stream) {
  if (M <= 0 || K <= 0 || n_loc < 0 || n_rem < 0 || n_loc + n_rem <= 0 || window < 1 ||
      (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* wr = nullptr;
  if (n_rem > 0) {
    const int e = dak_mapped_host_ptr(w_remote, &wr);
    if (e) return e;
  }
  const void* wl = n_loc > 0 ? w_local : nullptr;
  const int n_k = (K + BK - 1) / BK;
  int stages = window < n_k ? window : n_k;
  if (stages > DAK_MAX_WINDOW) stages = DAK_MAX_WINDOW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(x, wl, wr, y, M, K, n_loc, n_rem, stages, s)
                    : dispatch<__nv_bfloat16>(x, wl, wr, y, M, K, n_loc, n_rem, stages, s);
}
