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
// rate is the floor, and the local tier finishes long before it.  On some
// H100 machines measured, kernels read pinned host memory at 30-33 GB/s at
// most, whatever the copy form, CTA count, bytes in flight or row width,
// 0.58-0.70x the copy engine's 45-54 GB/s on the same buffer; on others at
// ~50 GB/s, 0.95x the copy engine (chip_smoke.py --phases 1,9).  Both
// designs below run at that cap.
//
// Split-K decode (M <= 16; `k_split` > 0).
//  * Direct access: every remote tile reads its weight straight from the
//    mapped host pointer into shared memory, never staging the remote tier
//    in HBM.  Each output tile reads only its home tier.
//  * Split along K: a tile of DBN = 64 columns is cut into
//    ceil(K / k_split) pieces of `k_split` rows (a multiple of DBK), one
//    CTA each, both tiers alike, so a remote tier of a few tiles still
//    puts a CTA per SM and its bytes in flight on the card; the wrapper's
//    `decode_k_split` aims at one remote CTA per SM, and a remote tier of
//    that many tiles takes one split.  Against the whole-K design: level
//    at llama2-7b's offload-0.5 tiers (32-250 remote tiles, within 3%
//    either way), 4-8x faster at a remote tier of 2 tiles (chip_smoke.py
//    phase 5, H100 80GB HBM3, 700 W).
//  * Bulk copies: each load is one TMA box of DBK x DBN weights (128 B
//    contiguous per row in bf16, 4 KB a box) plus the DBK columns of x,
//    through tensor maps encoded on the device pointers (the remote one on
//    the mapped host pointer), completing on one mbarrier per stage.  One
//    thread issues a whole load, so a CTA of 64 threads keeps its loads in
//    flight; issuing the same loads as 16-byte cp.async from every thread
//    of these small CTAs read host memory several times slower in a trial.
//  * `window` is the number of loads in flight per CTA (the paper's
//    congestion window): a ring of `window` stages, each refilled as soon
//    as it is consumed.  It never changes the result.
//  * Host-first order: blockIdx.x below the remote CTA count are remote, so
//    the long-latency host reads are issued first.
//  * Partial sums go to an fp32 workspace [splits][M][N]; the last CTA to
//    arrive on a tile (a ticket counter per tile, reset by that CTA) adds
//    the partials in split order 0, 1, ... and writes y, so the result
//    does not depend on scheduling and the GEMM stays one launch.
//  * Plain FMA into fp32 registers, one output column per thread.
// Whole K (`k_split` == 0: prefill, and decode operands a tensor map cannot
// describe): one CTA per (m-tile, 64 columns), remote tiles first, each
// walking all of K through a `window`-deep cp.async ring of 32-row chunks.
// BM = 64 or 128 covers a whole-prompt prefill of up to that many tokens in
// one m-tile; longer prompts re-read the weight ceil(M/128) times.  Plain
// FMA into fp32 registers.
// Ragged M, N and K edges are masked (TMA and cp.async zero-fill); a tier
// may be empty.
//
// Grouped remote experts (`dak_splitk_gemm_grouped`): y[e] = x[e] @ w[e] for
// every expert e of a remote MoE expert stack [E, K, N] in mapped host
// memory whose routed-slot count is > 0.  The reference computes this block
// with an XLA einsum (src/repro/models/layers.py, `moe_block`), no Pallas
// kernel; here a plain product would stage the experts in HBM, so the block
// is one launch of the split-K decode design over (N tile x K split,
// expert, M tile), the weights and x read through 3-D tensor maps over the
// stacks.  Bound: bytes, the active experts' weights over the host link.
// A CTA whose expert's count is 0 returns before it issues a load, so a
// launch reads no more host memory than one launch per active expert
// would, and the counts never leave the device (a CUDA graph can hold the
// step).  Inactive experts are not packed to the front: their CTAs retire
// at once.  M is cut into tiles of up to 64 rows (MB up to 64), each tile
// re-reading its expert's weights.
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Whole-K tiles (prefill, and decode operands a tensor map cannot describe).
// ---------------------------------------------------------------------------
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

// The M tile each design takes for M rows: the whole-K BM and the split-K
// MB.  The dispatchers and `smem_query` both pick their tiles here.
inline int whole_k_bm(int M) { return M <= 16 ? 16 : M <= 64 ? 64 : 128; }
inline int decode_mb(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16; }

// Ring stages of the whole-K design: `window` chunks in flight, no more
// than K has chunks, at most DAK_MAX_WINDOW.
inline int whole_k_stages(int K, int window) {
  const int n_k = (K + BK - 1) / BK;
  int stages = window < n_k ? window : n_k;
  return stages > DAK_MAX_WINDOW ? DAK_MAX_WINDOW : stages;
}

// Dynamic shared memory of a whole-K launch: `stages` x and w chunks.
template <typename T, int BM>
size_t whole_k_smem(int stages) {
  return (size_t)stages * (BM * BK + BK * BN) * sizeof(T);
}

template <typename T, int BM, bool VEC>
int launch(const T* x, const T* wl, const T* wr, T* y, int M, int K, int n_loc,
           int n_rem, int stages, cudaStream_t stream) {
  const int n_loc_tiles = (n_loc + BN - 1) / BN, n_rem_tiles = (n_rem + BN - 1) / BN;
  const size_t smem = whole_k_smem<T, BM>(stages);
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
  switch (whole_k_bm(M)) {
    case 16:
      return vec ? launch<T, 16, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 16, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
    case 64:
      return vec ? launch<T, 64, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 64, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
    default:
      return vec ? launch<T, 128, true>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 128, false>(xt, wlt, wrt, yt, M, K, n_loc, n_rem, stages, stream);
  }
}


// ---------------------------------------------------------------------------
// Split-K decode tiles.
// ---------------------------------------------------------------------------
constexpr int DBN = 64;               // columns of a decode tile, one per thread
constexpr int DBK = 32;               // rows of a load
constexpr int DTHREADS = DBN;
constexpr size_t DSMEM_MAX = 200 * 1024;

// One load: DBK x DBN weights, then MB x DBK of x.  A stage holds one load,
// rounded up to the 128-byte alignment a TMA destination needs.
template <typename T, int MB>
__host__ __device__ constexpr uint32_t load_bytes() {
  return (uint32_t)((DBK * DBN + MB * DBK) * sizeof(T));
}
template <typename T, int MB>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (load_bytes<T, MB>() + 127) / 128 * 128;
}

// Ring stages of the split-K designs: `window` loads in flight, no more
// than a CTA's split has loads, within DSMEM_MAX.
template <typename T, int MB>
int decode_stages(int K, int window, int k_split) {
  const int max_ld = ((k_split < K ? k_split : K) + DBK - 1) / DBK;
  int stages = window < max_ld ? window : max_ld;
  if (stages < 1) stages = 1;
  constexpr size_t STAGE = stage_bytes<T, MB>();
  if ((size_t)stages * STAGE > DSMEM_MAX) stages = (int)(DSMEM_MAX / STAGE);
  return stages;
}

// Dynamic shared memory of a split-K launch: the ring and one mbarrier a stage.
template <typename T, int MB>
size_t decode_smem(int stages) {
  return (size_t)stages * (stage_bytes<T, MB>() + sizeof(uint64_t));
}

template <typename T, int MB>
__global__ void __launch_bounds__(DTHREADS) splitk_gemm_decode_kernel(
    __grid_constant__ const CUtensorMap x_map,    // x [M, K], box DBK x MB
    __grid_constant__ const CUtensorMap wl_map,   // w_local [K, n_loc], box DBN x DBK
    __grid_constant__ const CUtensorMap wr_map,   // w_remote [K, n_rem] (mapped host)
    T* __restrict__ y, float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
    int n_loc, int n_rem, int n_loc_tiles, int n_rem_tiles, int splits, int k_split,
    int stages) {
  extern __shared__ __align__(128) unsigned char smem[];   // [stages][stage], bars
  constexpr uint32_t STAGE = stage_bytes<T, MB>();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  __shared__ bool last;

  // remote CTAs first; within a tier, the tiles of one split are neighbours
  const int n_rem_ctas = n_rem_tiles * splits;
  const bool remote = (int)blockIdx.x < n_rem_ctas;
  const int idx = remote ? (int)blockIdx.x : (int)blockIdx.x - n_rem_ctas;
  const int n_tiles = remote ? n_rem_tiles : n_loc_tiles;
  const int tile = idx % n_tiles, split = idx / n_tiles;
  const CUtensorMap* w_map = remote ? &wr_map : &wl_map;
  const int n_w = remote ? n_rem : n_loc;
  const int col0 = tile * DBN;                    // within the tier
  const int k_begin = split * k_split;
  const int k_end = k_begin + k_split < K ? k_begin + k_split : K;
  const int n_ld = (k_end - k_begin + DBK - 1) / DBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i) {       // load i of this CTA into stage i % stages
    if (tid != 0) return;
    unsigned char* st = smem + (i % stages) * STAGE;
    uint64_t* bar = &bars[i % stages];
    const int k0 = k_begin + i * DBK;
    mbar_expect_tx(bar, load_bytes<T, MB>());
    tma_load_2d(st, w_map, col0, k0, bar);
    tma_load_2d(st + DBK * DBN * sizeof(T), &x_map, k0, 0, bar);
  };
  for (int i = 0; i < stages && i < n_ld; ++i) issue(i);

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;
  for (int i = 0; i < n_ld; ++i) {
    mbar_wait(&bars[i % stages], (i / stages) & 1);
    const T* w_s = reinterpret_cast<const T*>(smem + (i % stages) * STAGE);
    const T* x_s = w_s + DBK * DBN;             // [MB][DBK]
#pragma unroll 8
    for (int k = 0; k < DBK; ++k) {
      const float w = to_f32(w_s[k * DBN + tid]);
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[m] = fmaf(to_f32(x_s[m * DBK + k]), w, acc[m]);
    }
    __syncthreads();                            // every thread is done with the stage
    if (i + stages < n_ld) issue(i + stages);
  }

  const int col = col0 + tid;
  const int ldy = n_loc + n_rem;
  const int out_col = (remote ? n_loc : 0) + col;
  T* yc = y + out_col;
  if (splits == 1) {
    if (col < n_w) {
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < M) yc[(size_t)m * ldy] = from_f32<T>(acc[m]);
    }
    return;
  }
  // one split of a tile: publish the partial, the last to arrive reduces
  if (col < n_w) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < M) ws[((size_t)split * M + m) * ldy + out_col] = acc[m];
  }
  int* ticket = tickets + (remote ? tile : n_rem_tiles + tile);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col < n_w) {
    for (int m = 0; m < M; ++m) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s) sum += __ldcg(ws + ((size_t)s * M + m) * ldy + out_col);
      yc[(size_t)m * ldy] = from_f32<T>(sum);
    }
  }
  if (tid == 0) *ticket = 0;                    // ready for the next launch
}

template <typename T, int MB>
int launch_decode(const T* x, const T* wl, const T* wr, T* y, float* ws, int* tickets, int M,
                  int K, int n_loc, int n_rem, int window, int k_split, cudaStream_t stream) {
  constexpr int ELEM = sizeof(T);
  CUtensorMap x_map{}, wl_map{}, wr_map{};
  // a tier that is empty gets a map of one box of x (never read)
  if (int e = dak_encode_2d(&x_map, x, ELEM, K, M, (uint64_t)K * ELEM, DBK, MB)) return e;
  if (int e = n_loc ? dak_encode_2d(&wl_map, wl, ELEM, n_loc, K, (uint64_t)n_loc * ELEM, DBN, DBK)
                    : dak_encode_2d(&wl_map, x, ELEM, K, M, (uint64_t)K * ELEM, DBK, MB))
    return e;
  if (int e = n_rem ? dak_encode_2d(&wr_map, wr, ELEM, n_rem, K, (uint64_t)n_rem * ELEM, DBN, DBK)
                    : dak_encode_2d(&wr_map, x, ELEM, K, M, (uint64_t)K * ELEM, DBK, MB))
    return e;
  const int n_loc_tiles = (n_loc + DBN - 1) / DBN, n_rem_tiles = (n_rem + DBN - 1) / DBN;
  const int splits = (K + k_split - 1) / k_split;
  const int stages = decode_stages<T, MB>(K, window, k_split);
  const size_t smem = decode_smem<T, MB>(stages);
  auto kern = splitk_gemm_decode_kernel<T, MB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(n_rem_tiles + n_loc_tiles) * splits, DTHREADS, smem, stream>>>(
      x_map, wl_map, wr_map, y, ws, tickets, M, K, n_loc, n_rem, n_loc_tiles, n_rem_tiles, splits,
      k_split, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_decode(const void* x, const void* wl, const void* wr, void* y, float* ws,
                    int* tickets, int M, int K, int n_loc, int n_rem, int window, int k_split,
                    cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  // tensor maps need 16-byte aligned bases and row pitches
  if (M > 16 || k_split % DBK || K % EPC || n_loc % EPC || n_rem % EPC || !aligned16(x) ||
      (n_loc && !aligned16(wl)) || (n_rem && !aligned16(wr)) ||
      (k_split < K && (ws == nullptr || tickets == nullptr)))
    return DAK_ERR_BAD_ARGUMENT;
  const T* xt = static_cast<const T*>(x);
  const T* wlt = static_cast<const T*>(wl);
  const T* wrt = static_cast<const T*>(wr);
  T* yt = static_cast<T*>(y);
#define DAK_DECODE(MB) \
  launch_decode<T, MB>(xt, wlt, wrt, yt, ws, tickets, M, K, n_loc, n_rem, window, k_split, stream)
  switch (decode_mb(M)) {
    case 1: return DAK_DECODE(1);
    case 2: return DAK_DECODE(2);
    case 4: return DAK_DECODE(4);
    case 8: return DAK_DECODE(8);
    default: return DAK_DECODE(16);
  }
#undef DAK_DECODE
}

// ---------------------------------------------------------------------------
// Grouped remote experts: the split-K decode design over an expert stack.
// ---------------------------------------------------------------------------
constexpr int GROUPED_MAX_MB = 64;   // rows of an M tile of the grouped design

template <typename T, int MB>
__global__ void __launch_bounds__(DTHREADS) splitk_gemm_grouped_kernel(
    __grid_constant__ const CUtensorMap x_map,   // x [E, M, K], box DBK x MB x 1
    __grid_constant__ const CUtensorMap w_map,   // w [E, K, N] (mapped host), box DBN x DBK x 1
    const int* __restrict__ counts, T* __restrict__ y, float* __restrict__ ws,
    int* __restrict__ tickets, int E, int M, int K, int N, int n_tiles, int splits,
    int k_split, int stages) {
  const int e = blockIdx.y;
  if (counts[e] == 0) return;                 // no routed slot: none of its weights is read
  extern __shared__ __align__(128) unsigned char smem[];   // [stages][stage], bars
  constexpr uint32_t STAGE = stage_bytes<T, MB>();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  __shared__ bool last;

  const int tile = (int)blockIdx.x % n_tiles, split = (int)blockIdx.x / n_tiles;
  const int m0 = (int)blockIdx.z * MB;
  const int col0 = tile * DBN;
  const int k_begin = split * k_split;
  const int k_end = k_begin + k_split < K ? k_begin + k_split : K;
  const int n_ld = (k_end - k_begin + DBK - 1) / DBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i) {       // load i of this CTA into stage i % stages
    if (tid != 0) return;
    unsigned char* st = smem + (i % stages) * STAGE;
    uint64_t* bar = &bars[i % stages];
    const int k0 = k_begin + i * DBK;
    mbar_expect_tx(bar, load_bytes<T, MB>());
    tma_load_3d(st, &w_map, col0, k0, e, bar);
    tma_load_3d(st + DBK * DBN * sizeof(T), &x_map, k0, m0, e, bar);
  };
  for (int i = 0; i < stages && i < n_ld; ++i) issue(i);

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;
  for (int i = 0; i < n_ld; ++i) {
    mbar_wait(&bars[i % stages], (i / stages) & 1);
    const T* w_s = reinterpret_cast<const T*>(smem + (i % stages) * STAGE);
    const T* x_s = w_s + DBK * DBN;             // [MB][DBK]
#pragma unroll 8
    for (int k = 0; k < DBK; ++k) {
      const float w = to_f32(w_s[k * DBN + tid]);
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[m] = fmaf(to_f32(x_s[m * DBK + k]), w, acc[m]);
    }
    __syncthreads();                            // every thread is done with the stage
    if (i + stages < n_ld) issue(i + stages);
  }

  const int col = col0 + tid;
  const int rows = M - m0 < MB ? M - m0 : MB;
  T* yc = y + ((size_t)e * M + m0) * N + col;
  if (splits == 1) {
    if (col < N) {
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m < rows) yc[(size_t)m * N] = from_f32<T>(acc[m]);
    }
    return;
  }
  // one split of a tile: publish the partial, the last to arrive reduces
  float* wc = ws + ((size_t)e * M + m0) * N + col;   // split s at s * E * M * N
  const size_t split_stride = (size_t)E * M * N;
  if (col < N) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < rows) wc[split * split_stride + (size_t)m * N] = acc[m];
  }
  int* ticket = tickets + ((size_t)e * gridDim.z + blockIdx.z) * n_tiles + tile;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col < N) {
    for (int m = 0; m < rows; ++m) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s) sum += __ldcg(wc + s * split_stride + (size_t)m * N);
      yc[(size_t)m * N] = from_f32<T>(sum);
    }
  }
  if (tid == 0) *ticket = 0;                    // ready for the next launch
}

template <typename T, int MB>
int launch_grouped(const T* x, const T* w, const int* counts, T* y, float* ws, int* tickets,
                   int E, int M, int K, int N, int window, int k_split, cudaStream_t stream) {
  constexpr int ELEM = sizeof(T);
  CUtensorMap x_map{}, w_map{};
  const uint64_t x_dims[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)E};
  const uint64_t x_pitch[2] = {(uint64_t)K * ELEM, (uint64_t)M * K * ELEM};
  const uint32_t x_box[3] = {DBK, MB, 1};
  if (int err = dak_encode(&x_map, x, ELEM, 3, x_dims, x_pitch, x_box)) return err;
  const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t w_pitch[2] = {(uint64_t)N * ELEM, (uint64_t)K * N * ELEM};
  const uint32_t w_box[3] = {DBN, DBK, 1};
  if (int err = dak_encode(&w_map, w, ELEM, 3, w_dims, w_pitch, w_box)) return err;
  const int n_tiles = (N + DBN - 1) / DBN, m_tiles = (M + MB - 1) / MB;
  const int splits = (K + k_split - 1) / k_split;
  const int stages = decode_stages<T, MB>(K, window, k_split);
  const size_t smem = decode_smem<T, MB>(stages);
  auto kern = splitk_gemm_grouped_kernel<T, MB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_tiles * splits, E, m_tiles);
  kern<<<grid, DTHREADS, smem, stream>>>(x_map, w_map, counts, y, ws, tickets, E, M, K, N,
                                         n_tiles, splits, k_split, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_grouped(const void* x, const void* w, const int* counts, void* y, float* ws,
                     int* tickets, int E, int M, int K, int N, int window, int k_split,
                     cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  // tensor maps need 16-byte aligned bases and row pitches
  if (k_split % DBK || K % EPC || N % EPC || !aligned16(x) || !aligned16(w) ||
      (k_split < K && (ws == nullptr || tickets == nullptr)))
    return DAK_ERR_BAD_ARGUMENT;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
#define DAK_GROUPED(MB) \
  launch_grouped<T, MB>(xt, wt, counts, yt, ws, tickets, E, M, K, N, window, k_split, stream)
  if (M <= 1) return DAK_GROUPED(1);
  if (M <= 2) return DAK_GROUPED(2);
  if (M <= 4) return DAK_GROUPED(4);
  if (M <= 8) return DAK_GROUPED(8);
  if (M <= 16) return DAK_GROUPED(16);
  if (M <= 32) return DAK_GROUPED(32);
  return DAK_GROUPED(GROUPED_MAX_MB);
#undef DAK_GROUPED
}

// The ring stages and dynamic shared memory a dak_splitk_gemm launch of
// these arguments uses, by the launch's own arithmetic and tile choice.
template <typename T>
void smem_query(int M, int K, int window, int k_split, long long* bytes, int* stages) {
  if (k_split > 0) {
#define DAK_QUERY(MB)                                     \
  {                                                       \
    *stages = decode_stages<T, MB>(K, window, k_split);   \
    *bytes = (long long)decode_smem<T, MB>(*stages);      \
    return;                                               \
  }
    switch (decode_mb(M)) {
      case 1: DAK_QUERY(1)
      case 2: DAK_QUERY(2)
      case 4: DAK_QUERY(4)
      case 8: DAK_QUERY(8)
      default: DAK_QUERY(16)
    }
#undef DAK_QUERY
  }
  *stages = whole_k_stages(K, window);
  switch (whole_k_bm(M)) {
    case 16: *bytes = (long long)whole_k_smem<T, 16>(*stages); return;
    case 64: *bytes = (long long)whole_k_smem<T, 64>(*stages); return;
    default: *bytes = (long long)whole_k_smem<T, 128>(*stages); return;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  w_remote must be mapped host memory
// when n_rem > 0.  k_split > 0 takes the split-K decode design (M <= 16,
// k_split a multiple of 32 rows; K, n_loc and n_rem multiples of 16 bytes and
// 16-byte aligned operands; when k_split < K, `workspace` holds
// ceil(K / k_split) * M * (n_loc + n_rem) floats and `tickets`
// ceil(n_loc / 64) + ceil(n_rem / 64) zeroed ints); k_split == 0 the
// whole-K design.  Returns 0, a cudaError_t, or a
// DAK_ERR_* code.
extern "C" int dak_splitk_gemm(const void* x, const void* w_local, const void* w_remote,
                               void* y, int M, int K, int n_loc, int n_rem, int window,
                               int k_split, void* workspace, void* tickets, int dtype,
                               void* stream) {
  if (M <= 0 || K <= 0 || n_loc < 0 || n_rem < 0 || n_loc + n_rem <= 0 || window < 1 ||
      k_split < 0 || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* wr = nullptr;
  if (n_rem > 0) {
    const int e = dak_mapped_host_ptr(w_remote, &wr);
    if (e) return e;
  }
  const void* wl = n_loc > 0 ? w_local : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_split > 0) {
    float* ws = static_cast<float*>(workspace);
    int* tk = static_cast<int*>(tickets);
    return dtype == 0 ? dispatch_decode<float>(x, wl, wr, y, ws, tk, M, K, n_loc, n_rem, window,
                                               k_split, s)
                      : dispatch_decode<__nv_bfloat16>(x, wl, wr, y, ws, tk, M, K, n_loc, n_rem,
                                                       window, k_split, s);
  }
  const int stages = whole_k_stages(K, window);
  return dtype == 0 ? dispatch<float>(x, wl, wr, y, M, K, n_loc, n_rem, stages, s)
                    : dispatch<__nv_bfloat16>(x, wl, wr, y, M, K, n_loc, n_rem, stages, s);
}


// Grouped remote experts: y[e] = x[e] @ w_remote[e] for every e in [0, E)
// with counts[e] > 0 (x [E, M, K] and y [E, M, N] on the device, w_remote
// [E, K, N] mapped host memory, counts [E] int32 on the device).  Rows of
// experts whose count is 0 are not written: the caller zeroes y.  k_split
// is a multiple of 32 rows; K and N multiples of 16 bytes and x and
// w_remote 16-byte aligned; when k_split < K, `workspace` holds
// ceil(K / k_split) * E * M * N floats and `tickets` E * ceil(M / MB) *
// ceil(N / 64) zeroed ints, MB the power of two >= M up to 64.  Returns 0,
// a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_gemm_grouped(const void* x, const void* w_remote, const void* counts,
                                       void* y, int E, int M, int K, int N, int window,
                                       int k_split, void* workspace, void* tickets, int dtype,
                                       void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0 || window < 1 || k_split <= 0 ||
      counts == nullptr || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* w = nullptr;
  if (const int e = dak_mapped_host_ptr(w_remote, &w)) return e;
  const int* c = static_cast<const int*>(counts);
  float* ws = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_grouped<float>(x, w, c, y, ws, tk, E, M, K, N, window, k_split, s)
                    : dispatch_grouped<__nv_bfloat16>(x, w, c, y, ws, tk, E, M, K, N, window,
                                                      k_split, s);
}

// What a dak_splitk_gemm launch with these arguments would hold: its ring
// stages and its dynamic shared memory in bytes (`k_split` > 0 the split-K
// design, which takes M <= 16; 0 whole K).  Launches nothing; the
// wrappers' shared-memory footprints are checked against it.  Returns 0 or
// DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_splitk_gemm_smem(int M, int K, int window, int k_split, int dtype,
                                    long long* bytes, int* stages) {
  if (M <= 0 || K <= 0 || window < 1 || k_split < 0 || (k_split > 0 && (M > 16 || k_split % DBK)) ||
      (dtype != 0 && dtype != 1) || bytes == nullptr || stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  if (dtype == 0)
    smem_query<float>(M, K, window, k_split, bytes, stages);
  else
    smem_query<__nv_bfloat16>(M, K, window, k_split, bytes, stages);
  return 0;
}
