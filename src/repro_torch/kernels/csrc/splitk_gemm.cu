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
// ~50 GB/s, 0.95x the copy engine (chip_smoke.py --phases 1,9).  The
// split-K decode design below runs at that cap.
//
// Split-K decode (`k_split` > 0, M <= 16: every decode step).
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
// Cluster (`k_split` > 0, M > 16, bf16: every prefill, chunk and encoder
// forward of the served dtype): the design of the grouped experts' cluster
// entry below, over the two tiers.  One thread-block cluster of C CTAs per
// (tier tile of 64 columns, K split), laid along M, each CTA one M tile of
// MB = 64 rows (128 once 8 tiles of 64 no longer cover M); the tiles spread
// evenly over the fewest clusters of C <= 8, the last padded to a whole
// cluster.  Each weight box (64 K rows x 64 columns, 8 KB) is read once per
// cluster, the leader multicasting it into every CTA's ring, so a box of
// the remote tier crosses the host link once per 8 x MB rows (512 or 1024)
// where whole K read it once per 128.  Products on tensor cores.  Remote
// clusters come first in block order (host-first), and clusters never
// straddle tiers.  The portable cluster size of 8, not H100's non-portable
// 16: a 2048-row prompt then reads the remote tier twice, and the launch
// needs no occupancy query that could refuse a 16-CTA cluster at the ring
// sizes the window asks for.  K splits put about one remote CTA on each SM
// (the split-K decode design's aim), at most CLUSTER_MAX_SPLITS of them, so
// the fp32 workspace stays within 4 x the output's elements.
// Whole K (`k_split` == 0: fp32 at every M > 16, and operands a tensor map
// cannot describe; split by dtype as flash_prefill.cu splits): one CTA per
// (m-tile, 64 columns), remote tiles first, each walking all of K through a
// `window`-deep cp.async ring of 32-row chunks, so an input of M rows reads
// the weight ceil(M / BM) times (BM = 16, 64 or 128).  Plain FMA into fp32
// registers.
// Ragged M, N and K edges are masked (TMA and cp.async zero-fill); a tier
// may be empty.  Every design adds the remote bytes it reads to a device
// int64 counter (below).
//
// Grouped remote experts (`dak_splitk_gemm_grouped`): y[e] = x[e] @ w[e] for
// every expert e of a remote MoE expert stack [E, K, N] in mapped host
// memory whose routed-slot count is > 0.  The reference computes this block
// with an XLA einsum (src/repro/models/layers.py, `moe_block`), no Pallas
// kernel; here a plain product would stage the experts in HBM, so the block
// is one launch over (N tile x K split, expert, M tile), the weights and x
// read through 3-D tensor maps over the stacks.  Bound: bytes, the active
// experts' weights over the host link.  A CTA whose expert's count is 0
// returns before it issues a load, so a launch reads no more host memory
// than one launch per active expert would, and the counts never leave the
// device (a CUDA graph can hold the step).  Inactive experts are not packed
// to the front: their CTAs retire at once.  Two designs, split by M and
// dtype (as flash_prefill.cu splits by dtype):
//  * Split-K (M <= 16 in bf16, every decode step; every M in fp32, the
//    parity runs): the split-K decode design above, plain FMA, M cut into
//    tiles of up to 64 rows, each tile re-reading its expert's weights.
//    At M = 1 it reads at the kernel-read cap.
//  * Cluster (bf16, M > 16: prefill, where M = an expert's capacity, ~192
//    rows for a 2048-token Qwen3 prompt): one cluster per (expert, N tile,
//    K split), tiled along M as the dense cluster design is.
// The cluster designs, dense and grouped, run one body (`cluster_tile`).
// Each weight box crosses the host link once per cluster: the leader (rank
// 0) reads it with a TMA load multicast to every CTA's ring, completing on
// each CTA's mbarrier.  Each CTA reads its own x rows from HBM through its
// own map.  A stage is refilled only once every consumer warp of the
// cluster has freed it: the leader's empty barrier counts the cluster's
// warps (remote arrivals through mapa), a peer's its own, for its x rows.
// A cluster barrier before any CTA exits keeps multicast writes and remote
// arrivals out of retired CTAs.  Products on tensor cores, mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), fed by ldmatrix / ldmatrix.trans
// from boxes written with TMA's 128-byte swizzle, so the 8 rows of every
// ldmatrix phase hit 8 distinct banks; four (MB 64) or eight warps of 16
// rows each, and one producer warp.  mma.sync rather than wgmma: the
// products take a small share of a host-bound launch (2 x 192 x 2048 x 1536
// FLOPs an expert against 9.4 MB over the link), and the fragments are the
// ones flash_prefill.cu already runs.  One issuer per cluster would cut the
// remote bytes in flight by C, so the ring holds C x `window` 4 KB boxes
// (two stages at least), the split-K design's bytes in flight per remote
// CTA.  Padding CTAs take part in every barrier and store nothing.
// Every design: K splits with an fp32 workspace reduced by the last CTA of
// a tile in split order (bitwise repeatable), tickets per (M tile, N tile),
// and a device int64 counter of the remote bytes requested: each CTA that
// reads remote weights adds its boxes' in-bounds bytes once, at its end (a
// cluster's leader for the cluster).
#include "tma.cuh"

namespace {

// In-bounds bytes of the remote boxes one CTA reads: its K rows x its tile's
// columns (the host-byte counter's unit).
__device__ __forceinline__ unsigned long long box_bytes(int k_rows, int col0, int bn, int N,
                                                        int elem) {
  const int cols = N - col0 < bn ? N - col0 : bn;
  return (unsigned long long)k_rows * (unsigned long long)cols * (unsigned long long)elem;
}

// ---------------------------------------------------------------------------
// Whole-K tiles (fp32 prefill, and operands a tensor map cannot describe).
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
    unsigned long long* __restrict__ host_bytes, int M, int K, int n_loc, int n_rem,
    int n_rem_tiles, int stages) {
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
  if (remote && tid == 0 && host_bytes != nullptr)
    atomicAdd(host_bytes, box_bytes(K, col0, BN, n_rem, (int)sizeof(T)));

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
int launch(const T* x, const T* wl, const T* wr, T* y, unsigned long long* host_bytes, int M,
           int K, int n_loc, int n_rem, int stages, cudaStream_t stream) {
  const int n_loc_tiles = (n_loc + BN - 1) / BN, n_rem_tiles = (n_rem + BN - 1) / BN;
  const size_t smem = whole_k_smem<T, BM>(stages);
  auto kern = splitk_gemm_kernel<T, BM, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_loc_tiles + n_rem_tiles, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(x, wl, wr, y, host_bytes, M, K, n_loc, n_rem,
                                        n_rem_tiles, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wl, const void* wr, void* y,
             unsigned long long* host_bytes, int M, int K, int n_loc, int n_rem, int stages,
             cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  const bool vec = K % EPC == 0 && n_loc % EPC == 0 && n_rem % EPC == 0 &&
                   aligned16(x) && aligned16(wl) && aligned16(wr);
  const T* xt = static_cast<const T*>(x);
  const T* wlt = static_cast<const T*>(wl);
  const T* wrt = static_cast<const T*>(wr);
  T* yt = static_cast<T*>(y);
  unsigned long long* hb = host_bytes;
  switch (whole_k_bm(M)) {
    case 16:
      return vec ? launch<T, 16, true>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 16, false>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream);
    case 64:
      return vec ? launch<T, 64, true>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 64, false>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream);
    default:
      return vec ? launch<T, 128, true>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream)
                 : launch<T, 128, false>(xt, wlt, wrt, yt, hb, M, K, n_loc, n_rem, stages, stream);
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
    T* __restrict__ y, float* __restrict__ ws, int* __restrict__ tickets,
    unsigned long long* __restrict__ host_bytes, int M, int K, int n_loc, int n_rem,
    int n_loc_tiles, int n_rem_tiles, int splits, int k_split, int stages) {
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
  if (remote && tid == 0 && host_bytes != nullptr)
    atomicAdd(host_bytes, box_bytes(k_end - k_begin, col0, DBN, n_rem, (int)sizeof(T)));

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
int launch_decode(const T* x, const T* wl, const T* wr, T* y, float* ws, int* tickets,
                  unsigned long long* host_bytes, int M, int K, int n_loc, int n_rem, int window,
                  int k_split, cudaStream_t stream) {
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
      x_map, wl_map, wr_map, y, ws, tickets, host_bytes, M, K, n_loc, n_rem, n_loc_tiles,
      n_rem_tiles, splits, k_split, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_decode(const void* x, const void* wl, const void* wr, void* y, float* ws,
                    int* tickets, unsigned long long* host_bytes, int M, int K, int n_loc,
                    int n_rem, int window, int k_split, cudaStream_t stream) {
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
  launch_decode<T, MB>(xt, wlt, wrt, yt, ws, tickets, host_bytes, M, K, n_loc, n_rem, window, \
                       k_split, stream)
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
// Grouped remote experts, split-K design (M <= 16 in bf16; every M in fp32):
// the split-K decode design over an expert stack.
// ---------------------------------------------------------------------------
constexpr int GROUPED_MAX_MB = 64;   // rows of an M tile of the split-K grouped design

template <typename T, int MB>
__global__ void __launch_bounds__(DTHREADS) splitk_gemm_grouped_kernel(
    __grid_constant__ const CUtensorMap x_map,   // x [E, M, K], box DBK x MB x 1
    __grid_constant__ const CUtensorMap w_map,   // w [E, K, N] (mapped host), box DBN x DBK x 1
    const int* __restrict__ counts, T* __restrict__ y, float* __restrict__ ws,
    int* __restrict__ tickets, unsigned long long* __restrict__ host_bytes, int E, int M, int K,
    int N, int n_tiles, int splits, int k_split, int stages) {
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
  if (tid == 0 && host_bytes != nullptr)
    atomicAdd(host_bytes, box_bytes(k_end - k_begin, col0, DBN, N, (int)sizeof(T)));

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

// Rows of an M tile of the split-K grouped design: the power of two >= M,
// up to GROUPED_MAX_MB.
inline int grouped_mb(int M) {
  int mb = 1;
  while (mb < M && mb < GROUPED_MAX_MB) mb *= 2;
  return mb;
}

template <typename T, int MB>
int launch_grouped(const T* x, const T* w, const int* counts, T* y, float* ws, int* tickets,
                   unsigned long long* host_bytes, int E, int M, int K, int N, int window,
                   int k_split, cudaStream_t stream) {
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
  kern<<<grid, DTHREADS, smem, stream>>>(x_map, w_map, counts, y, ws, tickets, host_bytes, E, M,
                                         K, N, n_tiles, splits, k_split, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_grouped(const void* x, const void* w, const int* counts, void* y, float* ws,
                     int* tickets, unsigned long long* host_bytes, int E, int M, int K, int N,
                     int window, int k_split, cudaStream_t stream) {
  if (k_split % DBK) return DAK_ERR_BAD_ARGUMENT;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
#define DAK_GROUPED(MB)                                                                  \
  case MB:                                                                               \
    return launch_grouped<T, MB>(xt, wt, counts, yt, ws, tickets, host_bytes, E, M, K, N, \
                                 window, k_split, stream);
  switch (grouped_mb(M)) {
    DAK_GROUPED(1)
    DAK_GROUPED(2)
    DAK_GROUPED(4)
    DAK_GROUPED(8)
    DAK_GROUPED(16)
    DAK_GROUPED(32)
    DAK_GROUPED(GROUPED_MAX_MB)
  }
#undef DAK_GROUPED
  return DAK_ERR_BAD_ARGUMENT;
}

// ---------------------------------------------------------------------------
// Grouped remote experts, cluster design (bf16, M > 16): each weight box
// crosses the host link once per cluster of M tiles, multicast into every
// CTA of the cluster; products on tensor cores.
// ---------------------------------------------------------------------------
constexpr int CBN = 64;               // columns of a weight box: 128-byte rows in bf16
constexpr int CBK = 64;               // rows of a weight box, and the K of a ring stage
constexpr int CLUSTER_MAX = 8;        // the portable cluster size
constexpr uint32_t CW_BYTES = CBK * CBN * 2;       // one weight box, 8 KB
constexpr uint32_t SPLIT_K_BOX = DBK * DBN * 2;    // the split-K design's bf16 box, 4 KB
constexpr int C_ALIGN = 1024;         // a 128-byte-swizzled box lands 1024-byte aligned
constexpr size_t CSMEM_MAX = 232448;  // dynamic shared memory a CTA may opt into (227 KB)
typedef __nv_bfloat16 bf16;

template <int MB>
struct ClusterTile {
  static constexpr int WARPS = MB / 16;               // consumer warps, 16 rows each
  static constexpr int THREADS = 32 * (WARPS + 1);    // and one producer warp
  static constexpr uint32_t X_BYTES = MB * CBK * 2;   // x rows of a stage
  static constexpr uint32_t STAGE = CW_BYTES + X_BYTES;
  static_assert(STAGE % C_ALIGN == 0, "every box of the ring stays 1024-byte aligned");
};

// The M tile and the cluster of a cluster-design launch: MB = 64 while 8
// tiles of 64 cover M, else 128; the tiles spread evenly over the fewest
// clusters of at most CLUSTER_MAX CTAs, the last padded to a whole cluster.
inline int cluster_mb(int M) { return (M + 63) / 64 <= CLUSTER_MAX ? 64 : 128; }
inline int cluster_size(int m_tiles) {
  const int clusters = (m_tiles + CLUSTER_MAX - 1) / CLUSTER_MAX;
  return (m_tiles + clusters - 1) / clusters;
}

// Ring stages of a cluster-design launch: the split-K design keeps `window`
// 4 KB boxes in flight per remote CTA; a cluster of `csize` CTAs has one
// issuer, so its ring holds csize x as many bytes (two stages at least),
// no more than a CTA's split has loads, within CSMEM_MAX.
template <int MB>
int cluster_stages(int K, int window, int k_split, int csize) {
  const int n_ld = ((k_split < K ? k_split : K) + CBK - 1) / CBK;
  int stages = (int)(((long long)csize * window * SPLIT_K_BOX + CW_BYTES - 1) / CW_BYTES);
  if (stages < 2) stages = 2;
  if (stages > n_ld) stages = n_ld;
  const int cap = (int)((CSMEM_MAX - C_ALIGN) / (ClusterTile<MB>::STAGE + 2 * sizeof(uint64_t)));
  return stages < cap ? stages : cap;
}

// Dynamic shared memory of a cluster-design launch: the alignment slack,
// the ring, and a full and an empty mbarrier a stage.
template <int MB>
size_t cluster_smem(int stages) {
  return (size_t)C_ALIGN + (size_t)stages * (ClusterTile<MB>::STAGE + 2 * sizeof(uint64_t));
}

// Byte offset of the 16-byte piece `piece` of row `row` in a box of
// 128-byte rows written with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int row, int piece) {
  return (uint32_t)(row * 128 + ((piece ^ (row & 7)) << 4));
}

// One CTA's share of a cluster-design tile: the C CTAs of a cluster hold C
// M tiles of MB rows over the same CBN columns of one weight matrix and the
// same K split [k_begin, k_end); this CTA's tile starts at row m0 (rows past
// M are padding: the CTA joins every barrier and stores nothing).  x_map
// reads this CTA's rows of matrix `e` of x; the leader (rank 0) reads each
// weight box of matrix `e` of w_map once and multicasts it into every CTA's
// ring.  Row r, column c of the tile's output is y[r * ld + c] (columns in
// [0, N)); with K splits the partials go to ws[split * split_stride + r * ld
// + c] and the last of the tile's splits to arrive on `ticket` adds them in
// split order.  The leader adds its weight boxes' in-bounds bytes to
// `host_bytes` (if not null) once, at the end.  Both cluster entry points,
// the dense GEMM's and the grouped experts', run this body.
template <int MB>
__device__ __forceinline__ void cluster_tile(unsigned char* smem_raw, const CUtensorMap* x_map,
                                             const CUtensorMap* w_map, int e, int m0, int M,
                                             int col0, int N, int k_begin, int k_end,
                                             int stages, int split, int splits, bf16* y,
                                             float* ws, size_t ld, size_t split_stride,
                                             int* ticket, unsigned long long* host_bytes) {
  using Tile = ClusterTile<MB>;
  unsigned char* smem =
      smem_raw + ((C_ALIGN - (smem_u32(smem_raw) & (C_ALIGN - 1))) & (C_ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * Tile::STAGE);
  uint64_t* empty = full + stages;
  __shared__ bool last;

  const uint32_t rank = cluster_ctarank(), csize = cluster_nctarank();
  const bool has_rows = m0 < M;   // the last cluster's padding CTAs hold none
  const int n_ld = (k_end - k_begin + CBK - 1) / CBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // the leader refills a stage once every consumer warp of the cluster is
      // done with it, a peer once its own are (for its x rows)
      mbar_init(&empty[s], rank == 0 ? csize * Tile::WARPS : Tile::WARPS);
    }
    mbar_fence_init();
  }
  cluster_sync();   // every barrier of the cluster is set before any copy lands

  if (warp == Tile::WARPS) {
    // Producer: this CTA's x rows from HBM; the leader (rank 0) also reads
    // each weight box once, over the host link, into every CTA's ring.
    if (lane == 0) {
      const uint32_t tx = CW_BYTES + (has_rows ? Tile::X_BYTES : 0);
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int i = 0; i < n_ld; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        unsigned char* st = smem + (size_t)s * Tile::STAGE;
        const int k0 = k_begin + i * CBK;
        mbar_expect_tx(&full[s], tx);
        if (has_rows) tma_load_3d(st + CW_BYTES, x_map, k0, m0, e, &full[s]);
        if (rank == 0) tma_load_3d_multicast(st, w_map, col0, k0, e, &full[s], mask);
      }
    }
    __syncwarp();
  } else {
    // Consumers: warp w owns rows m0 + 16w .. + 15 and all CBN columns.
    float acc[CBN / 8][4];
#pragma unroll
    for (int n = 0; n < CBN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bool mine = m0 + warp * 16 < M;   // a warp past M only frees stages
    const int a_row = warp * 16 + lane % 16;
    for (int i = 0; i < n_ld; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const unsigned char* w_s = smem + (size_t)s * Tile::STAGE;   // [CBK][CBN]
      const unsigned char* x_s = w_s + CW_BYTES;                     // [MB][CBK]
      if (mine) {
#pragma unroll
        for (int kk = 0; kk < CBK / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, x_s + swizzled(a_row, kk * 2 + lane / 16));
          const int b_row = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
          for (int np = 0; np < CBN / 16; ++np) {
            uint32_t b[4];   // K rows kk*16 + [0, 16), columns np*16 + [0, 8) and [8, 16)
            ldmatrix_x4_trans(b, w_s + swizzled(b_row, np * 2 + lane / 16));
            mma_bf16(acc[2 * np], a, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        if (rank != 0) mbar_arrive_cluster(&empty[s], 0);
      }
    }
    if (mine) {
      // fragment (row g, columns 2 t4, 2 t4 + 1) and row g + 8
      const int g = lane / 4, t4 = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int n = 0; n < CBN / 8; ++n) {
          const int col = col0 + n * 8 + 2 * t4;
          if (col >= N) continue;   // N is a multiple of 8: col + 1 < N too
          const size_t at = (size_t)row * ld + col;
          if (splits == 1)
            *reinterpret_cast<__nv_bfloat162*>(y + at) =
                __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(ws + split * split_stride + at) =
                make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        }
      }
    }
  }
  cluster_sync();   // no multicast write or remote arrival lands in a retired CTA
  if (rank == 0 && tid == 0 && host_bytes != nullptr)
    atomicAdd(host_bytes, box_bytes(k_end - k_begin, col0, CBN, N, 2));
  if (!has_rows || splits == 1) return;

  // one split of a tile: the last to arrive adds the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = M - m0 < MB ? M - m0 : MB;
  for (int idx = tid; idx < rows * CBN; idx += Tile::THREADS) {
    const int col = col0 + idx % CBN;
    if (col >= N) continue;
    const size_t at = (size_t)(m0 + idx / CBN) * ld + col;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += __ldcg(ws + s * split_stride + at);
    y[at] = __float2bfloat16(sum);
  }
  if (tid == 0) *ticket = 0;                    // ready for the next launch
}

// Grid (N tiles x splits, E, M tiles padded to whole clusters), clusters
// along z.  A cluster holds one expert, so it returns whole when the
// expert's count is 0.
template <int MB>
__global__ void __launch_bounds__(ClusterTile<MB>::THREADS) grouped_cluster_kernel(
    __grid_constant__ const CUtensorMap x_map,   // x [E, M, K], box CBK x MB x 1, swizzled
    __grid_constant__ const CUtensorMap w_map,   // w [E, K, N] (mapped host), box CBN x CBK x 1
    const int* __restrict__ counts, bf16* __restrict__ y, float* __restrict__ ws,
    int* __restrict__ tickets, unsigned long long* __restrict__ host_bytes, int E, int M, int K,
    int N, int n_tiles, int splits, int k_split, int stages) {
  const int e = blockIdx.y;
  if (counts[e] == 0) return;   // the whole cluster returns: it holds one expert
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tile = (int)blockIdx.x % n_tiles, split = (int)blockIdx.x / n_tiles;
  const int k_begin = split * k_split;
  const int k_end = k_begin + k_split < K ? k_begin + k_split : K;
  const size_t at = (size_t)e * M * N;
  cluster_tile<MB>(smem_raw, &x_map, &w_map, e, (int)blockIdx.z * MB, M, tile * CBN, N, k_begin,
                   k_end, stages, split, splits, y + at, ws == nullptr ? nullptr : ws + at, N,
                   (size_t)E * M * N,
                   tickets + ((size_t)e * gridDim.z + blockIdx.z) * n_tiles + tile, host_bytes);
}

// Grid (cluster units, 1, C), clusters along z: unit u is (tile, split,
// cluster row) with tiles fastest, the remote tier's units first (host-first
// order), and the CTA of rank r in cluster row q holds M tile q * C + r.
template <int MB>
__global__ void __launch_bounds__(ClusterTile<MB>::THREADS) splitk_gemm_cluster_kernel(
    __grid_constant__ const CUtensorMap x_map,    // x [1, M, K], box CBK x MB x 1, swizzled
    __grid_constant__ const CUtensorMap wl_map,   // w_local [1, K, n_loc], box CBN x CBK x 1
    __grid_constant__ const CUtensorMap wr_map,   // w_remote [1, K, n_rem] (mapped host)
    bf16* __restrict__ y, float* __restrict__ ws, int* __restrict__ tickets,
    unsigned long long* __restrict__ host_bytes, int M, int K, int n_loc, int n_rem,
    int n_loc_tiles, int n_rem_tiles, int splits, int k_split, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int csize = (int)gridDim.z;
  const int n_rem_units = n_rem_tiles * splits * rows;
  const bool remote = (int)blockIdx.x < n_rem_units;
  const int u = remote ? (int)blockIdx.x : (int)blockIdx.x - n_rem_units;
  const int n_tiles = remote ? n_rem_tiles : n_loc_tiles;
  const int tile = u % n_tiles, split = (u / n_tiles) % splits, row = u / (n_tiles * splits);
  const int m_tile = row * csize + (int)blockIdx.z;
  const int k_begin = split * k_split;
  const int k_end = k_begin + k_split < K ? k_begin + k_split : K;
  const int ldy = n_loc + n_rem;
  const int out0 = remote ? n_loc : 0;   // the tier's first output column
  const int slot = remote ? tile : n_rem_tiles + tile;
  cluster_tile<MB>(smem_raw, &x_map, remote ? &wr_map : &wl_map, 0, m_tile * MB, M, tile * CBN,
                   remote ? n_rem : n_loc, k_begin, k_end, stages, split, splits, y + out0,
                   ws == nullptr ? nullptr : ws + out0, ldy, (size_t)M * ldy,
                   tickets == nullptr ? nullptr : tickets + (size_t)slot * rows * csize + m_tile,
                   remote ? host_bytes : nullptr);
}

// The maps of a cluster-design launch: x [E, M, K] in boxes of CBK x MB rows
// and w [E, K, N] in boxes of CBN x CBK, both 128-byte swizzled.
int cluster_x_map(CUtensorMap* map, const void* x, int E, int M, int K, int mb) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)E};
  const uint64_t pitch[2] = {(uint64_t)K * 2, (uint64_t)M * K * 2};
  const uint32_t box[3] = {CBK, (uint32_t)mb, 1};
  return dak_encode(map, x, 2, 3, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_128B);
}
int cluster_w_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t pitch[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t box[3] = {CBN, CBK, 1};
  return dak_encode(map, w, 2, 3, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// One launch of `kern` in clusters of `csize` CTAs along z.  Returns 0 or the
// cudaError_t of the attribute, the launch or the launch's check.
template <int MB, typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), dim3 grid, int csize, int stages,
                    cudaStream_t stream, Args... args) {
  const size_t smem = cluster_smem<MB>(stages);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ClusterTile<MB>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = csize;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int MB>
int launch_grouped_cluster(const bf16* x, const bf16* w, const int* counts, bf16* y, float* ws,
                           int* tickets, unsigned long long* host_bytes, int E, int M, int K,
                           int N, int window, int k_split, cudaStream_t stream) {
  CUtensorMap x_map{}, w_map{};
  if (int err = cluster_x_map(&x_map, x, E, M, K, MB)) return err;
  if (int err = cluster_w_map(&w_map, w, E, K, N)) return err;
  const int n_tiles = (N + CBN - 1) / CBN, m_tiles = (M + MB - 1) / MB;
  const int csize = cluster_size(m_tiles);
  const int grid_z = (m_tiles + csize - 1) / csize * csize;
  const int splits = (K + k_split - 1) / k_split;
  const int stages = cluster_stages<MB>(K, window, k_split, csize);
  return launch_clusters<MB>(grouped_cluster_kernel<MB>, dim3(n_tiles * splits, E, grid_z),
                             csize, stages, stream, x_map, w_map, counts, y, ws, tickets,
                             host_bytes, E, M, K, N, n_tiles, splits, k_split, stages);
}

int dispatch_grouped_cluster(const void* x, const void* w, const int* counts, void* y, float* ws,
                             int* tickets, unsigned long long* host_bytes, int E, int M, int K,
                             int N, int window, int k_split, cudaStream_t stream) {
  if (k_split % CBK) return DAK_ERR_BAD_ARGUMENT;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* yt = static_cast<bf16*>(y);
  return cluster_mb(M) == 64
             ? launch_grouped_cluster<64>(xt, wt, counts, yt, ws, tickets, host_bytes, E, M, K, N,
                                          window, k_split, stream)
             : launch_grouped_cluster<128>(xt, wt, counts, yt, ws, tickets, host_bytes, E, M, K,
                                           N, window, k_split, stream);
}

template <int MB>
int launch_cluster(const bf16* x, const bf16* wl, const bf16* wr, bf16* y, float* ws,
                   int* tickets, unsigned long long* host_bytes, int M, int K, int n_loc,
                   int n_rem, int window, int k_split, cudaStream_t stream) {
  CUtensorMap x_map{}, wl_map{}, wr_map{};
  if (int err = cluster_x_map(&x_map, x, 1, M, K, MB)) return err;
  // an empty tier gets the other tier's map (never read: it has no cluster)
  if (int err = n_loc ? cluster_w_map(&wl_map, wl, 1, K, n_loc)
                      : cluster_w_map(&wl_map, wr, 1, K, n_rem))
    return err;
  if (int err = n_rem ? cluster_w_map(&wr_map, wr, 1, K, n_rem)
                      : cluster_w_map(&wr_map, wl, 1, K, n_loc))
    return err;
  const int n_loc_tiles = (n_loc + CBN - 1) / CBN, n_rem_tiles = (n_rem + CBN - 1) / CBN;
  const int m_tiles = (M + MB - 1) / MB;
  const int csize = cluster_size(m_tiles);
  const int rows = (m_tiles + csize - 1) / csize;
  const int splits = (K + k_split - 1) / k_split;
  const int stages = cluster_stages<MB>(K, window, k_split, csize);
  return launch_clusters<MB>(splitk_gemm_cluster_kernel<MB>,
                             dim3((n_loc_tiles + n_rem_tiles) * splits * rows, 1, csize), csize,
                             stages, stream, x_map, wl_map, wr_map, y, ws, tickets, host_bytes, M,
                             K, n_loc, n_rem, n_loc_tiles, n_rem_tiles, splits, k_split, rows,
                             stages);
}

int dispatch_cluster(const void* x, const void* wl, const void* wr, void* y, float* ws,
                     int* tickets, unsigned long long* host_bytes, int M, int K, int n_loc,
                     int n_rem, int window, int k_split, cudaStream_t stream) {
  // tensor maps need 16-byte aligned bases and row pitches
  if (M <= 16 || k_split % CBK || K % 8 || n_loc % 8 || n_rem % 8 || !aligned16(x) ||
      (n_loc && !aligned16(wl)) || (n_rem && !aligned16(wr)) ||
      (k_split < K && (ws == nullptr || tickets == nullptr)))
    return DAK_ERR_BAD_ARGUMENT;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wlt = static_cast<const bf16*>(wl);
  const bf16* wrt = static_cast<const bf16*>(wr);
  bf16* yt = static_cast<bf16*>(y);
  return cluster_mb(M) == 64
             ? launch_cluster<64>(xt, wlt, wrt, yt, ws, tickets, host_bytes, M, K, n_loc, n_rem,
                                  window, k_split, stream)
             : launch_cluster<128>(xt, wlt, wrt, yt, ws, tickets, host_bytes, M, K, n_loc, n_rem,
                                   window, k_split, stream);
}

// The ring stages and dynamic shared memory of a grouped launch of these
// arguments, by the launch's own arithmetic and tile choice.
// The ring stages and dynamic shared memory of a cluster-design launch of
// M rows, dense or grouped.
void cluster_smem_query(int M, int K, int window, int k_split, long long* bytes, int* stages) {
  const int mb = cluster_mb(M);
  const int csize = cluster_size((M + mb - 1) / mb);
  if (mb == 64) {
    *stages = cluster_stages<64>(K, window, k_split, csize);
    *bytes = (long long)cluster_smem<64>(*stages);
  } else {
    *stages = cluster_stages<128>(K, window, k_split, csize);
    *bytes = (long long)cluster_smem<128>(*stages);
  }
}

template <typename T>
void grouped_smem_query(int M, int K, int window, int k_split, int design, long long* bytes,
                        int* stages) {
  if (design == 1) return cluster_smem_query(M, K, window, k_split, bytes, stages);
#define DAK_QUERY(MB)                                    \
  case MB:                                               \
    *stages = decode_stages<T, MB>(K, window, k_split);  \
    *bytes = (long long)decode_smem<T, MB>(*stages);     \
    return;
  switch (grouped_mb(M)) {
    DAK_QUERY(1)
    DAK_QUERY(2)
    DAK_QUERY(4)
    DAK_QUERY(8)
    DAK_QUERY(16)
    DAK_QUERY(32)
    DAK_QUERY(GROUPED_MAX_MB)
  }
#undef DAK_QUERY
}

// The ring stages and dynamic shared memory a dak_splitk_gemm launch of
// these arguments uses, by the launch's own arithmetic and tile choice.
template <typename T>
void smem_query(int M, int K, int window, int k_split, long long* bytes, int* stages) {
  if (k_split > 0 && M > 16)   // the cluster design (bf16)
    return cluster_smem_query(M, K, window, k_split, bytes, stages);
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

// dtype: 0 = float32, 1 = bfloat16.  w_remote must be mapped host memory or
// device memory (dak_remote_ptr) when n_rem > 0.  The design follows from M,
// k_split and dtype:
//  * k_split > 0 and M <= 16: the split-K decode design (k_split a multiple
//    of 32 rows);
//  * k_split > 0 and M > 16: the cluster design, bfloat16 only (k_split a
//    multiple of 64 rows; M tiles of 64 rows while 8 cover M, else 128, in
//    clusters of up to 8 along M);
//  * k_split == 0: whole K (either dtype, any operands).
// Both tensor-map designs take K, n_loc and n_rem multiples of 16 bytes and
// 16-byte aligned operands; when k_split < K, `workspace` holds
// ceil(K / k_split) * M * (n_loc + n_rem) floats and `tickets` (the M
// tiles, padded to whole clusters, of the cluster design; 1 for split-K)
// x (ceil(n_loc / 64) + ceil(n_rem / 64)) zeroed ints.  `host_bytes`, if not
// null, is a device int64 to which every CTA that reads w_remote adds the
// in-bounds bytes it read, once (a cluster's leader for the cluster).
// Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_gemm(const void* x, const void* w_local, const void* w_remote,
                               void* y, int M, int K, int n_loc, int n_rem, int window,
                               int k_split, void* workspace, void* tickets, void* host_bytes,
                               int dtype, void* stream) {
  if (M <= 0 || K <= 0 || n_loc < 0 || n_rem < 0 || n_loc + n_rem <= 0 || window < 1 ||
      k_split < 0 || (dtype != 0 && dtype != 1) || (k_split > 0 && M > 16 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* wr = nullptr;
  if (n_rem > 0) {
    const int e = dak_remote_ptr(w_remote, &wr);
    if (e) return e;
  }
  const void* wl = n_loc > 0 ? w_local : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  unsigned long long* hb = static_cast<unsigned long long*>(host_bytes);
  if (k_split > 0 && M > 16)
    return dispatch_cluster(x, wl, wr, y, ws, tk, hb, M, K, n_loc, n_rem, window, k_split, s);
  if (k_split > 0)
    return dtype == 0 ? dispatch_decode<float>(x, wl, wr, y, ws, tk, hb, M, K, n_loc, n_rem,
                                               window, k_split, s)
                      : dispatch_decode<__nv_bfloat16>(x, wl, wr, y, ws, tk, hb, M, K, n_loc,
                                                       n_rem, window, k_split, s);
  const int stages = whole_k_stages(K, window);
  return dtype == 0 ? dispatch<float>(x, wl, wr, y, hb, M, K, n_loc, n_rem, stages, s)
                    : dispatch<__nv_bfloat16>(x, wl, wr, y, hb, M, K, n_loc, n_rem, stages, s);
}


// Grouped remote experts: y[e] = x[e] @ w_remote[e] for every e in [0, E)
// with counts[e] > 0 (x [E, M, K] and y [E, M, N] on the device, w_remote
// [E, K, N] mapped host or device memory, counts [E] int32 on the device).
// Rows of experts whose count is 0 are not written: the caller zeroes y.
// `design` 0 is the split-K design (any M, either dtype; k_split a multiple
// of 32 rows, M tiles of MB rows, MB the power of two >= M up to 64), 1 the
// cluster design (bfloat16 only; k_split a multiple of 64 rows; M tiles of
// 64 rows while 8 cover M, else 128, in clusters of up to 8 along M, the
// grid's M axis padded to whole clusters).  K and N are multiples of 16
// bytes and x and w_remote 16-byte aligned; when k_split < K, `workspace`
// holds ceil(K / k_split) * E * M * N floats and `tickets` E * (the grid's
// M tiles) * ceil(N / 64) zeroed ints.  `host_bytes`, if not null, is a
// device int64 to which every CTA that reads the weights adds the bytes of
// w_remote it read (a cluster's weights counted once).  Returns 0, a
// cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_gemm_grouped(const void* x, const void* w_remote, const void* counts,
                                       void* y, int E, int M, int K, int N, int window,
                                       int k_split, void* workspace, void* tickets,
                                       void* host_bytes, int design, int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  // tensor maps need 16-byte aligned bases and row pitches
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0 || window < 1 || k_split <= 0 ||
      counts == nullptr || (dtype != 0 && dtype != 1) || (design != 0 && design != 1) ||
      (design == 1 && dtype != 1) || (K * elem) % 16 || (N * elem) % 16 || !aligned16(x) ||
      (k_split < K && (workspace == nullptr || tickets == nullptr)))
    return DAK_ERR_BAD_ARGUMENT;
  const void* w = nullptr;
  if (const int e = dak_remote_ptr(w_remote, &w)) return e;
  if (!aligned16(w)) return DAK_ERR_BAD_ARGUMENT;
  const int* c = static_cast<const int*>(counts);
  float* ws = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  unsigned long long* hb = static_cast<unsigned long long*>(host_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1)
    return dispatch_grouped_cluster(x, w, c, y, ws, tk, hb, E, M, K, N, window, k_split, s);
  return dtype == 0 ? dispatch_grouped<float>(x, w, c, y, ws, tk, hb, E, M, K, N, window,
                                              k_split, s)
                    : dispatch_grouped<__nv_bfloat16>(x, w, c, y, ws, tk, hb, E, M, K, N,
                                                      window, k_split, s);
}

// What a dak_splitk_gemm_grouped launch with these arguments would hold:
// its ring stages and its dynamic shared memory in bytes.  Launches
// nothing; `splitk_gemm.grouped_launch` is checked against it.  Returns 0
// or DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_splitk_gemm_grouped_smem(int M, int K, int window, int k_split, int design,
                                            int dtype, long long* bytes, int* stages) {
  if (M <= 0 || K <= 0 || window < 1 || k_split <= 0 || (design != 0 && design != 1) ||
      (dtype != 0 && dtype != 1) || (design == 1 && dtype != 1) ||
      k_split % (design == 1 ? CBK : DBK) || bytes == nullptr || stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  if (dtype == 0)
    grouped_smem_query<float>(M, K, window, k_split, design, bytes, stages);
  else
    grouped_smem_query<__nv_bfloat16>(M, K, window, k_split, design, bytes, stages);
  return 0;
}

// What a dak_splitk_gemm launch with these arguments would hold: its ring
// stages and its dynamic shared memory in bytes (`k_split` > 0 the split-K
// design at M <= 16 and the cluster design, bfloat16 only, past that; 0
// whole K).  Launches nothing; the wrappers' shared-memory footprints are
// checked against it.  Returns 0 or DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_splitk_gemm_smem(int M, int K, int window, int k_split, int dtype,
                                    long long* bytes, int* stages) {
  if (M <= 0 || K <= 0 || window < 1 || k_split < 0 || (k_split > 0 && M <= 16 && k_split % DBK) ||
      (k_split > 0 && M > 16 && (dtype != 1 || k_split % CBK)) || (dtype != 0 && dtype != 1) ||
      bytes == nullptr || stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  if (dtype == 0)
    smem_query<float>(M, K, window, k_split, bytes, stages);
  else
    smem_query<__nv_bfloat16>(M, K, window, k_split, bytes, stages);
  return 0;
}
