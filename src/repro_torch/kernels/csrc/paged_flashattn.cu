// Paged SplitK_FlashAttn on Hopper: ragged, paged, tiered decode attention.
//
// Replaces: src/repro/kernels/splitk_flashattn.py `_paged_kernel` (pallas_call
// at :378, wrapper `paged_splitk_flashattn` :331), reached through
// `ops.paged_decode_attention`.  The TPU kernel's grid runs over slots only:
// each page is copied in once per slot and every query head attends it.
//
// Bound on this card: bytes over the host link.  Local pages stream from HBM
// at 3.35 TB/s; remote pages cross the PCIe host link, which kernels read at
// 30-33 GB/s at most on some H100 machines measured and at ~50 GB/s on others
// (chip_smoke.py --phases 1,9), so the remote pages' bytes over that rate
// are the floor, once each.  Each cached K/V element feeds G = H/Kh query
// heads: one multiply-add per byte for llama2-7b (G = 1), 128 for MLA's
// absorbed decode (128 heads over one latent kv head of 576 = kv_lora 512 +
// rope 64, V read from the K pool).  Two designs, chosen by the dispatch
// below (`dispatch_attn`), never as a fallback of each other:
//
// The cluster design: bf16 at hd > 256, pools a tensor map can describe (hd
// a multiple of 8 elements, page <= 256 rows, 16-byte aligned bases) and a
// ring of one stage or more within shared memory.  Every DeepSeek-V2 decode
// attention takes it.
//  * Grid: for each (slot, kv head), ceil(G/16) head blocks of 16 query
//    heads (one m16 tile; rows past G are masked), launched as thread-block
//    clusters of up to 8 blocks along the heads, spread evenly over the
//    fewest clusters (MLA's 128 heads: one cluster of 8 a slot).
//  * Each page's rows cross into shared memory once per cluster: the
//    leader (rank 0) issues it as ceil(hd/64) boxes of 64 columns x page
//    rows (128-byte rows, 128-byte swizzle), TMA from the pool's tensor map
//    (the device pointer for a local page, the mapped host pointer for a
//    remote one) multicast to every CTA of the cluster, completing on each
//    CTA's full mbarrier.  When the V pools are the K pools (the wrapper
//    compares the pointers and says so) V is the K stage: one load a page;
//    a separate V pool gets its own boxes in the same stage.
//  * A ring of window + 1 stages (cut to what shared memory holds and to
//    the slot's pages) paced by full and empty mbarriers as in
//    splitk_gemm.cu's cluster body: a producer warp issues, the leader's
//    empty barrier counts every consumer warp of the cluster before a stage
//    is refilled, and a cluster barrier before any CTA exits keeps multicast
//    writes and remote arrivals out of retired CTAs.  `window` never changes
//    the result.
//  * Products on tensor cores, mma.sync m16n8k16 (bf16 in, fp32
//    accumulate) fed by ldmatrix from the swizzled boxes: Q (16 x hd) is
//    staged once in shared memory; S = Q K^T for 16 keys at a time, each of
//    the 4 consumer warps summing a quarter of hd, the partials added in
//    warp order through shared memory so every warp holds the same scores;
//    then the fp32 online softmax (one max and sum per head row, the
//    softmax scale folded into log2(e)) and O += P V with P rounded to bf16,
//    each warp on its own quarter of the columns.  No cross-warp merge at
//    the end, so a second launch gives the same bits.
//  * Rows of the slot's last page past its length are zeroed in each CTA's
//    stage before P V, and rows past the page in a box rounded up to 16
//    keys are zero from the start, so masked rows never reach the output.
// fp32 keeps the head-group design (the token-parity phases run it, and
// TF32 products would change their result), and so do all hd <= 256 and
// operands a tensor map cannot describe.
//
// The head-group design (fp32, hd <= 256, and the rest):
//  * Direct access: a remote page goes straight from the pinned, mapped host
//    pool into shared memory, never staged in HBM; each page is read from the
//    pool its page-table tier names.
//  * TMA and a ring that overlaps: one thread issues each page as two boxes
//    (K and V, page x hd of one kv head) through 3-D tensor maps over each
//    pool viewed as [P*page, Kh, hd] (the remote maps on the mapped host
//    pointer), into a ring of window + 1 stages, so `window` page loads
//    stay in flight while a page is folded in; at window 1 (the served
//    path) load and update overlap.  This is what reads the link at its
//    cap: against 16-byte cp.async from every thread into a ring of
//    `window` stages, folded before the next load is issued (the design
//    this replaced), 2.2-3.0x faster at llama2-7b's served shape on an
//    H100 80GB HBM3, timed in alternating rounds on one card.  Rows of a
//    page past the slot's length arrive too and are masked in the update.
//    Pools a tensor map cannot describe (hd*elem not a multiple of 16 B, hd
//    or page above 256, an unaligned base) take element loads into the same
//    ring (template flag TMA = false).
//  * One CTA per (slot, query-head group, kv head) walks the slot's pages:
//    B*Kh CTAs, 128 for llama2-7b at batch 4, which already fill the card.
//    Cutting each slot's pages across several CTAs (split-KV) changed
//    nothing measurable at llama2-7b's shapes, one slot included, so the
//    kernel does not.  Each CTA reads its pages itself, so a group of G
//    heads split over several CTAs reads each page once per CTA.
//  * A warp-level fp32 online softmax in registers over the group-major
//    query heads h = g*Kh + kvh (decode_attn.cuh, shared with
//    splitk_flashattn.cu): one block barrier per page.  Plain FMA: at one
//    multiply-add per byte (G = 1) the tensor cores are not the limit.
//
// Both designs: CTAs are numbered so that slots holding any in-use remote
// page come first, stable within each class (the reference's
// `host_first_slot_order`), each CTA deriving its slot from the page tables
// itself, so no extra launch; `lens == 0` gives zeros; `scale` overrides
// hd**-0.5; the other tier's sink page is never read.  Each adds the remote
// page bytes it loads to `host_bytes` (if not null) on the device: the
// cluster design once per cluster, the head-group design once per CTA (K
// and V both, also when V is the K pool).
//
// `dak_scatter_rows` below is the decode step's K/V row writer (the
// reference's `.at[].set` in `serving.tiered_decode._paged_writer`): a
// helper, not a TPU kernel.  It writes each slot's new row into its page
// in one tier's pool, the remote pool through its mapped pointer.
#include "decode_attn.cuh"

namespace {

using decode::THREADS;
typedef __nv_bfloat16 bf16;

// Pages a slot of length n attends: its first ceil(n / page), at most MP.
__device__ __forceinline__ int slot_used_pages(int n, int ps, int MP) {
  const int u = n > 0 ? (n + ps - 1) / ps : 0;
  return u < MP ? u : MP;
}

// The host-first slot of CTA rank `rank`: slots holding any in-use remote
// page first, stable within each class.  Every thread flags the slots of
// its in-use remote pages, then warp 0 counts the flagged slots and finds
// the slot of this rank, 32 slots per ballot.  All `nthreads` threads call
// it; `has_remote` is [B] ints of shared memory.
__device__ __forceinline__ int host_first_slot(const int* __restrict__ tier,
                                               const int* __restrict__ lens, int B, int MP,
                                               int ps, int rank, int nthreads, int* has_remote) {
  __shared__ int slot_sh;
  const int tid = threadIdx.x, lane = tid % 32;
  for (int bb = tid; bb < B; bb += nthreads) has_remote[bb] = 0;
  __syncthreads();
  for (int e = tid; e < B * MP; e += nthreads)
    if (tier[e] > 0 && e % MP < slot_used_pages(lens[e / MP], ps, MP)) has_remote[e / MP] = 1;
  __syncthreads();
  if (tid < 32) {
    int n_rem = 0;
    for (int base = 0; base < B; base += 32)
      n_rem += __popc(__ballot_sync(0xffffffffu, base + lane < B && has_remote[base + lane]));
    const bool want = rank < n_rem;
    const int target = want ? rank : rank - n_rem;
    int seen = 0;
    for (int base = 0; base < B && seen <= target; base += 32) {
      const int bb = base + lane;
      const bool f = bb < B && (has_remote[bb] != 0) == want;
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (f && seen + __popc(mask & ((1u << lane) - 1)) == target) slot_sh = bb;
      seen += __popc(mask);
    }
  }
  __syncthreads();
  return slot_sh;
}

// The pages slot b attends, its first `n_ld`: idx into its tier's pool
// (clamped), or -1 - idx if remote.
__device__ __forceinline__ void slot_pages(const int* __restrict__ table,
                                           const int* __restrict__ tier, int b, int MP, int n_ld,
                                           int Pl, int Pr, int nthreads, int* pages) {
  for (int i = threadIdx.x; i < n_ld; i += nthreads) {
    const int c = b * MP + i;
    const bool rem = tier[c] > 0;
    const int P = rem ? Pr : Pl;
    int idx = table[c];
    idx = idx < 0 ? 0 : (idx >= P ? P - 1 : idx);
    pages[i] = rem ? -1 - idx : idx;
  }
}

// ---------------------------------------------------------------------------
// The head-group design.
// ---------------------------------------------------------------------------
template <typename T, int DPL, int HPW, bool TMA>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const __grid_constant__ CUtensorMap kl_map,   // pools as [P*page, Kh, hd], box page x hd
    const __grid_constant__ CUtensorMap vl_map,
    const __grid_constant__ CUtensorMap kr_map,   // (mapped host)
    const __grid_constant__ CUtensorMap vr_map,
    const T* __restrict__ kl,    // [Pl, ps, Kh, hd] device (element loads)
    const T* __restrict__ vl,
    const T* __restrict__ kr,    // [Pr, ps, Kh, hd] mapped host (element loads)
    const T* __restrict__ vr,
    const T* __restrict__ q,         // [B, H, hd]
    const int* __restrict__ table,   // [B, MP]
    const int* __restrict__ tier,    // [B, MP]
    const int* __restrict__ lens,    // [B]
    T* __restrict__ out,             // [B, H, hd]
    unsigned long long* __restrict__ host_bytes,
    int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr, float scale, int stages,
    int n_hg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t box = decode::box_bytes(ps, hd, sizeof(T));
  size_t ring = (size_t)stages * 2 * box;
  if (ring < decode::merge_bytes(DPL, HPW)) ring = decode::merge_bytes(DPL, HPW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring);
  int* pages = reinterpret_cast<int*>(full + stages);   // [MP]: idx, or -1 - idx if remote
  int* has_remote = pages + MP;                         // [B]

  const int tid = threadIdx.x;
  const int G = H / Kh;
  int x = blockIdx.x;
  const int kvh = x % Kh;
  x /= Kh;
  const int hg = x % n_hg;
  const int rank = x / n_hg;   // of the slot in host-first order

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], TMA ? 1 : THREADS);
    mbar_fence_init();
  }
  const int b = host_first_slot(tier, lens, B, MP, ps, rank, THREADS, has_remote);
  const int n = lens[b];
  const int n_ld = slot_used_pages(n, ps, MP);
  slot_pages(table, tier, b, MP, n_ld, Pl, Pr, THREADS, pages);
  const int g0 = hg * HPW;
  const int ng = G - g0 < HPW ? G - g0 : HPW;
  decode::WarpState<DPL, HPW> st;
  decode::warp_init(st, q, b, H, Kh, kvh, g0, ng, hd, scale);
  __syncthreads();   // barriers initialised, pages[] written

  const size_t row = (size_t)Kh * hd;   // elements between the rows of a page
  const CUtensorMap* kl_m = &kl_map;
  const CUtensorMap* vl_m = &vl_map;
  const CUtensorMap* kr_m = &kr_map;
  const CUtensorMap* vr_m = &vr_map;
  auto issue = [&](int i) {             // page i into stage i % stages
    unsigned char* dst = smem + (size_t)(i % stages) * 2 * box;
    uint64_t* bar = &full[i % stages];
    const int pg = pages[i];
    const bool rem = pg < 0;
    const int idx = rem ? -1 - pg : pg;
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect_tx(bar, 2u * ps * hd * (uint32_t)sizeof(T));
        tma_load_3d(dst, rem ? kr_m : kl_m, 0, kvh, idx * ps, bar);
        tma_load_3d(dst + box, rem ? vr_m : vl_m, 0, kvh, idx * ps, bar);
      }
    } else {
      const T* kp = (rem ? kr : kl) + (size_t)idx * ps * row + (size_t)kvh * hd;
      const T* vp = (rem ? vr : vl) + (size_t)idx * ps * row + (size_t)kvh * hd;
      T* kd = reinterpret_cast<T*>(dst);
      T* vd = reinterpret_cast<T*>(dst + box);
      for (int e = tid; e < ps * hd; e += THREADS) {
        const int t = e / hd, d = e % hd;
        kd[e] = kp[t * row + d];
        vd[e] = vp[t * row + d];
      }
      mbar_arrive(bar);
    }
  };
  auto rows = [&](int i) {              // the page's rows below lens[b]
    const int r = n - i * ps;
    return r < ps ? r : ps;
  };
  decode::decode_walk<DPL, HPW, T>(st, smem, full, stages, box, n_ld, hd, ng, issue, rows);
  if (tid == 0 && host_bytes != nullptr) {
    int n_rem = 0;
    for (int i = 0; i < n_ld; ++i) n_rem += pages[i] < 0;
    if (n_rem) atomicAdd(host_bytes, 2ull * n_rem * ps * hd * sizeof(T));
  }
  decode::decode_write(st, n_ld > 0, smem, out, b, H, Kh, kvh, g0, ng, hd);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The ring stages and dynamic shared memory of a head-group launch: the
// ring, its mbarriers, then the slot's page list [MP] and the remote flags [B].
inline size_t paged_smem(int B, int hd, int ps, int MP, int window, int elem, int dpl, int hpw,
                         int* stages) {
  const uint32_t box = decode::box_bytes(ps, hd, elem);
  *stages = decode::ring_stages(window, 2 * box, MP);
  return decode::launch_smem(*stages, box, dpl, hpw, (size_t)(MP + B) * sizeof(int));
}

struct Paged {
  const void *q, *kl, *vl, *kr, *vr;
  const int *table, *tier, *lens;
  void* out;
  unsigned long long* host_bytes;
  int B, H, Kh, hd, ps, MP, Pl, Pr;
  float scale;
  int window;
  bool alias;   // the V pools are the K pools
};

template <typename T, int DPL, int HPW, bool TMA>
int launch_attn(const Paged& a, cudaStream_t stream) {
  const int G = a.H / a.Kh;
  const int n_hg = (G + HPW - 1) / HPW;
  int stages = 0;
  const size_t smem = paged_smem(a.B, a.hd, a.ps, a.MP, a.window, sizeof(T), DPL, HPW, &stages);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  CUtensorMap maps[4]{};
  if constexpr (TMA) {
    const void* base[4] = {a.kl, a.vl, a.kr, a.vr};
    const int pages[4] = {a.Pl, a.Pl, a.Pr, a.Pr};
    const uint64_t pitch[2] = {(uint64_t)a.hd * sizeof(T), (uint64_t)a.Kh * a.hd * sizeof(T)};
    const uint32_t box_dim[3] = {(uint32_t)a.hd, 1, (uint32_t)a.ps};
    for (int i = 0; i < 4; ++i) {
      const uint64_t dims[3] = {(uint64_t)a.hd, (uint64_t)a.Kh, (uint64_t)pages[i] * a.ps};
      if (int e = dak_encode(&maps[i], base[i], sizeof(T), 3, dims, pitch, box_dim)) return e;
    }
  }
  auto kern = paged_attn_kernel<T, DPL, HPW, TMA>;
  if (smem > 46 * 1024) {   // the default 48 KB covers static shared memory too
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<a.B * n_hg * a.Kh, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.kl),
      static_cast<const T*>(a.vl), static_cast<const T*>(a.kr), static_cast<const T*>(a.vr),
      static_cast<const T*>(a.q), a.table, a.tier, a.lens, static_cast<T*>(a.out), a.host_bytes,
      a.B, a.H, a.Kh, a.hd, a.ps, a.MP, a.Pl, a.Pr, a.scale, stages, n_hg);
  return cudaGetLastError();
}

// One query head per CTA when G = 1, else as many as registers allow; above
// hd 256 (DPL 16, 32) a tensor map's box cannot hold a row: element loads.
template <typename T, int DPL>
int dispatch_heads(const Paged& a, bool tma, cudaStream_t s) {
  if constexpr (DPL > 8) {
    return launch_attn<T, DPL, 1, false>(a, s);
  } else {
    constexpr int HM = decode::max_heads(DPL);
    if (decode::heads_per_cta(DPL, a.H, a.Kh) == 1)
      return tma ? launch_attn<T, DPL, 1, true>(a, s) : launch_attn<T, DPL, 1, false>(a, s);
    return tma ? launch_attn<T, DPL, HM, true>(a, s) : launch_attn<T, DPL, HM, false>(a, s);
  }
}

template <typename T>
int dispatch_head_group(const Paged& a, cudaStream_t s) {
  const bool tma = a.hd * sizeof(T) % 16 == 0 && a.ps <= 256 && aligned16(a.kl) &&
                   aligned16(a.vl) && aligned16(a.kr) && aligned16(a.vr);
  switch (decode::dims_per_lane(a.hd)) {
    case 1: return dispatch_heads<T, 1>(a, tma, s);
    case 2: return dispatch_heads<T, 2>(a, tma, s);
    case 4: return dispatch_heads<T, 4>(a, tma, s);
    case 8: return dispatch_heads<T, 8>(a, tma, s);
    case 16: return dispatch_heads<T, 16>(a, false, s);
    default: return dispatch_heads<T, 32>(a, false, s);
  }
}

// ---------------------------------------------------------------------------
// The cluster design (bf16, hd > 256, pools a tensor map can describe).
// ---------------------------------------------------------------------------
constexpr int CL_HEADS = 16;                      // query heads of a CTA: one m16 tile
constexpr int CL_WARPS = 4;                       // consumer warps
constexpr int CL_THREADS = 32 * (CL_WARPS + 1);   // and one producer warp
constexpr int CL_COLS = 64;                       // columns of a box: one 128-byte row
constexpr int CL_KEYS = 16;                       // keys of one score block
constexpr int CL_MAX = 8;                         // the portable cluster size
constexpr int CL_ALIGN = 1024;                    // a 128-byte-swizzled box lands 1024-aligned
constexpr size_t CL_SMEM_MAX = 232448 - 128;      // a CTA's opt-in 227 KB, less its static slot index
constexpr size_t CL_RED = 2 * CL_WARPS * 32 * 8 * sizeof(float);   // partial scores, 2 buffers

// The geometry of a cluster-design launch: boxes of 64 columns a row, each
// box's shared-memory slot (page rows rounded up to 16 keys x 128 B), and
// the bytes of a ring stage (K boxes, then V boxes unless V is the K pool).
struct ClusterGeo {
  int nb;
  uint32_t slot, stage;
};
__host__ __device__ inline ClusterGeo cluster_geo(int hd, int ps, bool alias) {
  ClusterGeo g;
  g.nb = (hd + CL_COLS - 1) / CL_COLS;
  g.slot = (uint32_t)((ps + CL_KEYS - 1) / CL_KEYS * CL_KEYS * 128);
  g.stage = (uint32_t)g.nb * g.slot * (alias ? 1 : 2);
  return g;
}

// Bytes of a cluster-design launch besides its ring: the alignment slack,
// Q (16 rows x nb boxes of 128 B), the partial scores, the page list [MP]
// and the remote flags [B].
inline size_t cluster_fixed(int B, int hd, int MP) {
  return (size_t)CL_ALIGN + (size_t)cluster_geo(hd, 16, true).nb * CL_HEADS * 128 + CL_RED +
         (size_t)(MP + B) * sizeof(int);
}

// Ring stages of a cluster-design launch: `window` loads in flight while one
// page is computed, cut to what CL_SMEM_MAX holds (a full and an empty
// mbarrier a stage) and to the slot's pages; 0 if not one stage fits.
inline int cluster_stages(int B, int hd, int ps, int MP, int window, bool alias) {
  int stages = (window < DAK_MAX_WINDOW ? window : DAK_MAX_WINDOW) + 1;
  const size_t fixed = cluster_fixed(B, hd, MP);
  const size_t per = cluster_geo(hd, ps, alias).stage + 2 * sizeof(uint64_t);
  const int fit = fixed < CL_SMEM_MAX ? (int)((CL_SMEM_MAX - fixed) / per) : 0;
  if (stages > fit) stages = fit;
  if (stages > MP) stages = MP;
  return stages;
}

inline size_t cluster_smem(int B, int hd, int ps, int MP, int stages, bool alias) {
  return cluster_fixed(B, hd, MP) +
         (size_t)stages * (cluster_geo(hd, ps, alias).stage + 2 * sizeof(uint64_t));
}

// Head blocks of a (slot, kv head) and the CTAs of a cluster: the blocks
// spread evenly over the fewest clusters of at most CL_MAX.
inline int cluster_blocks(int G) { return (G + CL_HEADS - 1) / CL_HEADS; }
inline int cluster_ctas(int n_hb) {
  const int clusters = (n_hb + CL_MAX - 1) / CL_MAX;
  return (n_hb + clusters - 1) / clusters;
}

__device__ __forceinline__ uint32_t swizzled(int row, int piece) {
  return (uint32_t)(row * 128 + ((piece ^ (row & 7)) << 4));
}

// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CL_WARPS * 32) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// NBM: boxes of a row at most (hd <= 64 NBM).  Grid (head blocks padded to
// whole clusters, Kh, B), clusters along x; blockIdx.z is the slot's rank in
// host-first order.
template <int NBM>
__global__ void __launch_bounds__(CL_THREADS) paged_attn_cluster_kernel(
    const __grid_constant__ CUtensorMap kl_map,   // pools as [P*page, Kh, hd], box 64 x 1 x page,
    const __grid_constant__ CUtensorMap vl_map,   // 128-byte swizzled
    const __grid_constant__ CUtensorMap kr_map,   // (mapped host)
    const __grid_constant__ CUtensorMap vr_map,
    const bf16* __restrict__ q,         // [B, H, hd]
    const int* __restrict__ table,      // [B, MP]
    const int* __restrict__ tier,       // [B, MP]
    const int* __restrict__ lens,       // [B]
    bf16* __restrict__ out,             // [B, H, hd]
    unsigned long long* __restrict__ host_bytes,
    int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr, float scale_log2, int stages,
    int alias) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((CL_ALIGN - (smem_u32(smem_raw) & (CL_ALIGN - 1))) & (CL_ALIGN - 1));
  const ClusterGeo geo = cluster_geo(hd, ps, alias != 0);
  const int nb = geo.nb;
  const uint32_t k_bytes = (uint32_t)nb * geo.slot;
  const int rows16 = (int)(geo.slot / 128);
  unsigned char* q_s = smem;                                   // [nb][16 rows][128 B], swizzled
  unsigned char* ring = q_s + (size_t)nb * CL_HEADS * 128;     // [stages][K boxes | V boxes]
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * geo.stage);  // [2][WARPS][32][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * CL_WARPS * 32 * 8);
  uint64_t* empty = full + stages;
  int* pages = reinterpret_cast<int*>(empty + stages);        // [MP]
  int* has_remote = pages + MP;                                // [B]

  const uint32_t rank = cluster_ctarank(), csize = cluster_nctarank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / Kh;
  const int kvh = blockIdx.y;
  const int g0 = (int)blockIdx.x * CL_HEADS;
  const int ng = G - g0 < CL_HEADS ? (G - g0 > 0 ? G - g0 : 0) : CL_HEADS;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // the leader refills a stage once every consumer warp of the cluster
      // is done with it, a peer's producer once its own are
      mbar_init(&empty[s], rank == 0 ? csize * CL_WARPS : CL_WARPS);
    }
    mbar_fence_init();
  }
  // every CTA of the cluster derives the same slot from blockIdx.z
  const int b = host_first_slot(tier, lens, B, MP, ps, (int)blockIdx.z, CL_THREADS, has_remote);
  const int n = lens[b];
  const int n_ld = slot_used_pages(n, ps, MP);
  slot_pages(table, tier, b, MP, n_ld, Pl, Pr, CL_THREADS, pages);
  // Q's rows of this block, 16-byte pieces into the swizzled boxes (zeros
  // past G and past hd), and the rows of every box slot past the page (zero
  // from the start: no load ever writes them)
  for (int e = tid; e < CL_HEADS * nb * 8; e += CL_THREADS) {
    const int r = e / (nb * 8), j = (e / 8) % nb, p = e % 8;
    const int d0 = j * CL_COLS + p * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < ng && d0 < hd)
      v = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + (size_t)(g0 + r) * Kh + kvh) * hd +
                                          d0);
    *reinterpret_cast<uint4*>(q_s + (size_t)j * CL_HEADS * 128 + swizzled(r, p)) = v;
  }
  const int pad = rows16 - ps;
  if (pad > 0) {
    const int boxes = stages * nb * (alias ? 1 : 2);
    for (int e = tid; e < boxes * pad * 8; e += CL_THREADS) {
      const int bx = e / (pad * 8), r = ps + (e / 8) % pad;
      *reinterpret_cast<uint4*>(ring + (size_t)bx * geo.slot + r * 128 + (e % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  cluster_sync();   // every barrier of the cluster is set before any copy lands

  if (warp == CL_WARPS) {
    // Producer: each page's boxes, issued by the leader once for the
    // cluster and multicast into every CTA's stage.
    if (lane == 0) {
      const uint32_t tx = (uint32_t)nb * ps * 128 * (alias ? 1 : 2);
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      int n_rem = 0;
      for (int i = 0; i < n_ld; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        mbar_expect_tx(&full[s], tx);
        if (rank == 0) {
          const int pg = pages[i];
          const bool rem = pg < 0;
          const int row0 = (rem ? -1 - pg : pg) * ps;
          unsigned char* st = ring + (size_t)s * geo.stage;
          for (int j = 0; j < nb; ++j) {
            tma_load_3d_multicast(st + (size_t)j * geo.slot, rem ? &kr_map : &kl_map,
                                  j * CL_COLS, kvh, row0, &full[s], mask);
            if (!alias)
              tma_load_3d_multicast(st + k_bytes + (size_t)j * geo.slot, rem ? &vr_map : &vl_map,
                                    j * CL_COLS, kvh, row0, &full[s], mask);
          }
          n_rem += rem;
        }
      }
      if (n_rem && host_bytes != nullptr)
        atomicAdd(host_bytes, (unsigned long long)n_rem * (alias ? 1 : 2) * ps * hd * 2);
    }
    __syncwarp();
  } else {
    // Consumers: warp w sums dims [16 nb w, 16 nb (w + 1)) of the scores
    // and owns output columns [16 nb w, 16 nb (w + 1)).
    const bool mine = ng > 0;   // a padding CTA of the last cluster only frees stages
    const int g = lane / 4, t4 = lane % 4;
    float o[NBM][2][4];
#pragma unroll
    for (int t = 0; t < NBM; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) o[t][h][0] = o[t][h][1] = o[t][h][2] = o[t][h][3] = 0.f;
    float m_r[2] = {DAK_NEG_INF, DAK_NEG_INF};   // running max (log2 units), rows g and g + 8
    float l_r[2] = {0.f, 0.f};                   // this thread's part of the running sum
    int blk = 0;                                 // score blocks so far: the partials' buffer
    for (int c = 0; c < n_ld; ++c) {
      const int s = c % stages;
      mbar_wait(&full[s], (c / stages) & 1);
      const unsigned char* k_s = ring + (size_t)s * geo.stage;
      unsigned char* v_s = ring + (size_t)s * geo.stage + (alias ? 0 : k_bytes);
      const int rows = n - c * ps < ps ? n - c * ps : ps;
      if (mine) {
        if (rows < ps) {
          // the last page: its rows past the length leave the product
          const int cut = ps - rows;
          for (int e = tid; e < nb * cut * 8; e += CL_WARPS * 32) {
            const int j = e / (cut * 8), r = rows + (e / 8) % cut;
            *reinterpret_cast<uint4*>(v_s + (size_t)j * geo.slot + r * 128 + (e % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          consumers_sync();
        }
        for (int k0 = 0; k0 < rows; k0 += CL_KEYS) {
          // this warp's share of S = Q K^T for keys k0 .. k0 + 15
          float sp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int t = 0; t < nb; ++t) {
            const int kk = warp * nb + t;            // 16 dims: box kk / 4, pieces 2 (kk % 4) + ...
            const int j = kk >> 2, pc = (kk & 3) * 2;
            uint32_t a[4], bb[4];
            ldmatrix_x4(a, q_s + (size_t)j * CL_HEADS * 128 + swizzled(lane % 16, pc + lane / 16));
            ldmatrix_x4(bb, k_s + (size_t)j * geo.slot +
                                swizzled(k0 + (lane / 16) * 8 + lane % 8, pc + (lane / 8) % 2));
            mma_bf16(sp[0], a, bb[0], bb[1]);
            mma_bf16(sp[1], a, bb[2], bb[3]);
          }
          float* rb = red + (blk & 1) * (CL_WARPS * 32 * 8);
          *reinterpret_cast<float4*>(rb + (warp * 32 + lane) * 8) =
              make_float4(sp[0][0], sp[0][1], sp[0][2], sp[0][3]);
          *reinterpret_cast<float4*>(rb + (warp * 32 + lane) * 8 + 4) =
              make_float4(sp[1][0], sp[1][1], sp[1][2], sp[1][3]);
          consumers_sync();
          ++blk;
          // the whole scores, the partials added in warp order
          float sc[2][4];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float acc = rb[lane * 8 + e];
#pragma unroll
            for (int w = 1; w < CL_WARPS; ++w) acc += rb[(w * 32 + lane) * 8 + e];
            sc[e / 4][e % 4] = acc;
          }
          float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
              const float x = key < rows ? sc[nt][e] * scale_log2 : DAK_NEG_INF;
              sc[nt][e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
          }
          float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            corr[i] = exp2f(m_r[i] - mx[i]);
            m_r[i] = mx[i];
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[nt][e] = exp2f(sc[nt][e] - mx[e >> 1]);
              rs[e >> 1] += sc[nt][e];
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
          // O += P V on this warp's columns, P (16 heads x 16 keys) as bf16
          const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                                 pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
          const int v_row = k0 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
          for (int t = 0; t < NBM; ++t) {
            if (t < nb) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                o[t][h][0] *= corr[0];
                o[t][h][1] *= corr[0];
                o[t][h][2] *= corr[1];
                o[t][h][3] *= corr[1];
              }
              const int np = warp * nb + t;          // 16 columns: box np / 4
              uint32_t bb[4];
              ldmatrix_x4_trans(bb, v_s + (size_t)(np >> 2) * geo.slot +
                                        swizzled(v_row, (np & 3) * 2 + lane / 16));
              mma_bf16(o[t][0], a, bb[0], bb[1]);
              mma_bf16(o[t][1], a, bb[2], bb[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) {   // this warp is done with the stage
        mbar_arrive(&empty[s]);
        if (rank != 0) mbar_arrive_cluster(&empty[s], 0);
      }
    }
    if (mine) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_r[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = 1.f / fmaxf(l, 1e-30f);   // lens == 0: zeros
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        if (r >= ng) continue;
        bf16* og = out + ((size_t)b * H + (size_t)(g0 + r) * Kh + kvh) * hd;
#pragma unroll
        for (int t = 0; t < NBM; ++t) {
          if (t >= nb) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = (warp * nb + t) * 16 + h * 8 + 2 * t4;   // hd % 8 == 0: col + 1 < hd
            if (col < hd)
              *reinterpret_cast<__nv_bfloat162*>(og + col) =
                  __floats2bfloat162_rn(o[t][h][2 * i] * inv[i], o[t][h][2 * i + 1] * inv[i]);
          }
        }
      }
    }
  }
  cluster_sync();   // no multicast write or remote arrival lands in a retired CTA
}

// Whether the cluster design takes a launch's shapes: bf16 above hd 256,
// rows a tensor map describes (16-byte multiples, pages of at most 256
// rows), and at least one ring stage fits; and its operands: 16-byte
// aligned bases, q's too.
inline bool cluster_shapes_ok(int B, int hd, int ps, int MP, int window, bool alias, int elem) {
  return elem == 2 && hd > 256 && hd % 8 == 0 && ps <= 256 &&
         cluster_stages(B, hd, ps, MP, window, alias) >= 1;
}
inline bool cluster_takes(const Paged& a, int elem) {
  return cluster_shapes_ok(a.B, a.hd, a.ps, a.MP, a.window, a.alias, elem) && aligned16(a.q) &&
         aligned16(a.kl) && aligned16(a.vl) && aligned16(a.kr) && aligned16(a.vr);
}

template <int NBM>
int launch_cluster(const Paged& a, cudaStream_t stream) {
  const int stages = cluster_stages(a.B, a.hd, a.ps, a.MP, a.window, a.alias);
  const size_t smem = cluster_smem(a.B, a.hd, a.ps, a.MP, stages, a.alias);
  CUtensorMap maps[4]{};
  const void* base[4] = {a.kl, a.vl, a.kr, a.vr};
  const int pages[4] = {a.Pl, a.Pl, a.Pr, a.Pr};
  const uint64_t pitch[2] = {(uint64_t)a.hd * 2, (uint64_t)a.Kh * a.hd * 2};
  const uint32_t box_dim[3] = {CL_COLS, 1, (uint32_t)a.ps};
  for (int i = 0; i < 4; ++i) {
    const uint64_t dims[3] = {(uint64_t)a.hd, (uint64_t)a.Kh, (uint64_t)pages[i] * a.ps};
    if (int e = dak_encode(&maps[i], base[i], 2, 3, dims, pitch, box_dim,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
  }
  auto kern = paged_attn_cluster_kernel<NBM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_hb = cluster_blocks(a.H / a.Kh);
  const int csize = cluster_ctas(n_hb);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_hb + csize - 1) / csize * csize, a.Kh, a.B);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  e = cudaLaunchKernelEx(&cfg, kern, maps[0], maps[1], maps[2], maps[3],
                         static_cast<const bf16*>(a.q), a.table, a.tier, a.lens,
                         static_cast<bf16*>(a.out), a.host_bytes, a.B, a.H, a.Kh, a.hd, a.ps,
                         a.MP, a.Pl, a.Pr, scale_log2, stages, (int)a.alias);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// design 0: the dispatch's own choice (the cluster design where it takes
// the launch, else the head-group design); 1: the head-group design.
template <typename T>
int dispatch_attn(const Paged& a, int design, cudaStream_t s) {
  if (design == 0 && cluster_takes(a, sizeof(T))) {
    return a.hd <= 9 * CL_COLS ? launch_cluster<9>(a, s) : launch_cluster<16>(a, s);
  }
  return dispatch_head_group<T>(a, s);
}

__global__ void scatter_rows_kernel(unsigned char* __restrict__ pool,
                                    const unsigned char* __restrict__ rows,
                                    const int* __restrict__ wr_tier,
                                    const int* __restrict__ wr_idx,
                                    const int* __restrict__ wr_off, int tier_sel, int P,
                                    int ps, int row_bytes, bool vec) {
  const int b = blockIdx.x;
  if (wr_tier[b] != tier_sel) return;   // this slot's row goes to the other tier
  const int idx = wr_idx[b], off = wr_off[b];
  if (idx < 0 || idx >= P || off < 0 || off >= ps) return;
  unsigned char* dst = pool + ((size_t)idx * ps + off) * row_bytes;
  const unsigned char* src = rows + (size_t)b * row_bytes;
  if (vec) {
    for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = src[i];
  }
}

inline bool attn_args_ok(int B, int H, int Kh, int hd, int ps, int MP, int window, int dtype,
                         int design) {
  return B > 0 && Kh > 0 && H % Kh == 0 && hd > 0 && hd <= 1024 && ps > 0 && MP > 0 &&
         window >= 1 && (dtype == 0 || dtype == 1) && (design == 0 || design == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The remote pools must be mapped host
// or device memory (dak_remote_ptr); hd <= 1024.  `alias` says the V pools
// are the K pools (refused if the pointers differ).  `design` 0 is the
// dispatch's own choice, 1 the head-group design (kept to time the two
// against each other).  Remote page bytes loaded are added to `host_bytes`
// if not null.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_paged_attention(const void* q, const void* k_local, const void* v_local,
                                   const void* k_remote, const void* v_remote,
                                   const int* table, const int* tier, const int* lens,
                                   void* out, unsigned long long* host_bytes, int B, int H,
                                   int Kh, int hd, int ps, int MP, int P_local, int P_remote,
                                   float scale, int window, int alias, int design, int dtype,
                                   void* stream) {
  if (!attn_args_ok(B, H, Kh, hd, ps, MP, window, dtype, design) || P_local <= 0 ||
      P_remote <= 0 || (alias && (k_local != v_local || k_remote != v_remote)))
    return DAK_ERR_BAD_ARGUMENT;
  const void* kr = nullptr;
  const void* vr = nullptr;
  int e = dak_remote_ptr(k_remote, &kr);
  if (e) return e;
  e = dak_remote_ptr(v_remote, &vr);
  if (e) return e;
  const Paged a{q,  k_local, v_local, kr, vr, table, tier,     lens,     out,   host_bytes,
                B,  H,       Kh,      hd, ps, MP,    P_local,  P_remote, scale, window,
                alias != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_attn<float>(a, design, s)
                    : dispatch_attn<__nv_bfloat16>(a, design, s);
}

// Write rows[b] (row_bytes each) into pool page (wr_idx[b], wr_off[b]) for
// every slot whose wr_tier[b] == tier_sel.  `pool` is one layer's
// [P, ps, row] pool; with `remote` set it must be mapped host memory.
extern "C" int dak_scatter_rows(void* pool, const void* rows, const int* wr_tier,
                                const int* wr_idx, const int* wr_off, int tier_sel, int B,
                                int P, int ps, int row_bytes, int remote, void* stream) {
  if (B <= 0 || P <= 0 || ps <= 0 || row_bytes <= 0) return DAK_ERR_BAD_ARGUMENT;
  void* dst = pool;
  if (remote) {
    const void* mapped = nullptr;
    const int e = dak_mapped_host_ptr(pool, &mapped);
    if (e) return e;
    dst = const_cast<void*>(mapped);
  }
  const bool vec = row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  scatter_rows_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(rows), wr_tier,
      wr_idx, wr_off, tier_sel, P, ps, row_bytes, vec);
  return cudaGetLastError();
}

// What a dak_paged_attention launch with these arguments and the dispatch's
// own design would hold, for 16-byte aligned operands: its ring stages and
// its dynamic shared memory in bytes.  Launches nothing; the wrapper's
// shared-memory footprint is checked against it.  Returns 0 or
// DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_paged_attention_smem(int B, int H, int Kh, int hd, int ps, int MP, int window,
                                        int dtype, int alias, long long* bytes, int* stages) {
  if (!attn_args_ok(B, H, Kh, hd, ps, MP, window, dtype, 0) || bytes == nullptr ||
      stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  const int elem = dtype == 0 ? 4 : 2;
  if (cluster_shapes_ok(B, hd, ps, MP, window, alias != 0, elem)) {
    *stages = cluster_stages(B, hd, ps, MP, window, alias != 0);
    *bytes = (long long)cluster_smem(B, hd, ps, MP, *stages, alias != 0);
    return 0;
  }
  const int dpl = decode::dims_per_lane(hd);
  *bytes = (long long)paged_smem(B, hd, ps, MP, window, elem, dpl,
                                 decode::heads_per_cta(dpl, H, Kh), stages);
  return 0;
}
