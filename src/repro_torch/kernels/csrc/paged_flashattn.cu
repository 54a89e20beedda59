// Paged SplitK_FlashAttn on Hopper: ragged, paged, tiered decode attention.
//
// Replaces: src/repro/kernels/splitk_flashattn.py `_paged_kernel` (pallas_call
// at :378, wrapper `paged_splitk_flashattn` :331), reached through
// `ops.paged_decode_attention`.
//
// Bound on this card: bytes over the host link.  Each cached K/V element is
// read once and used for G = H/Kh query heads (G = 1 for llama2-7b), about
// one multiply-add per byte.  Local pages stream from HBM at 3.35 TB/s;
// remote pages cross the PCIe host link, which kernels read at 30-33 GB/s at
// most on some H100 machines measured and at ~50 GB/s on others
// (chip_smoke.py --phases 1,9), so the remote pages' bytes over that rate
// are the floor.  What the design does about it:
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
//    H100 80GB HBM3, timed in alternating rounds on one card.  `window`
//    never changes the result.  Rows of a page past the slot's length
//    arrive too and are masked in the update.  Pools a tensor map cannot
//    describe (hd*elem not a multiple of 16 B, hd or page above 256, an
//    unaligned base) take element loads into the same ring (template flag
//    TMA = false).
//  * One CTA per (slot, query-head group, kv head) walks the slot's pages:
//    B*Kh CTAs, 128 for llama2-7b at batch 4, which already fill the card.
//    Cutting each slot's pages across several CTAs (split-KV) changed
//    nothing measurable at llama2-7b's shapes, one slot included, so the
//    kernel does not.
//  * Host-first order: CTAs are numbered so that slots holding any in-use
//    remote page come first, stable within each class (the reference's
//    `host_first_slot_order`); each CTA derives its slot from the page
//    tables itself, so no extra launch.
//  * A warp-level fp32 online softmax in registers over the group-major
//    query heads h = g*Kh + kvh (decode_attn.cuh, shared with
//    splitk_flashattn.cu): one block barrier per page.  `lens == 0` gives
//    zeros; `scale` overrides hd**-0.5; a caller that passes the K pool as
//    the V pool gets V read from it.  Plain FMA: at one multiply-add per
//    byte the tensor cores are not the limit.
//
// `dak_scatter_rows` below is the decode step's K/V row writer (the
// reference's `.at[].set` in `serving.tiered_decode._paged_writer`): a
// helper, not a TPU kernel.  It writes each slot's new row into its page
// in one tier's pool, the remote pool through its mapped pointer.
#include "decode_attn.cuh"

namespace {

using decode::THREADS;

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
    int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr, float scale, int stages,
    int n_hg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t box = decode::box_bytes(ps, hd, sizeof(T));
  size_t ring = (size_t)stages * 2 * box;
  if (ring < decode::merge_bytes(DPL, HPW)) ring = decode::merge_bytes(DPL, HPW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring);
  int* pages = reinterpret_cast<int*>(full + stages);   // [MP]: idx, or -1 - idx if remote
  int* has_remote = pages + MP;                         // [B]
  __shared__ int slot_sh;

  const int tid = threadIdx.x, lane = tid % 32;
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
  auto used_pages = [&](int bb) {
    const int n = lens[bb];
    const int u = n > 0 ? (n + ps - 1) / ps : 0;
    return u < MP ? u : MP;
  };
  // Host-first slot order, stable within each class: every thread flags the
  // slots of its in-use remote pages, then warp 0 counts the flagged slots
  // and finds the slot of this rank, 32 slots per ballot.
  for (int bb = tid; bb < B; bb += THREADS) has_remote[bb] = 0;
  __syncthreads();
  for (int e = tid; e < B * MP; e += THREADS)
    if (tier[e] > 0 && e % MP < used_pages(e / MP)) has_remote[e / MP] = 1;
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
  const int b = slot_sh;
  const int n = lens[b];
  const int n_ld = used_pages(b);
  for (int i = tid; i < n_ld; i += THREADS) {
    const int c = b * MP + i;
    const bool rem = tier[c] > 0;
    const int P = rem ? Pr : Pl;
    int idx = table[c];
    idx = idx < 0 ? 0 : (idx >= P ? P - 1 : idx);
    pages[i] = rem ? -1 - idx : idx;
  }
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
  decode::decode_write(st, n_ld > 0, smem, out, b, H, Kh, kvh, g0, ng, hd);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The ring stages and dynamic shared memory of a paged launch: the ring, its
// mbarriers, then the slot's page list [MP] and the remote flags [B].
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
  int B, H, Kh, hd, ps, MP, Pl, Pr;
  float scale;
  int window;
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
      static_cast<const T*>(a.q), a.table, a.tier, a.lens, static_cast<T*>(a.out), a.B, a.H,
      a.Kh, a.hd, a.ps, a.MP, a.Pl, a.Pr, a.scale, stages, n_hg);
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
int dispatch_attn(const Paged& a, cudaStream_t s) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The remote pools must be mapped host
// or device memory (dak_remote_ptr); hd <= 1024.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_paged_attention(const void* q, const void* k_local, const void* v_local,
                                   const void* k_remote, const void* v_remote,
                                   const int* table, const int* tier, const int* lens,
                                   void* out, int B, int H, int Kh, int hd, int ps, int MP,
                                   int P_local, int P_remote, float scale, int window,
                                   int dtype, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh || hd <= 0 || hd > 1024 || ps <= 0 || MP <= 0 ||
      P_local <= 0 || P_remote <= 0 || window < 1 || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* kr = nullptr;
  const void* vr = nullptr;
  int e = dak_remote_ptr(k_remote, &kr);
  if (e) return e;
  e = dak_remote_ptr(v_remote, &vr);
  if (e) return e;
  const Paged a{q, k_local, v_local, kr, vr, table, tier, lens, out, B, H, Kh, hd, ps, MP,
                P_local, P_remote, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_attn<float>(a, s) : dispatch_attn<__nv_bfloat16>(a, s);
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

// What a dak_paged_attention launch with these arguments would hold: its
// ring stages and its dynamic shared memory in bytes.  Launches nothing;
// the wrapper's shared-memory footprint is checked against it.  Returns 0
// or DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_paged_attention_smem(int B, int H, int Kh, int hd, int ps, int MP, int window,
                                        int dtype, long long* bytes, int* stages) {
  if (B <= 0 || Kh <= 0 || H % Kh || hd <= 0 || hd > 1024 || ps <= 0 || MP <= 0 || window < 1 ||
      (dtype != 0 && dtype != 1) || bytes == nullptr || stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  const int dpl = decode::dims_per_lane(hd);
  *bytes = (long long)paged_smem(B, hd, ps, MP, window, dtype == 0 ? 4 : 2, dpl,
                                 decode::heads_per_cta(dpl, H, Kh), stages);
  return 0;
}
