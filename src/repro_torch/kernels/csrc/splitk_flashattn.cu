// SplitK_FlashAttn on Hopper, batch-split layout (paper §5): decode
// attention over a dense KV cache whose requests are split across tiers.
//
// Replaces: src/repro/kernels/splitk_flashattn.py `_kernel` (line 33;
// pallas_call at :220, wrapper `splitk_flashattn` :166), reached through
// `ops.tiered_decode_attention` from the batch-split `tiered_decode_step`.
//
// Requests [0, B_loc) read K/V rows from the local cache in HBM
// ([B_loc, S, Kh, hd]); requests [B_loc, B) from the remote cache in
// pinned, device-mapped host memory ([B_rem, S, Kh, hd]).  Every request
// attends the first `kv_len` positions (the step is slot-aligned); rows
// [kv_len, S) are never read.
//
// Bound on this card: bytes over the host link.  Each cached K/V element is
// read once and used for G = H/Kh query heads (G = 1 for llama2-7b), about
// one multiply-add per byte.  The remote requests' rows cross the PCIe host
// link, which kernels read at 30-33 GB/s at most on some H100 machines
// measured and at ~50 GB/s on others (chip_smoke.py --phases 1,9), and
// their bytes over that rate are the floor; the local rows stream from HBM
// at 3.35 TB/s and finish long before.
// What the design does about it:
//  * Direct access: a remote request's rows go straight from the mapped host
//    cache into shared memory, never staged in HBM.
//  * TMA and a ring that overlaps: one thread issues each chunk of CHUNK =
//    32 rows as two boxes (K and V, CHUNK x hd of one kv head) through 4-D
//    tensor maps over each tier viewed as [B_tier, kv_len, Kh, hd], whose
//    row bound is kv_len (rows of the last chunk past kv_len arrive as zeros
//    and are not read over the link), into a ring of window + 1 stages, so
//    `window` loads stay in flight while a chunk is folded in and at window
//    1 load and update overlap.  `window` never changes the result.  The
//    design this replaced (csrc/decode_attn_cpasync.cu) moved 32 KB a round
//    trip and already read the link at 0.89-0.94x of its cap at llama2-7b's
//    shapes, so here the two are level (chip_smoke.py --phases 1,10 on an
//    H100 80GB HBM3).  Caches a tensor map cannot describe (hd*elem not a
//    multiple of 16 B, hd above 256, an unaligned base) take element loads
//    into the same ring (template flag TMA = false).
//  * One CTA per (request, query-head group, kv head) walks the request's
//    kv_len positions: B*Kh CTAs, 128 for llama2-7b at batch 4.
//  * Host-first batch order (`host_first_batch_order` in the reference):
//    CTAs of remote requests come first in block order, so the hardware
//    issues the long-latency host reads first and the local requests fill
//    the SMs behind them.
//  * A warp-level fp32 online softmax in registers over the group-major
//    query heads h = g*Kh + kvh, scale hd**-0.5 (decode_attn.cuh, shared
//    with paged_flashattn.cu): one block barrier per chunk.  Plain FMA: at
//    one multiply-add per byte the tensor cores are not the limit.
#include <cmath>

#include "decode_attn.cuh"

namespace {

using decode::THREADS;
constexpr int CHUNK = 32;   // rows of one load

template <typename T, int DPL, int HPW, bool TMA>
__global__ void __launch_bounds__(THREADS) splitk_attn_kernel(
    const __grid_constant__ CUtensorMap kl_map,   // tiers as [B_tier, kv_len, Kh, hd]
    const __grid_constant__ CUtensorMap vl_map,
    const __grid_constant__ CUtensorMap kr_map,   // (mapped host)
    const __grid_constant__ CUtensorMap vr_map,
    const T* __restrict__ kl,    // [B_loc, S, Kh, hd] device (element loads)
    const T* __restrict__ vl,
    const T* __restrict__ kr,    // [B_rem, S, Kh, hd] mapped host (element loads)
    const T* __restrict__ vr,
    const T* __restrict__ q,     // [B, H, hd], B = B_loc + B_rem, local requests first
    T* __restrict__ out,         // [B, H, hd]
    int B_loc, int B_rem, int S, int H, int Kh, int hd, int kv_len, float scale, int stages,
    int n_hg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t box = decode::box_bytes(CHUNK, hd, sizeof(T));
  size_t ring = (size_t)stages * 2 * box;
  if (ring < decode::merge_bytes(DPL, HPW)) ring = decode::merge_bytes(DPL, HPW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring);

  const int tid = threadIdx.x;
  const int G = H / Kh;
  int x = blockIdx.x;
  const int kvh = x % Kh;
  x /= Kh;
  const int hg = x % n_hg;
  const int rank = x / n_hg;
  // host-first batch order: requests [B_loc, B) first, then [0, B_loc)
  const bool rem = rank < B_rem;
  const int bt = rem ? rank : rank - B_rem;   // within its tier
  const int b = rem ? B_loc + bt : bt;
  const int n_ld = (kv_len + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], TMA ? 1 : THREADS);
    mbar_fence_init();
  }
  const int g0 = hg * HPW;
  const int ng = G - g0 < HPW ? G - g0 : HPW;
  decode::WarpState<DPL, HPW> st;
  decode::warp_init(st, q, b, H, Kh, kvh, g0, ng, hd, scale);
  __syncthreads();   // barriers initialised

  const size_t row = (size_t)Kh * hd;   // elements between positions of a request
  const CUtensorMap* k_m = rem ? &kr_map : &kl_map;
  const CUtensorMap* v_m = rem ? &vr_map : &vl_map;
  auto issue = [&](int c) {             // chunk c into stage c % stages
    unsigned char* dst = smem + (size_t)(c % stages) * 2 * box;
    uint64_t* bar = &full[c % stages];
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect_tx(bar, 2u * CHUNK * hd * (uint32_t)sizeof(T));
        tma_load_4d(dst, k_m, 0, kvh, c * CHUNK, bt, bar);
        tma_load_4d(dst + box, v_m, 0, kvh, c * CHUNK, bt, bar);
      }
    } else {
      const int rows = kv_len - c * CHUNK < CHUNK ? kv_len - c * CHUNK : CHUNK;
      const size_t at = ((size_t)bt * S + (size_t)c * CHUNK) * row + (size_t)kvh * hd;
      const T* kp = (rem ? kr : kl) + at;
      const T* vp = (rem ? vr : vl) + at;
      T* kd = reinterpret_cast<T*>(dst);
      T* vd = reinterpret_cast<T*>(dst + box);
      for (int e = tid; e < rows * hd; e += THREADS) {
        const int t = e / hd, d = e % hd;
        kd[e] = kp[t * row + d];
        vd[e] = vp[t * row + d];
      }
      mbar_arrive(bar);
    }
  };
  auto rows = [&](int c) {
    const int r = kv_len - c * CHUNK;
    return r < CHUNK ? r : CHUNK;
  };
  decode::decode_walk<DPL, HPW, T>(st, smem, full, stages, box, n_ld, hd, ng, issue, rows);
  decode::decode_write(st, n_ld > 0, smem, out, b, H, Kh, kvh, g0, ng, hd);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The ring stages and dynamic shared memory of a batch-split launch: the
// ring of CHUNK-row K/V boxes over kv_len positions and its mbarriers.
inline size_t split_smem(int hd, int kv_len, int window, int elem, int dpl, int hpw,
                         int* stages) {
  const uint32_t box = decode::box_bytes(CHUNK, hd, elem);
  *stages = decode::ring_stages(window, 2 * box, (kv_len + CHUNK - 1) / CHUNK);
  return decode::launch_smem(*stages, box, dpl, hpw, 0);
}

struct Split {
  const void *q, *kl, *vl, *kr, *vr;
  void* out;
  int B_loc, B_rem, S, H, Kh, hd, kv_len, window;
};

template <typename T, int DPL, int HPW, bool TMA>
int launch_splitk(const Split& a, cudaStream_t stream) {
  const int G = a.H / a.Kh;
  const int n_hg = (G + HPW - 1) / HPW;
  int stages = 0;
  const size_t smem = split_smem(a.hd, a.kv_len, a.window, sizeof(T), DPL, HPW, &stages);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  CUtensorMap maps[4]{};
  if constexpr (TMA) {
    // an empty tier's maps are encoded on the other tier (never read)
    const bool has_loc = a.B_loc > 0, has_rem = a.B_rem > 0;
    const void* base[4] = {has_loc ? a.kl : a.kr, has_loc ? a.vl : a.vr,
                           has_rem ? a.kr : a.kl, has_rem ? a.vr : a.vl};
    const int reqs[4] = {has_loc ? a.B_loc : a.B_rem, has_loc ? a.B_loc : a.B_rem,
                         has_rem ? a.B_rem : a.B_loc, has_rem ? a.B_rem : a.B_loc};
    const size_t es = sizeof(T);
    const uint64_t pitch[3] = {(uint64_t)a.hd * es, (uint64_t)a.Kh * a.hd * es,
                               (uint64_t)a.S * a.Kh * a.hd * es};
    const uint32_t box_dim[4] = {(uint32_t)a.hd, 1, (uint32_t)CHUNK, 1};
    for (int i = 0; i < 4; ++i) {
      const uint64_t dims[4] = {(uint64_t)a.hd, (uint64_t)a.Kh, (uint64_t)a.kv_len,
                                (uint64_t)reqs[i]};
      if (int e = dak_encode(&maps[i], base[i], sizeof(T), 4, dims, pitch, box_dim)) return e;
    }
  }
  auto kern = splitk_attn_kernel<T, DPL, HPW, TMA>;
  if (smem > 46 * 1024) {   // the default 48 KB covers static shared memory too
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.0f / sqrtf((float)a.hd);
  kern<<<(a.B_loc + a.B_rem) * n_hg * a.Kh, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.kl),
      static_cast<const T*>(a.vl), static_cast<const T*>(a.kr), static_cast<const T*>(a.vr),
      static_cast<const T*>(a.q), static_cast<T*>(a.out), a.B_loc, a.B_rem, a.S, a.H, a.Kh,
      a.hd, a.kv_len, scale, stages, n_hg);
  return cudaGetLastError();
}

// One query head per CTA when G = 1, else as many as registers allow; above
// hd 256 (DPL 16, 32) a tensor map's box cannot hold a row: element loads.
template <typename T, int DPL>
int dispatch_heads(const Split& a, bool tma, cudaStream_t s) {
  if constexpr (DPL > 8) {
    return launch_splitk<T, DPL, 1, false>(a, s);
  } else {
    constexpr int HM = decode::max_heads(DPL);
    if (decode::heads_per_cta(DPL, a.H, a.Kh) == 1)
      return tma ? launch_splitk<T, DPL, 1, true>(a, s) : launch_splitk<T, DPL, 1, false>(a, s);
    return tma ? launch_splitk<T, DPL, HM, true>(a, s) : launch_splitk<T, DPL, HM, false>(a, s);
  }
}

template <typename T>
int dispatch_splitk(const Split& a, cudaStream_t s) {
  // an empty tier's pointers are never read
  const bool tma = a.hd * sizeof(T) % 16 == 0 &&
                   (a.B_loc == 0 || (aligned16(a.kl) && aligned16(a.vl))) &&
                   (a.B_rem == 0 || (aligned16(a.kr) && aligned16(a.vr)));
  switch (decode::dims_per_lane(a.hd)) {
    case 1: return dispatch_heads<T, 1>(a, tma, s);
    case 2: return dispatch_heads<T, 2>(a, tma, s);
    case 4: return dispatch_heads<T, 4>(a, tma, s);
    case 8: return dispatch_heads<T, 8>(a, tma, s);
    case 16: return dispatch_heads<T, 16>(a, false, s);
    default: return dispatch_heads<T, 32>(a, false, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  With B_rem > 0 the remote caches must be
// mapped host memory; hd <= 1024.  Returns 0, a cudaError_t, or a DAK_ERR_*
// code.
extern "C" int dak_splitk_attention(const void* q, const void* k_local, const void* v_local,
                                    const void* k_remote, const void* v_remote, void* out,
                                    int B_loc, int B_rem, int S, int H, int Kh, int hd,
                                    int kv_len, int window, int dtype, void* stream) {
  if (B_loc < 0 || B_rem < 0 || B_loc + B_rem <= 0 || Kh <= 0 || H % Kh || hd <= 0 ||
      hd > 1024 || kv_len < 1 || kv_len > S || window < 1 || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* kr = nullptr;
  const void* vr = nullptr;
  if (B_rem > 0) {
    int e = dak_mapped_host_ptr(k_remote, &kr);
    if (e) return e;
    e = dak_mapped_host_ptr(v_remote, &vr);
    if (e) return e;
  }
  const Split a{q, k_local, v_local, kr, vr, out, B_loc, B_rem, S, H, Kh, hd, kv_len, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_splitk<float>(a, s) : dispatch_splitk<__nv_bfloat16>(a, s);
}

// What a dak_splitk_attention launch with these arguments would hold: its
// ring stages and its dynamic shared memory in bytes.  Launches nothing;
// the wrapper's shared-memory footprint is checked against it.  Returns 0
// or DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_splitk_attention_smem(int H, int Kh, int hd, int kv_len, int window, int dtype,
                                         long long* bytes, int* stages) {
  if (Kh <= 0 || H % Kh || hd <= 0 || hd > 1024 || kv_len < 1 || window < 1 ||
      (dtype != 0 && dtype != 1) || bytes == nullptr || stages == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  const int dpl = decode::dims_per_lane(hd);
  *bytes = (long long)split_smem(hd, kv_len, window, dtype == 0 ? 4 : 2, dpl,
                                 decode::heads_per_cta(dpl, H, Kh), stages);
  return 0;
}
