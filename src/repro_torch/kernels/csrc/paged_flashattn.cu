// Paged SplitK_FlashAttn on Hopper: ragged, paged, tiered decode attention.
//
// Replaces: src/repro/kernels/splitk_flashattn.py `_paged_kernel` (pallas_call
// at :378, wrapper `paged_splitk_flashattn` :331), reached through
// `ops.paged_decode_attention`.
//
// Bound on this card: bytes.  Each cached K/V element is read once and used
// for G = H/Kh query heads (G = 1 for llama2-7b), about one multiply-add per
// byte: local pages stream from HBM at 3.35 TB/s, remote pages from pinned
// host memory over the PCIe host link, and the remote pages' bytes over the
// link rate is the floor.
//
// What the design does about it:
//  * One CTA per (slot, kv head) reads only the pages that slot's length
//    covers, each page from the pool its page-table tier names: local pages
//    from device memory, remote pages straight from the mapped host pointer
//    into shared memory (cp.async), never staged into HBM.
//  * Host-first slot order: CTAs are numbered so that slots holding any
//    in-use remote page come first (`host_first_slot_order`); each CTA
//    derives its slot from the page tables itself, so no extra launch.
//  * `window` pages (K and V) are in flight per CTA in a shared-memory ring.
//  * Online softmax in fp32 over the group-major query heads
//    h = g*Kh + kvh; `lens == 0` gives zeros; `scale` overrides hd**-0.5.
//    A caller that passes the K pool as the V pool gets V read from it.
//
// `dak_scatter_rows` below is the decode step's K/V row writer (the
// reference's `.at[].set` in `serving.tiered_decode._paged_writer`): a
// helper, not a TPU kernel.  It writes each slot's new row into its page
// in one tier's pool, the remote pool through its mapped pointer.
#include "dak_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;   // the reference's mask value, finite

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const T* __restrict__ q,     // [B, H, hd]
    const T* __restrict__ kl,    // [Pl, ps, Kh, hd] device
    const T* __restrict__ vl,
    const T* __restrict__ kr,    // [Pr, ps, Kh, hd] mapped host
    const T* __restrict__ vr,
    const int* __restrict__ table,   // [B, MP]
    const int* __restrict__ tier,    // [B, MP]
    const int* __restrict__ lens,    // [B]
    T* __restrict__ out,             // [B, H, hd]
    int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr, float scale,
    int stages) {
  const int G = H / Kh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);               // [stages][2][ps*hd]
  float* q_s = reinterpret_cast<float*>(kv_s + (size_t)stages * 2 * ps * hd);
  float* acc_s = q_s + G * hd;                            // [G][hd]
  float* sc_s = acc_s + G * hd;                           // [G][ps]
  float* m_s = sc_s + G * ps;                             // [G]
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  int* has_remote = reinterpret_cast<int*>(corr_s + G);  // [B]
  __shared__ int slot_sh;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x / Kh, kvh = blockIdx.x % Kh;

  // Host-first slot order, stable within each class (argsort of !has_remote).
  for (int bb = tid; bb < B; bb += THREADS) {
    int used = (lens[bb] + ps - 1) / ps;
    if (used > MP) used = MP;
    int f = 0;
    for (int p = 0; p < used; ++p) f |= tier[bb * MP + p] > 0;
    has_remote[bb] = f;
  }
  __syncthreads();
  if (tid == 0) {
    int n_rem = 0;
    for (int bb = 0; bb < B; ++bb) n_rem += has_remote[bb];
    const int want = rank < n_rem ? 1 : 0;
    const int target = want ? rank : rank - n_rem;
    int seen = 0, sel = 0;
    for (int bb = 0; bb < B; ++bb) {
      if (has_remote[bb] != want) continue;
      if (seen == target) { sel = bb; break; }
      ++seen;
    }
    slot_sh = sel;
  }
  __syncthreads();
  const int b = slot_sh;
  const int n = lens[b];
  int n_chunks = (n + ps - 1) / ps;
  if (n_chunks > MP) n_chunks = MP;

  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e % hd;
    q_s[e] = to_f32(q[((size_t)b * H + g * Kh + kvh) * hd + d]) * scale;
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) { m_s[g] = NEG_INF; l_s[g] = 0.f; }

  const size_t row_stride = (size_t)Kh * hd;   // between tokens of a page
  auto load_page = [&](int c, int slot) {
    const bool rem = tier[b * MP + c] > 0;
    int idx = table[b * MP + c];
    const int P = rem ? Pr : Pl;
    idx = idx < 0 ? 0 : (idx >= P ? P - 1 : idx);
    const T* kp = (rem ? kr : kl) + (size_t)idx * ps * row_stride + (size_t)kvh * hd;
    const T* vp = (rem ? vr : vl) + (size_t)idx * ps * row_stride + (size_t)kvh * hd;
    T* kd = kv_s + (size_t)slot * 2 * ps * hd;
    T* vd = kd + ps * hd;
    if constexpr (VEC) {
      constexpr int EPC = 16 / sizeof(T);
      const int per_row = hd / EPC;
      for (int ch = tid; ch < ps * per_row; ch += THREADS) {
        const int t = ch / per_row, d = (ch % per_row) * EPC;
        cp_async_16(kd + t * hd + d, kp + t * row_stride + d, 16);
        cp_async_16(vd + t * hd + d, vp + t * row_stride + d, 16);
      }
    } else {
      for (int e = tid; e < ps * hd; e += THREADS) {
        const int t = e / hd, d = e % hd;
        kd[e] = kp[t * row_stride + d];
        vd[e] = vp[t * row_stride + d];
      }
    }
  };

  for (int s = 0; s < stages; ++s) {
    if (s < n_chunks) load_page(s, s);
    cp_async_commit();
  }
  __syncthreads();   // q_s / m_s / l_s initialised

  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % stages;
    cp_async_wait(stages - 1);
    __syncthreads();
    const T* kd = kv_s + (size_t)slot * 2 * ps * hd;
    const T* vd = kd + ps * hd;
    // scores: one warp per (query head, token) pair
    for (int pr = warp; pr < G * ps; pr += WARPS) {
      const int g = pr / ps, t = pr % ps;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s = fmaf(q_s[g * hd + d], to_f32(kd[t * hd + d]), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc_s[pr] = (c * ps + t < n) ? s : NEG_INF;
    }
    __syncthreads();
    // online-softmax update, one thread per query head
    for (int g = tid; g < G; g += THREADS) {
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, sc_s[g * ps + t]);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sc_s[g * ps + t] - m_new);
        sc_s[g * ps + t] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      corr_s[g] = corr;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += THREADS) {
      const int g = e / hd, d = e % hd;
      float a = acc_s[e] * corr_s[g];
      for (int t = 0; t < ps; ++t) a = fmaf(sc_s[g * ps + t], to_f32(vd[t * hd + d]), a);
      acc_s[e] = a;
    }
    __syncthreads();   // done with this slot and with sc_s
    if (c + stages < n_chunks) load_page(c + stages, slot);
    cp_async_commit();
  }

  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e % hd;
    out[((size_t)b * H + g * Kh + kvh) * hd + d] = from_f32<T>(acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, bool VEC>
int launch_attn(const void* q, const void* kl, const void* vl, const void* kr,
                const void* vr, const int* table, const int* tier, const int* lens,
                void* out, int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr,
                float scale, int stages, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem = (size_t)stages * 2 * ps * hd * sizeof(T) +
                      ((size_t)2 * G * hd + (size_t)G * ps + 3 * (size_t)G) * sizeof(float) +
                      (size_t)B * sizeof(int);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  auto kern = paged_attn_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * Kh, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kl), static_cast<const T*>(vl),
      static_cast<const T*>(kr), static_cast<const T*>(vr), table, tier, lens,
      static_cast<T*>(out), B, H, Kh, hd, ps, MP, Pl, Pr, scale, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_attn(const void* q, const void* kl, const void* vl, const void* kr,
                  const void* vr, const int* table, const int* tier, const int* lens,
                  void* out, int B, int H, int Kh, int hd, int ps, int MP, int Pl,
                  int Pr, float scale, int stages, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = hd % EPC == 0 && al(kl) && al(vl) && al(kr) && al(vr);
  return vec ? launch_attn<T, true>(q, kl, vl, kr, vr, table, tier, lens, out, B, H, Kh, hd,
                                    ps, MP, Pl, Pr, scale, stages, stream)
             : launch_attn<T, false>(q, kl, vl, kr, vr, table, tier, lens, out, B, H, Kh, hd,
                                     ps, MP, Pl, Pr, scale, stages, stream);
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
// memory.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_paged_attention(const void* q, const void* k_local, const void* v_local,
                                   const void* k_remote, const void* v_remote,
                                   const int* table, const int* tier, const int* lens,
                                   void* out, int B, int H, int Kh, int hd, int ps, int MP,
                                   int P_local, int P_remote, float scale, int window,
                                   int dtype, void* stream) {
  if (B <= 0 || Kh <= 0 || H % Kh || hd <= 0 || ps <= 0 || MP <= 0 || P_local <= 0 ||
      P_remote <= 0 || window < 1 || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* kr = nullptr;
  const void* vr = nullptr;
  int e = dak_mapped_host_ptr(k_remote, &kr);
  if (e) return e;
  e = dak_mapped_host_ptr(v_remote, &vr);
  if (e) return e;
  int stages = window < MP ? window : MP;
  if (stages > DAK_MAX_WINDOW) stages = DAK_MAX_WINDOW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_attn<float>(q, k_local, v_local, kr, vr, table, tier, lens, out, B, H,
                                    Kh, hd, ps, MP, P_local, P_remote, scale, stages, s)
             : dispatch_attn<__nv_bfloat16>(q, k_local, v_local, kr, vr, table, tier, lens,
                                            out, B, H, Kh, hd, ps, MP, P_local, P_remote,
                                            scale, stages, s);
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
