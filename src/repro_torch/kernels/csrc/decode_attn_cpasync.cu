// The two tiered decode-attention kernels in the design that
// paged_flashattn.cu and splitk_flashattn.cu replaced: one CTA per (slot or
// request, kv head) walks that sequence alone through a `window`-deep ring
// of 16-byte cp.async copies issued by every thread, and folds each chunk
// into an fp32 online softmax kept in shared memory (one thread per query
// head runs the softmax step), before the next load is issued.
//
// Not on any path of the port.  The shipped kernels load by TMA into a
// `window` + 1 ring and keep a warp-level softmax in registers; this copy is
// kept, built only by `_build.load_measurement()`, so that chip_smoke.py
// (--phases 1,10) can time them beside the design they replaced, in one
// call, on one card.  Entry points: `dak_paged_attention_cpasync` and
// `dak_splitk_attention_cpasync`, with the arguments of the shipped kernels.
#include <cmath>

#include "dak_common.cuh"

#define CPASYNC_NEG_INF (-1e30f)

// Floats of shared memory the state takes: q [G][hd] (pre-scaled),
// acc [G][hd], scores [G][cap] for a chunk of up to `cap` rows, m/l/corr [G].
__host__ __device__ inline size_t decode_state_floats(int G, int hd, int cap) {
  return (size_t)2 * G * hd + (size_t)G * cap + 3 * (size_t)G;
}

struct DecodeState {
  float* q;
  float* acc;
  float* sc;
  float* m;
  float* l;
  float* corr;
  int G, hd, cap;
};

__device__ __forceinline__ DecodeState decode_state(float* base, int G, int hd, int cap) {
  DecodeState s;
  s.q = base;
  s.acc = s.q + (size_t)G * hd;
  s.sc = s.acc + (size_t)G * hd;
  s.m = s.sc + (size_t)G * cap;
  s.l = s.m + G;
  s.corr = s.l + G;
  s.G = G;
  s.hd = hd;
  s.cap = cap;
  return s;
}

// THREADS is the calling kernel's block size, the compile-time stride of
// every loop here (as the loops had before they moved into this header).

// Load request b's query heads of kv head `kvh` (times `scale`) and reset
// the state.  The caller's next __syncthreads() publishes it.
template <int THREADS, typename T>
__device__ __forceinline__ void decode_init(const DecodeState& s, const T* __restrict__ q,
                                            int b, int H, int Kh, int kvh, float scale) {
  for (int e = threadIdx.x; e < s.G * s.hd; e += THREADS) {
    const int g = e / s.hd, d = e % s.hd;
    s.q[e] = to_f32(q[((size_t)b * H + g * Kh + kvh) * s.hd + d]) * scale;
    s.acc[e] = 0.f;
  }
  for (int g = threadIdx.x; g < s.G; g += THREADS) {
    s.m[g] = CPASYNC_NEG_INF;
    s.l[g] = 0.f;
  }
}

// Fold `rows` (1..cap) K/V rows, kd/vd [rows][hd] in shared memory, into
// the state.  Call after a __syncthreads() that made the rows visible; it
// ends with one, after which the chunk's buffers may be refilled.
template <int THREADS, typename T>
__device__ __forceinline__ void decode_update(const DecodeState& s, const T* kd, const T* vd,
                                              int rows) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = s.G, hd = s.hd;
  // scores: one warp per (query head, row) pair
  for (int pr = warp; pr < G * rows; pr += WARPS) {
    const int g = pr / rows, t = pr % rows;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(s.q[g * hd + d], to_f32(kd[t * hd + d]), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s.sc[g * s.cap + t] = acc;
  }
  __syncthreads();
  // online-softmax update, one thread per query head
  for (int g = tid; g < G; g += THREADS) {
    float* sc = s.sc + g * s.cap;
    const float m_old = s.m[g];
    float m_new = m_old;
    for (int t = 0; t < rows; ++t) m_new = fmaxf(m_new, sc[t]);
    float sum = 0.f;
    for (int t = 0; t < rows; ++t) {
      const float p = expf(sc[t] - m_new);
      sc[t] = p;
      sum += p;
    }
    const float corr = expf(m_old - m_new);
    s.l[g] = s.l[g] * corr + sum;
    s.m[g] = m_new;
    s.corr[g] = corr;
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd, d = e % hd;
    const float* p = s.sc + g * s.cap;
    float a = s.acc[e] * s.corr[g];
    for (int t = 0; t < rows; ++t) a = fmaf(p[t], to_f32(vd[t * hd + d]), a);
    s.acc[e] = a;
  }
  __syncthreads();
}

// out[b, g*Kh + kvh, :] = acc / l (zeros when no row was folded in).
template <int THREADS, typename T>
__device__ __forceinline__ void decode_finish(const DecodeState& s, T* __restrict__ out, int b,
                                              int H, int Kh, int kvh) {
  for (int e = threadIdx.x; e < s.G * s.hd; e += THREADS) {
    const int g = e / s.hd, d = e % s.hd;
    out[((size_t)b * H + g * Kh + kvh) * s.hd + d] =
        from_f32<T>(s.acc[e] / fmaxf(s.l[g], 1e-30f));
  }
}

namespace {

constexpr int THREADS = 128;
constexpr size_t RING_BYTES = 64 * 1024;
constexpr int MAX_CHUNK = 64;

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
  float* st_base = reinterpret_cast<float*>(kv_s + (size_t)stages * 2 * ps * hd);
  const DecodeState st = decode_state(st_base, G, hd, ps);
  int* has_remote = reinterpret_cast<int*>(st_base + decode_state_floats(G, hd, ps));  // [B]
  __shared__ int slot_sh;

  const int tid = threadIdx.x;
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

  decode_init<THREADS>(st, q, b, H, Kh, kvh, scale);

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
  __syncthreads();   // the softmax state is initialised

  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % stages;
    cp_async_wait(stages - 1);
    __syncthreads();
    const T* kd = kv_s + (size_t)slot * 2 * ps * hd;
    const int rows = n - c * ps < ps ? n - c * ps : ps;   // the page's rows below lens[b]
    decode_update<THREADS>(st, kd, kd + ps * hd, rows);            // ends with a barrier
    if (c + stages < n_chunks) load_page(c + stages, slot);
    cp_async_commit();
  }
  decode_finish<THREADS>(st, out, b, H, Kh, kvh);
}

template <typename T, bool VEC>
int launch_attn(const void* q, const void* kl, const void* vl, const void* kr,
                const void* vr, const int* table, const int* tier, const int* lens,
                void* out, int B, int H, int Kh, int hd, int ps, int MP, int Pl, int Pr,
                float scale, int stages, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem = (size_t)stages * 2 * ps * hd * sizeof(T) +
                      decode_state_floats(G, hd, ps) * sizeof(float) + (size_t)B * sizeof(int);
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) splitk_attn_kernel(
    const T* __restrict__ q,     // [B, H, hd], B = B_loc + B_rem, local requests first
    const T* __restrict__ kl,    // [B_loc, S, Kh, hd] device
    const T* __restrict__ vl,
    const T* __restrict__ kr,    // [B_rem, S, Kh, hd] mapped host
    const T* __restrict__ vr,
    T* __restrict__ out,         // [B, H, hd]
    int B_loc, int B_rem, int S, int H, int Kh, int hd, int kv_len, int ch, float scale,
    int stages) {
  const int G = H / Kh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);               // [stages][2][ch*hd]
  const DecodeState st = decode_state(
      reinterpret_cast<float*>(kv_s + (size_t)stages * 2 * ch * hd), G, hd, ch);

  const int tid = threadIdx.x;
  const int rank = blockIdx.x / Kh, kvh = blockIdx.x % Kh;
  // host-first batch order: requests [B_loc, B) first, then [0, B_loc)
  const bool rem = rank < B_rem;
  const int b = rem ? B_loc + rank : rank - B_rem;
  const size_t row_stride = (size_t)Kh * hd;   // between positions of a request
  const size_t req_stride = (size_t)S * row_stride;
  const T* kbase = (rem ? kr + (size_t)(b - B_loc) * req_stride : kl + (size_t)b * req_stride) +
                   (size_t)kvh * hd;
  const T* vbase = (rem ? vr + (size_t)(b - B_loc) * req_stride : vl + (size_t)b * req_stride) +
                   (size_t)kvh * hd;
  const int n_chunks = (kv_len + ch - 1) / ch;

  decode_init<THREADS>(st, q, b, H, Kh, kvh, scale);

  auto load_chunk = [&](int c, int slot) {
    const int t0 = c * ch;
    const int rows = kv_len - t0 < ch ? kv_len - t0 : ch;   // never past kv_len
    const T* kp = kbase + (size_t)t0 * row_stride;
    const T* vp = vbase + (size_t)t0 * row_stride;
    T* kd = kv_s + (size_t)slot * 2 * ch * hd;
    T* vd = kd + ch * hd;
    if constexpr (VEC) {
      constexpr int EPC = 16 / sizeof(T);
      const int per_row = hd / EPC;
      for (int i = tid; i < rows * per_row; i += THREADS) {
        const int t = i / per_row, d = (i % per_row) * EPC;
        cp_async_16(kd + t * hd + d, kp + t * row_stride + d, 16);
        cp_async_16(vd + t * hd + d, vp + t * row_stride + d, 16);
      }
    } else {
      for (int e = tid; e < rows * hd; e += THREADS) {
        const int t = e / hd, d = e % hd;
        kd[e] = kp[t * row_stride + d];
        vd[e] = vp[t * row_stride + d];
      }
    }
  };

  for (int s = 0; s < stages; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  __syncthreads();   // the softmax state is initialised

  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % stages;
    cp_async_wait(stages - 1);
    __syncthreads();
    const T* kd = kv_s + (size_t)slot * 2 * ch * hd;
    const int rows = kv_len - c * ch < ch ? kv_len - c * ch : ch;
    decode_update<THREADS>(st, kd, kd + ch * hd, rows);             // ends with a barrier
    if (c + stages < n_chunks) load_chunk(c + stages, slot);
    cp_async_commit();
  }
  decode_finish<THREADS>(st, out, b, H, Kh, kvh);
}

template <typename T, bool VEC>
int launch_splitk(const void* q, const void* kl, const void* vl, const void* kr, const void* vr,
                  void* out, int B_loc, int B_rem, int S, int H, int Kh, int hd, int kv_len,
                  int window, cudaStream_t stream) {
  const int G = H / Kh;
  int stages = window < DAK_MAX_WINDOW ? window : DAK_MAX_WINDOW;
  const size_t row_bytes = (size_t)2 * hd * sizeof(T);   // one position's K and V, one kv head
  int ch = MAX_CHUNK;
  while (ch > 1 && (size_t)stages * ch * row_bytes > RING_BYTES) ch /= 2;
  const int n_chunks = (kv_len + ch - 1) / ch;
  if (stages > n_chunks) stages = n_chunks;
  const size_t smem = (size_t)stages * ch * row_bytes + decode_state_floats(G, hd, ch) * sizeof(float);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  auto kern = splitk_attn_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<(B_loc + B_rem) * Kh, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kl), static_cast<const T*>(vl),
      static_cast<const T*>(kr), static_cast<const T*>(vr), static_cast<T*>(out), B_loc, B_rem, S,
      H, Kh, hd, kv_len, ch, scale, stages);
  return cudaGetLastError();
}

template <typename T>
int dispatch_splitk(const void* q, const void* kl, const void* vl, const void* kr, const void* vr,
                    void* out, int B_loc, int B_rem, int S, int H, int Kh, int hd, int kv_len,
                    int window, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  // an empty tier's pointers are never read
  const bool vec = hd % EPC == 0 && (B_loc == 0 || (al(kl) && al(vl))) &&
                   (B_rem == 0 || (al(kr) && al(vr)));
  return vec ? launch_splitk<T, true>(q, kl, vl, kr, vr, out, B_loc, B_rem, S, H, Kh, hd, kv_len,
                                      window, stream)
             : launch_splitk<T, false>(q, kl, vl, kr, vr, out, B_loc, B_rem, S, H, Kh, hd, kv_len,
                                       window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The remote pools must be mapped host
// memory.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_paged_attention_cpasync(const void* q, const void* k_local,
                                           const void* v_local, const void* k_remote,
                                           const void* v_remote, const int* table,
                                           const int* tier, const int* lens, void* out, int B,
                                           int H, int Kh, int hd, int ps, int MP, int P_local,
                                           int P_remote, float scale, int window, int dtype,
                                           void* stream) {
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

// dtype: 0 = float32, 1 = bfloat16.  With B_rem > 0 the remote caches must be
// mapped host memory.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_attention_cpasync(const void* q, const void* k_local,
                                            const void* v_local, const void* k_remote,
                                            const void* v_remote, void* out, int B_loc,
                                            int B_rem, int S, int H, int Kh, int hd, int kv_len,
                                            int window, int dtype, void* stream) {
  if (B_loc < 0 || B_rem < 0 || B_loc + B_rem <= 0 || Kh <= 0 || H % Kh || hd <= 0 ||
      kv_len < 1 || kv_len > S || window < 1 || (dtype != 0 && dtype != 1))
    return DAK_ERR_BAD_ARGUMENT;
  const void* kr = nullptr;
  const void* vr = nullptr;
  if (B_rem > 0) {
    int e = dak_mapped_host_ptr(k_remote, &kr);
    if (e) return e;
    e = dak_mapped_host_ptr(v_remote, &vr);
    if (e) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_splitk<float>(q, k_local, v_local, kr, vr, out, B_loc, B_rem, S, H, Kh,
                                      hd, kv_len, window, s)
             : dispatch_splitk<__nv_bfloat16>(q, k_local, v_local, kr, vr, out, B_loc, B_rem, S,
                                              H, Kh, hd, kv_len, window, s);
}
