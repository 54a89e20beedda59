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
// Bound on this card: bytes.  Each cached K/V element is read once and
// used for G = H/Kh query heads (G = 1 for llama2-7b), about one
// multiply-add per byte.  The remote requests' rows cross the PCIe host
// link, and their bytes over the link rate are the floor; the local rows
// stream from HBM at 3.35 TB/s and finish long before.
//
// What the design does about it:
//  * One CTA per (request, kv head).  CTAs are numbered in host-first batch
//    order (`host_first_batch_order` in the reference): blockIdx.x / Kh <
//    B_rem are the remote requests, so the hardware issues the long-latency
//    host reads first and the local requests fill the SMs behind them.
//  * Direct access: a remote request's rows go straight from the mapped host
//    pointer into shared memory (cp.async, 16 B per thread), never staged in
//    HBM.  For one kv head consecutive positions are Kh*hd elements apart
//    (8 KB for llama2-7b in bf16), so each row is one hd-wide segment.
//  * `window` chunks of K and V rows are in flight per CTA in a shared-memory
//    ring.  Chunk size: the reference's `block_s = 256` rows of all kv heads
//    do not fit (2 MB for K alone at llama2-7b width), and even one kv head's
//    256 K+V rows are 128 KB in bf16, so a 2-deep ring would exceed the 227 KB
//    a block may use.  So the chunk is sized from the ring depth and hd alone
//    (the wrapper takes no `block_s`): one kv head's rows, as many as keep the
//    whole ring within 64 KB (RING_BYTES), at most 64: 64 rows (32 KB of K+V)
//    at hd 128 in bf16 with window <= 2, 32 rows at window 4.  64 KB leaves
//    room for two or three CTAs on an SM.  The ragged last chunk is masked.
//  * fp32 online softmax over the group-major query heads h = g*Kh + kvh
//    (decode_attn.cuh, shared with paged_flashattn.cu), scale hd**-0.5.
// Plain FMA: at one multiply-add per byte the math is not the limit.
#include <cmath>

#include "decode_attn.cuh"

namespace {

constexpr int THREADS = 128;
constexpr size_t RING_BYTES = 64 * 1024;
constexpr int MAX_CHUNK = 64;

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

// dtype: 0 = float32, 1 = bfloat16.  With B_rem > 0 the remote caches must be
// mapped host memory.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_splitk_attention(const void* q, const void* k_local, const void* v_local,
                                    const void* k_remote, const void* v_remote, void* out,
                                    int B_loc, int B_rem, int S, int H, int Kh, int hd, int kv_len,
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
