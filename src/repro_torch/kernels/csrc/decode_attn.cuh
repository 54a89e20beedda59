// Decode-attention device code shared by the two tiered decode kernels
// (paged_flashattn.cu, splitk_flashattn.cu): one CTA attends one request's
// G = H/Kh group-major query heads h = g*Kh + kvh against one kv head, and
// keeps an fp32 online-softmax state in shared memory.  Each kernel brings
// its own K/V rows into shared memory chunk by chunk and folds every chunk
// into the state with `decode_update`.
#pragma once

#include "dak_common.cuh"

#define DAK_NEG_INF (-1e30f)   // the reference's mask value, finite

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
    s.m[g] = DAK_NEG_INF;
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
