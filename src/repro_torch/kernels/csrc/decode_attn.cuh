// Decode-attention device code shared by the two tiered decode kernels
// (paged_flashattn.cu, splitk_flashattn.cu).
//
// A CTA of THREADS = 128 threads attends one whole sequence (a slot's pages
// or a request's chunks) for one kv head `kvh` and up to HPW of its
// G = H/Kh group-major query heads h = g*Kh + kvh.  Its K/V chunks arrive in
// a ring of shared-memory stages, each completing on an mbarrier (one TMA
// issue per stage, or element stores by every thread followed by an
// arrival, for operands a tensor map cannot describe); `decode_walk` walks
// the ring with one block barrier per chunk.
//
// The online softmax is warp-level and lives in registers: the chunk's rows
// are dealt round robin to the 4 warps, and each warp keeps, for each of its
// heads, the pre-scaled query slice and the fp32 accumulator with lane l
// holding dims l, l+32, ... (DPL per lane), plus its running max and sum.
// A row's score is one FMA per dim and a butterfly of warp shuffles, which
// leaves the same sum in every lane, so the max test is warp-uniform.  When
// the sequence ends, `decode_write` combines the warps' states in warp
// order through shared memory and writes the output, so the result does not
// depend on scheduling.
#pragma once

#include "tma.cuh"

#define DAK_NEG_INF (-1e30f)   // the reference's mask value, finite

namespace decode {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr size_t RING_MAX = 96 * 1024;   // leaves room for two CTAs on an SM

// Query heads a CTA takes at DPL dims per lane: as many as keep q and acc
// within 64 registers a lane, and one at DPL 16 and 32 (hd above 256).
__host__ __device__ constexpr int max_heads(int dpl) { return dpl > 8 ? 1 : dpl == 8 ? 4 : 8; }

// Bytes of one ring stage: a K box then a V box of `rows` x hd, each
// rounded up to the 128-byte alignment a TMA destination takes.
__host__ __device__ inline uint32_t box_bytes(int rows, int hd, int elem) {
  return (uint32_t)(((size_t)rows * hd * elem + 127) / 128 * 128);
}

// Floats of the warps' merge scratch: acc [WARPS][HPW][32 DPL], m and l
// [WARPS][HPW]; it reuses the ring once the last chunk is consumed.
__host__ __device__ inline size_t merge_bytes(int dpl, int hpw) {
  return (size_t)WARPS * hpw * (32 * dpl + 2) * sizeof(float);
}

// Ring stages: `window` loads in flight while one chunk is computed, within
// RING_MAX and no more than the sequence's chunks (at least one).
inline int ring_stages(int window, uint32_t stage_bytes, int chunks) {
  int stages = (window < DAK_MAX_WINDOW ? window : DAK_MAX_WINDOW) + 1;
  const int fit = (int)(RING_MAX / stage_bytes);
  if (stages > fit) stages = fit;
  if (stages > chunks) stages = chunks;
  return stages < 1 ? 1 : stages;
}

// Dynamic shared memory of a launch: the ring (or the merge scratch that
// reuses it, if larger), one mbarrier a stage, and `extra` bytes after them.
inline size_t launch_smem(int stages, uint32_t box, int dpl, int hpw, size_t extra) {
  size_t ring = (size_t)stages * 2 * box;
  if (ring < merge_bytes(dpl, hpw)) ring = merge_bytes(dpl, hpw);
  return ring + (size_t)stages * sizeof(uint64_t) + extra;
}

// The dims per lane (DPL) and query heads per CTA (HPW): the dispatchers
// pick their template arguments here, and so do the shared-memory queries.
inline int dims_per_lane(int hd) {
  return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : hd <= 256 ? 8 : hd <= 512 ? 16 : 32;
}
inline int heads_per_cta(int dpl, int H, int Kh) {
  return dpl > 8 || H == Kh ? 1 : max_heads(dpl);
}

// The online-softmax state of one warp.
template <int DPL, int HPW>
struct WarpState {
  float q[HPW][DPL];     // query * scale, dims lane + 32 i
  float acc[HPW][DPL];
  float m[HPW];          // running max (uniform across the warp)
  float l[HPW];          // running sum (uniform across the warp)
};

// Load the heads g0 .. g0+ng-1 of request b, kv head kvh, times `scale`.
template <int DPL, int HPW, typename T>
__device__ __forceinline__ void warp_init(WarpState<DPL, HPW>& s, const T* __restrict__ q,
                                          int b, int H, int Kh, int kvh, int g0, int ng, int hd,
                                          float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const T* qh = q + ((size_t)b * H + (size_t)(g0 + h) * Kh + kvh) * hd;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = i * 32 + lane;
      s.q[h][i] = (h < ng && d < hd) ? to_f32(qh[d]) * scale : 0.f;
      s.acc[h][i] = 0.f;
    }
    s.m[h] = DAK_NEG_INF;
    s.l[h] = 0.f;
  }
}

// Fold one K/V row (hd elements each, shared memory) into the warp's state.
template <int DPL, int HPW, typename T>
__device__ __forceinline__ void warp_fold_row(WarpState<DPL, HPW>& s, const T* k, const T* v,
                                              int hd, int ng) {
  const int lane = threadIdx.x % 32;
  float kr[DPL], vr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = i * 32 + lane;
    kr[i] = d < hd ? to_f32(k[d]) : 0.f;
    vr[i] = d < hd ? to_f32(v[d]) : 0.f;
  }
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    if (h >= ng) break;
    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) sc = fmaf(s.q[h][i], kr[i], sc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
    if (sc > s.m[h]) {                 // the same in every lane
      const float corr = expf(s.m[h] - sc);
      s.l[h] *= corr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s.acc[h][i] *= corr;
      s.m[h] = sc;
    }
    const float p = expf(sc - s.m[h]);
    s.l[h] += p;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s.acc[h][i] = fmaf(p, vr[i], s.acc[h][i]);
  }
}

// Walk the sequence's `n_ld` chunks through the ring: issue(i) starts chunk i
// into stage i % stages (completing on full[i % stages]), rows(i) is its
// valid row count; rows are dealt round robin to the warps.  One block
// barrier per chunk, after which the stage is refilled.
template <int DPL, int HPW, typename T, typename Issue, typename Rows>
__device__ __forceinline__ void decode_walk(WarpState<DPL, HPW>& s, const unsigned char* ring,
                                            uint64_t* full, int stages, uint32_t box, int n_ld,
                                            int hd, int ng, Issue issue, Rows rows) {
  const int warp = threadIdx.x / 32;
  for (int i = 0; i < stages && i < n_ld; ++i) issue(i);
  for (int c = 0; c < n_ld; ++c) {
    const int st = c % stages;
    mbar_wait(&full[st], (uint32_t)(c / stages) & 1);
    const T* kd = reinterpret_cast<const T*>(ring + (size_t)st * 2 * box);
    const T* vd = reinterpret_cast<const T*>(ring + (size_t)st * 2 * box + box);
    const int n = rows(c);
    for (int r = warp; r < n; r += WARPS) warp_fold_row(s, kd + r * hd, vd + r * hd, hd, ng);
    __syncthreads();                   // every warp is done with the stage
    if (c + stages < n_ld) issue(c + stages);
  }
}

// Combine the warps' states and write heads g0 .. g0+ng-1 of request b, kv
// head kvh, to `out` [B, H, hd]: zeros where no chunk was folded
// (`folded` false; the ring is otherwise free for the merge scratch).
template <int DPL, int HPW, typename T>
__device__ __forceinline__ void decode_write(const WarpState<DPL, HPW>& s, bool folded,
                                             unsigned char* scratch, T* __restrict__ out, int b,
                                             int H, int Kh, int kvh, int g0, int ng, int hd) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = ng * hd;
  auto out_at = [&](int h, int d) {
    return ((size_t)b * H + (size_t)(g0 + h) * Kh + kvh) * hd + d;
  };
  if (!folded) {                       // nothing to attend: zeros
    for (int e = tid; e < n; e += THREADS) out[out_at(e / hd, e % hd)] = from_f32<T>(0.f);
    return;
  }
  float* acc_s = reinterpret_cast<float*>(scratch);            // [WARPS][HPW][32 DPL]
  float* m_s = acc_s + WARPS * HPW * 32 * DPL;                // [WARPS][HPW]
  float* l_s = m_s + WARPS * HPW;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[(warp * HPW + h) * 32 * DPL + i * 32 + lane] = s.acc[h][i];
    if (lane == 0) {
      m_s[warp * HPW + h] = s.m[h];
      l_s[warp * HPW + h] = s.l[h];
    }
  }
  __syncthreads();
  for (int e = tid; e < n; e += THREADS) {
    const int h = e / hd, d = e % hd;
    float mx = DAK_NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w * HPW + h]);
    float a = 0.f, l = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_s[w * HPW + h] - mx);
      a = fmaf(acc_s[(w * HPW + h) * 32 * DPL + d], f, a);
      l = fmaf(l_s[w * HPW + h], f, l);
    }
    out[out_at(h, d)] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

}  // namespace decode
