// Causal (or full) flash attention for prefill on Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py `_kernel` (line 30;
// pallas_call at :107, wrapper `flash_prefill` :90).  As in the reference it
// is off the serving path (prefill attends through `layers.attend`); its
// callers are the kernel benchmarks and tests.
//
// q [B, H, Tq, hd], k/v [B, Kh, Tk, hd] -> out [B, H, Tq, hd].  Group-major
// GQA: query head h reads kv head h % Kh (not h // G).  Causal masks key
// positions above the query position (both counted from 0), with the
// reference's finite mask value -1e30.
//
// Bound on this card: operations for any prompt longer than a few dozen
// tokens.  Causal attention does 2 * hd multiply-adds per (query, key) pair
// with key <= query on q/k/v bytes that are each read once, so at T = 2048
// it needs ~1000 FLOP per byte, far above the ~295 at which the H100's bf16
// tensor cores (989 TFLOP/s) rather than HBM become the limit.  So the
// products must run on the tensor cores, and the loads must hide behind
// them.  Two paths, chosen by dtype:
//
// bfloat16: tensor cores (FlashAttention-2's layout on mma.sync).
//  * One CTA of 8 warps per (head, batch, q tile of 128 rows); each warp
//    owns 16 query rows.  The grid runs the q tiles last to first across
//    all heads and batches (blockIdx.z is the slowest axis), so the causal
//    tiles with the most keys start first and the short ones fill in
//    behind them.
//  * Q (128 rows) and a 2-stage ring of K/V tiles (64 keys each) stay bf16
//    in shared memory, rows padded by 16 bytes so that the 8 row addresses
//    of every ldmatrix fall in distinct banks.  K/V tile j+1 arrives by
//    cp.async while tile j is computed, with one CTA barrier per tile.
//  * S = Q K^T and O += P V run through mma.sync m16n8k16 (bf16 in, fp32
//    accumulate), fragments fed by ldmatrix (V by ldmatrix.trans).  Q's
//    fragments are loaded once into registers (hd <= 128).
//  * Online softmax on the fp32 accumulator fragments in registers: row max
//    and sum by quad shuffles, exp2f with the softmax scale folded into
//    log2(e).  P is rounded to bf16 in registers and is the A operand of
//    P V; no score tile goes through shared memory.
//  * Causal: key tiles above the CTA's last query row are never loaded;
//    a warp skips a key tile that lies wholly above its 16 rows, and only
//    tiles that cross the diagonal (or the ragged Tk edge) are masked.
//  * What bounds it then: with 16 query rows per warp each K or V fragment
//    feeds two products, so every warp reads 32 KB of shared memory per
//    K/V tile by ldmatrix, as many cycles of shared-memory bandwidth as the
//    tile's products take on the tensor cores.  Two m-tiles per warp, or
//    wgmma reading B once per warpgroup, is the next step.
//  * Ragged Tq, Tk and any hd <= 256 are taken: rows and columns past the
//    edge are zero-filled in shared memory (hd is padded to 32, 64, 128 or
//    256).  Rows whose length is not a multiple of 16 bytes, or pointers
//    that are not 16-byte aligned, load with plain loads instead of
//    cp.async.
//
// float32: plain FMA (the reference's fp32 bound, 2e-4, rules out TF32).
//  * One CTA (256 threads) per (q tile of 64 rows, head, batch), q tiles
//    last to first; fp32 tiles in shared memory, rows padded by one float;
//    each thread owns 4 x 4 scores and 4 output rows at 16-column stride;
//    one warp per query row for the online softmax.
// `dak_flash_prefill_fma` exposes the fp32 path's kernel for bf16 inputs
// too; nothing in the port calls it (the chip smoke test times it beside the
// tensor-core path).
#include <cmath>

#include "dak_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;     // the reference's mask value, finite

// ---------------------------------------------------------------------------
// The FMA path (float32).
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;              // rows of a q tile and of a k tile
static_assert(TILE * TILE == 16 * THREADS, "each thread owns 4 x 4 scores of a tile");

// DJ: output columns per thread (hd <= 16 * DJ).
template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int Kh, int Tq, int Tk, int hd, int causal, float scale) {
  constexpr int bq = TILE, bk = TILE;
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 1;                     // padded row stride of q/k/v tiles
  const int lp = bk + 1;                     // padded row stride of the score tile
  float* q_s = smem;                         // [bq][ld]
  float* k_s = q_s + bq * ld;                // [bk][ld]
  float* v_s = k_s + bk * ld;                // [bk][ld]
  float* p_s = v_s + bk * ld;                // [bq][lp]
  float* m_s = p_s + bq * lp;                // [bq]
  float* l_s = m_s + bq;
  float* c_s = l_s + bq;

  const int n_qt = (Tq + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h % Kh;
  const int qrows = Tq - q0 < bq ? Tq - q0 : bq;
  const T* qg = q + (((size_t)b * H + h) * Tq + q0) * hd;
  const T* kg = k + ((size_t)b * Kh + kvh) * Tk * hd;
  const T* vg = v + ((size_t)b * Kh + kvh) * Tk * hd;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;    // rows ty + 16 i, columns tx + 16 j

  for (int e = tid; e < bq * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    q_s[r * ld + d] = r < qrows ? to_f32(qg[(size_t)r * hd + d]) * scale : 0.f;
  }
  for (int r = tid; r < bq; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  // keys up to the tile's last query row (causal) or all of them
  const int k_end = causal ? (q0 + qrows < Tk ? q0 + qrows : Tk) : Tk;
  const int n_kt = (k_end + bk - 1) / bk;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * bk;
    const int krows = Tk - k0 < bk ? Tk - k0 : bk;
    __syncthreads();   // the previous tile's k/v/p are consumed
    for (int e = tid; e < bk * hd; e += THREADS) {
      const int r = e / hd, d = e % hd;
      const bool ok = r < krows;
      k_s[r * ld + d] = ok ? to_f32(kg[(size_t)(k0 + r) * hd + d]) : 0.f;
      v_s[r * ld + d] = ok ? to_f32(vg[(size_t)(k0 + r) * hd + d]) : 0.f;
    }
    __syncthreads();
    // scores: 4 x 4 per thread
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = c < krows && (!causal || k0 + c <= q0 + r);
        p_s[r * lp + c] = ok ? sacc[i][j] : NEG_INF;
      }
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int r = warp; r < bq; r += WARPS) {
      float* row = p_s + r * lp;
      float mx = NEG_INF;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // o = o * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= corr;
    }
    for (int c = 0; c < krows; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < hd ? v_s[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * lp + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qrows) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* og = out + (((size_t)b * H + h) * Tq + q0 + r) * hd;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) og[d] = from_f32<T>(o[i][j] * inv);
    }
  }
}

// Dynamic shared memory of an FMA-path launch: q, k and v tiles of fp32
// rows padded by one float, the score tile and three row vectors.
inline size_t fma_smem(int hd) {
  return ((size_t)3 * TILE * (hd + 1) + (size_t)TILE * (TILE + 1) + 3 * TILE) * sizeof(float);
}

template <typename T, int DJ>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                   int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  const size_t smem = fma_smem(hd);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  auto kern = flash_prefill_kernel<T, DJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + TILE - 1) / TILE, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Kh, Tq, Tk, hd, causal, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
int dispatch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                     int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  if (hd <= 32) return launch_prefill<T, 2>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 64) return launch_prefill<T, 4>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 128) return launch_prefill<T, 8>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  return launch_prefill<T, 16>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core path (bfloat16).
// ---------------------------------------------------------------------------
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows of a CTA, 16 per warp
constexpr int TC_BK = 64;             // keys of a K/V tile
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] (row) * b[16x8] (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD: hd padded to a multiple of 16 (32, 64, 128 or 256).  VEC: hd % 8 == 0
// and 16-byte aligned operands, so tiles load by cp.async.
template <int HD, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_prefill_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int H, int Kh, int Tq, int Tk, int hd, int causal,
    float scale_log2) {
  constexpr int LD = HD + 8;          // padded row: 8 rows' 16 B pieces hit 8 distinct banks
  constexpr int KV_TILE = TC_BK * LD;
  constexpr bool Q_IN_REGS = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [TC_BQ][LD]
  bf16* kv_s = q_s + TC_BQ * LD;                    // [2 stages][K, V][TC_BK][LD]

  const int h = blockIdx.x, b = blockIdx.y, kvh = h % Kh;
  const int n_qt = (Tq + TC_BQ - 1) / TC_BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * TC_BQ;
  const int qrows = Tq - q0 < TC_BQ ? Tq - q0 : TC_BQ;
  const bf16* qg = q + (((size_t)b * H + h) * Tq + q0) * hd;
  const bf16* kg = k + ((size_t)b * Kh + kvh) * Tk * hd;
  const bf16* vg = v + ((size_t)b * Kh + kvh) * Tk * hd;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;   // fragment row (and row + 8), column pair 2 * t4

  // rows [0, R) of `src` ([*, hd] row-major) into dst [R][LD]; rows from
  // `valid` on and columns from hd on are zeros
  auto load_tile = [&](bf16* dst, const bf16* src, int valid, int R) {
    constexpr int CPR = HD / 8;          // 16-byte pieces per row
    for (int c = tid; c < R * CPR; c += TC_THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      bf16* d = dst + r * LD + col;
      if constexpr (VEC) {
        const bool ok = r < valid && col < hd;
        cp_async_16(d, ok ? src + (size_t)r * hd + col : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = r < valid && col + e < hd ? src[(size_t)r * hd + col + e] : __float2bfloat16(0.f);
      }
    }
  };
  auto load_kv = [&](int j) {
    const int k0 = j * TC_BK;
    bf16* ks = kv_s + (j & 1) * 2 * KV_TILE;
    load_tile(ks, kg + (size_t)k0 * hd, Tk - k0, TC_BK);
    load_tile(ks + KV_TILE, vg + (size_t)k0 * hd, Tk - k0, TC_BK);
  };

  // keys up to the tile's last query row (causal) or all of them
  const int k_end = causal ? (q0 + qrows < Tk ? q0 + qrows : Tk) : Tk;
  const int n_kt = (k_end + TC_BK - 1) / TC_BK;
  load_tile(q_s, qg, qrows, TC_BQ);
  load_kv(0);
  cp_async_commit();

  const int wr0 = q0 + warp * 16;          // the warp's first query row
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};       // running max (log2 units), rows g and g + 8
  float l_r[2] = {0.f, 0.f};               // this thread's part of the running sum
  uint32_t qf[Q_IN_REGS ? HD / 16 : 1][4];
  const bf16* q_row = q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait(0);                      // tile j (and Q) have landed
    __syncthreads();                       // ... for every thread, and tile j - 1 is consumed
    if (j + 1 < n_kt) load_kv(j + 1);      // into the stage tile j - 1 left; lands during j
    cp_async_commit();
    if constexpr (Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], q_row + kk * 16);
      }
    }
    const int k0 = j * TC_BK;
    // skip a tile wholly above the warp's rows, and warps past Tq
    if (wr0 < Tq && (!causal || k0 <= wr0 + 15)) {
      const bf16* ks = kv_s + (j & 1) * 2 * KV_TILE;
      const bf16* vs = ks + KV_TILE;
      float s[TC_BK / 8][4];
#pragma unroll
      for (int n = 0; n < TC_BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        if constexpr (Q_IN_REGS) {
          a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
        } else {
          ldmatrix_x4(a, q_row + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < TC_BK / 16; ++np) {
          uint32_t bb[4];   // keys np*16 + [0, 8) and [8, 16), hd kk*16 + [0, 16)
          ldmatrix_x4(bb, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // scale into log2 units; mask only tiles that cross the diagonal or Tk
      const bool masked = k0 + TC_BK > Tk || (causal && k0 + TC_BK - 1 > wr0);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < TC_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (masked) {
            const int col = k0 + n * 8 + 2 * t4 + (e & 1);
            const int row = wr0 + g + (e >= 2 ? 8 : 0);
            if (col >= Tk || (causal && col > row)) x = NEG_INF;
          }
          s[n][e] = x;
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
      for (int n = 0; n < TC_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
          rs[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V, P from the score fragments (bf16), V by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bb[4];   // keys kk*16 + [0, 16), hd np*16 + [0, 8) and [8, 16)
          ldmatrix_x4_trans(bb, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                    np * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * np], a, bb[0], bb[1]);
          mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= Tq) continue;
    bf16* og = out + (((size_t)b * H + h) * Tq + row) * hd;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      const float x0 = o[n][2 * i] * inv[i], x1 = o[n][2 * i + 1] * inv[i];
      if constexpr (VEC) {
        if (col < hd) *reinterpret_cast<__nv_bfloat162*>(og + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) og[col] = __float2bfloat16(x0);
        if (col + 1 < hd) og[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Dynamic shared memory of a tensor-core launch at padded head dim HD: Q
// and two stages of K and V tiles, bf16 rows padded by 16 bytes.
__host__ __device__ constexpr size_t tc_smem(int HD) {
  return (size_t)(TC_BQ + 4 * TC_BK) * (HD + 8) * sizeof(bf16);
}

template <int HD, bool VEC>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
              int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  constexpr size_t smem = tc_smem(HD);
  static_assert(smem <= 227 * 1024, "Q and two K/V stages must fit in shared memory");
  auto kern = flash_prefill_tc_kernel<HD, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Tq + TC_BQ - 1) / TC_BQ);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, Kh, Tq, Tk, hd, causal,
      1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <int HD>
int dispatch_tc_vec(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                    int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  const bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  return vec ? launch_tc<HD, true>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream)
             : launch_tc<HD, false>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  if ((Tq + TC_BQ - 1) / TC_BQ > 65535) return DAK_ERR_BAD_ARGUMENT;
  if (hd <= 32) return dispatch_tc_vec<32>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 64) return dispatch_tc_vec<64>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 128) return dispatch_tc_vec<128>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  return dispatch_tc_vec<256>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
}

}  // namespace

static inline bool prefill_args_ok(int B, int H, int Kh, int Tq, int Tk, int hd, int dtype) {
  return B > 0 && H > 0 && Kh > 0 && H % Kh == 0 && Tq > 0 && Tk > 0 && hd > 0 && hd <= 256 &&
         (dtype == 0 || dtype == 1) && H <= 65535 && B <= 65535;
}

// dtype: 0 = float32 (the FMA path), 1 = bfloat16 (the tensor-core path);
// hd <= 256.  Returns 0, a cudaError_t, or a DAK_ERR_* code.
extern "C" int dak_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int Kh, int Tq, int Tk, int hd, int causal, int dtype,
                                 void* stream) {
  if (!prefill_args_ok(B, H, Kh, Tq, Tk, hd, dtype)) return DAK_ERR_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_prefill<float>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s)
                    : dispatch_tc(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
}

// The FMA path's kernel for either dtype (for timing it beside the tensor
// cores in bf16).  Same arguments and codes as dak_flash_prefill.
extern "C" int dak_flash_prefill_fma(const void* q, const void* k, const void* v, void* out,
                                     int B, int H, int Kh, int Tq, int Tk, int hd, int causal,
                                     int dtype, void* stream) {
  if (!prefill_args_ok(B, H, Kh, Tq, Tk, hd, dtype)) return DAK_ERR_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_prefill<float>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s)
             : dispatch_prefill<__nv_bfloat16>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
}

// The dynamic shared memory a dak_flash_prefill launch at head dim `hd`
// would hold (its tiles are fixed at compile time).  Launches nothing; the
// wrapper's shared-memory footprint is checked against it.  Returns 0 or
// DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_flash_prefill_smem(int hd, int dtype, long long* bytes) {
  if (hd <= 0 || hd > 256 || (dtype != 0 && dtype != 1) || bytes == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  const int padded = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  *bytes = (long long)(dtype == 0 ? fma_smem(hd) : tc_smem(padded));
  return 0;
}
