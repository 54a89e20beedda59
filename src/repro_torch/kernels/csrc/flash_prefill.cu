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
// them.  Three designs; the wrapper picks one by dtype, head dim and
// alignment (`flash_prefill.design`) and passes it in, and the entry point
// refuses a design the operands do not fit:
//
// wgmma (bfloat16, hd 64 or 128, 16-byte-aligned operands): Hopper's own
// tensor-core path, warp-specialised.
//  * One CTA of three warpgroups (384 threads) per (q tile of 128 rows,
//    head, batch).  Warpgroup 0 is the producer: one thread issues every
//    TMA load, and the warpgroup gives registers up (setmaxnreg.dec to
//    40).  Warpgroups 1 and 2 are consumers of 64 query rows each and take
//    them (setmaxnreg.inc to 232; ptxas reports 168 a thread, the count
//    the CTA starts with, and no spills).
//  * A 1-D grid in groups of WG_GROUP = 8 (batch, head) pairs, each
//    group's q tiles last to first across its heads, so the causal tiles
//    with the most keys start first and the CTAs in flight read the same
//    few heads' K and V: those come from HBM about once and from L2 after.
//    (Heads in the fastest grid axis, as the mma.sync design runs them,
//    put up to 132 different heads in flight, and every K/V tile came from
//    HBM again for each q tile.)
//  * Loads by TMA from 3-D maps {hd, T, B * heads} in boxes of 64 columns
//    (a 128-byte row, 128-byte swizzle; an hd-128 row is two boxes), so
//    rows past T inside a head arrive as zeros and are never read from the
//    next head.  Q once, on its own mbarrier; K and V tiles of 128 keys
//    through a ring of 2 stages, K and V each with a full mbarrier (the
//    bytes) and an empty one (an arrival from each of the 8 consumer
//    warps), so a K slot frees as soon as its QK^T is done.  At hd 128
//    that is 160 KB of the 227.
//  * S = Q K^T: wgmma m64n128k16, bf16 in and fp32 accumulate, Q and K
//    both read from shared memory by descriptor (K-major: both contiguous
//    along hd; a k16 step moves the start 32 bytes inside the swizzled
//    row).  O += P V: wgmma m64n{hd}k16 with P as the A operand from
//    registers (the S accumulator rounded to bf16: its fragment layout is
//    the A layout) and V from shared memory with the transpose bit, since
//    V's contraction runs along its rows.
//  * Both of FA3's schedules.  Within a consumer, QK^T of tile j is issued
//    with PV of tile j - 1, and the softmax of tile j runs beside what is
//    left of that PV (wgmma.wait_group 1, then 0): S, O and P are in flight
//    at once, 160 registers a thread.  Between consumers, each block of
//    issues waits for the other consumer's last block on two named
//    barriers, so one warpgroup's softmax runs beside the other's products.
//  * Registers: the consumers' region holds up to 232 only if nothing in it
//    can trap; with mbar_wait's __trap in it ptxas held it to the 168 the
//    CTA starts with, and spilled and serialised every wgmma.  The
//    consumers' waits give up instead (mbar_wait_consumer); the producer
//    keeps the trapping wait.
//  * Online softmax on the accumulator in fp32 registers: the row max over
//    the quad that holds a row, taken on raw scores, and one FFMA (scale
//    and max folded into log2 units) and ex2.approx per score; no score
//    tile goes through shared memory.
//  * Causal: key tiles wholly above the q tile's last row are never
//    loaded; only the tile that crosses the diagonal and the ragged Tk edge
//    take the masked softmax (zero-filled keys score 0, so they are masked
//    too).  Rows past Tq are computed on zero-filled Q and not stored.
//
// bfloat16, other head dims or operands a tensor map does not take:
// mma.sync (FlashAttention-2's layout), the design the wgmma one replaced
// at hd 64 and 128.
//  * One CTA of 8 warps per (head, batch, q tile of 128 rows), q tiles last
//    to first; each warp owns 16 query rows.
//  * Q (128 rows) and a 2-stage ring of K/V tiles (64 keys each) stay bf16
//    in shared memory, rows padded by 16 bytes so that the 8 row addresses
//    of every ldmatrix fall in distinct banks.  K/V tile j+1 arrives by
//    cp.async while tile j is computed, with one CTA barrier per tile.
//  * S = Q K^T and O += P V run through mma.sync m16n8k16 (bf16 in, fp32
//    accumulate), fragments fed by ldmatrix (V by ldmatrix.trans).  Q's
//    fragments are loaded once into registers (hd <= 128).  Online softmax
//    as above; P is the A operand of P V from registers.
//  * Causal as above; a warp also skips a key tile that lies wholly above
//    its 16 rows.
//  * What bounds it: with 16 query rows per warp each K or V fragment
//    feeds two products, so every warp reads 32 KB of shared memory per
//    K/V tile by ldmatrix, as many cycles of shared-memory bandwidth as the
//    tile's products take on the tensor cores (wgmma reads each B tile
//    once per warpgroup of 64 rows instead).
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
#include <cmath>

#include "tma.cuh"

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
template <int DJ>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int H, int Kh, int Tq, int Tk, int hd, int causal, float scale) {
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
  const float* qg = q + (((size_t)b * H + h) * Tq + q0) * hd;
  const float* kg = k + ((size_t)b * Kh + kvh) * Tk * hd;
  const float* vg = v + ((size_t)b * Kh + kvh) * Tk * hd;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;    // rows ty + 16 i, columns tx + 16 j

  for (int e = tid; e < bq * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    q_s[r * ld + d] = r < qrows ? qg[(size_t)r * hd + d] * scale : 0.f;
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
      k_s[r * ld + d] = ok ? kg[(size_t)(k0 + r) * hd + d] : 0.f;
      v_s[r * ld + d] = ok ? vg[(size_t)(k0 + r) * hd + d] : 0.f;
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
    float* og = out + (((size_t)b * H + h) * Tq + q0 + r) * hd;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) og[d] = o[i][j] * inv;
    }
  }
}

// Dynamic shared memory of an FMA-path launch: q, k and v tiles of fp32
// rows padded by one float, the score tile and three row vectors.
inline size_t fma_smem(int hd) {
  return ((size_t)3 * TILE * (hd + 1) + (size_t)TILE * (TILE + 1) + 3 * TILE) * sizeof(float);
}

template <int DJ>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                   int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  const size_t smem = fma_smem(hd);
  if (smem > 227 * 1024) return DAK_ERR_BAD_ARGUMENT;
  auto kern = flash_prefill_kernel<DJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + TILE - 1) / TILE, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, Kh, Tq, Tk, hd, causal, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

int dispatch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                     int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  if (hd <= 32) return launch_prefill<2>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 64) return launch_prefill<4>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  if (hd <= 128) return launch_prefill<8>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
  return launch_prefill<16>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core path (bfloat16).
// ---------------------------------------------------------------------------
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows of a CTA, 16 per warp
constexpr int TC_BK = 64;             // keys of a K/V tile
typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------------------
// The wgmma design (bfloat16, hd 64 or 128, 16-byte-aligned operands).
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 384;       // a producer warpgroup and two consumer warpgroups
constexpr int WG_BQ = 128;            // query rows of a CTA, 64 per consumer warpgroup
constexpr int WG_BK = 128;            // keys of a K/V tile
constexpr int WG_STAGES = 2;          // K/V tiles in the ring
constexpr int WG_BOX = 64;            // columns of a TMA box: one 128-byte swizzled row
constexpr int WG_ALIGN = 1024;        // a 128-byte-swizzled box lands 1024-byte aligned
constexpr int WG_CONSUMER_WARPS = 8;  // arrivals that empty a stage
constexpr int WG_GROUP = 8;           // (batch, head) pairs whose q tiles run together
// setmaxnreg: 40 * 128 + 232 * 256 = 168 * 384, the registers the CTA starts with
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;

// A consumer's wait: as mbar_wait, but a phase that never completes (a
// byte count that does not match what was issued) gives up after some
// seconds instead of trapping, and the launch computes on stale tiles: a
// __trap anywhere in the consumers' region makes ptxas hold the region to
// the CTA's entry register count (see the head note).
__device__ __forceinline__ void mbar_wait_consumer(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; n < (1u << 26); ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// A shared-memory matrix descriptor for wgmma over 128-byte-swizzled boxes:
// `lbo` and `sbo` bytes (the strides between 64-column atoms and between
// 8-row groups; K-major operands ignore lbo).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 + w, one per consumer warpgroup w (0 is __syncthreads):
// a warpgroup waits on its own before it issues its QK^T, and arrives on
// the other's after, so the two issue their products in turn.
__device__ __forceinline__ void turn_wait(int w) {
  if (w == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  if (w == 0)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory by
// descriptor, both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the accumulator
// layout of a 64 x 16 slice, bf16 pairs), B from shared memory by descriptor,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the accumulator
// layout of a 64 x 16 slice, bf16 pairs), B from shared memory by descriptor,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {   // 2^x; 0 for very negative x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one score tile in a consumer's accumulator (keys k0 ..
// k0 + WG_BK - 1; this thread's rows row0 and row0 + 8): scores become P
// in place, the running max and sum move on, and `corr` is the factor O
// takes.  The max is taken on raw scores and the scale folded into one FFMA
// before the exponent; MASK (the diagonal tile, the ragged Tk edge) sets
// keys past Tk or above the row to the reference's -1e30 first.
template <bool MASK>
__device__ __forceinline__ void wg_softmax(float (&sc)[WG_BK / 2], float (&m_r)[2],
                                           float (&l_r)[2], float (&corr)[2], float scale_log2,
                                           int k0, int row0, int t4, int Tk, bool causal) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < WG_BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK) {
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        const int row = row0 + (e >= 2 ? 8 : 0);
        if (col >= Tk || (causal && col > row)) sc[4 * n + e] = NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
    }
  }
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2((m_r[i] - mx[i]) * scale_log2);
    m_r[i] = mx[i];
    ms[i] = mx[i] * scale_log2;
  }
#pragma unroll
  for (int n = 0; n < WG_BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -ms[e >> 1]));
      rs[e >> 1] += sc[4 * n + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
}

// One CTA per (q tile, head, batch); see the head note.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_prefill_wg_kernel(
    __grid_constant__ const CUtensorMap q_map,   // q [B * H, Tq, HD], box 64 x WG_BQ x 1
    __grid_constant__ const CUtensorMap k_map,   // k [B * Kh, Tk, HD], box 64 x WG_BK x 1
    __grid_constant__ const CUtensorMap v_map,   // v, as k
    bf16* __restrict__ out, int H, int Kh, int Tq, int Tk, int causal, float scale_log2) {
  constexpr int BOXES = HD / WG_BOX;
  constexpr uint32_t Q_BOX = WG_BQ * WG_BOX * 2;    // bytes of a Q box, 16 KB
  constexpr uint32_t KV_BOX = WG_BK * WG_BOX * 2;   // bytes of a K or V box, 16 KB
  constexpr uint32_t STAGE = 2 * BOXES * KV_BOX;    // a K tile and a V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((WG_ALIGN - (smem_u32(smem_raw) & (WG_ALIGN - 1))) &
                                   (WG_ALIGN - 1));  // [BOXES][WG_BQ][64]
  unsigned char* kv_s = q_s + BOXES * Q_BOX;         // [stages][K, V][BOXES][WG_BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + WG_STAGES * STAGE);
  uint64_t* k_full = q_full + 1;                     // [WG_STAGES] each
  uint64_t* v_full = k_full + WG_STAGES;
  uint64_t* k_empty = v_full + WG_STAGES;
  uint64_t* v_empty = k_empty + WG_STAGES;

  // a 1-D grid in groups of WG_GROUP (batch, head) pairs, each group's q
  // tiles last to first across its heads: the CTAs in flight share K/V in L2
  const int n_qt = (Tq + WG_BQ - 1) / WG_BQ;
  const int n_bh = (int)gridDim.x / n_qt;
  const int grp = (int)blockIdx.x / (WG_GROUP * n_qt);
  const int in_grp = (int)blockIdx.x - grp * WG_GROUP * n_qt;
  const int grp_size = n_bh - grp * WG_GROUP < WG_GROUP ? n_bh - grp * WG_GROUP : WG_GROUP;
  const int bh = grp * WG_GROUP + in_grp % grp_size;
  const int b = bh / H, h = bh % H, kvh = h % Kh;
  const int q0 = (n_qt - 1 - in_grp / grp_size) * WG_BQ;
  const int qrows = Tq - q0 < WG_BQ ? Tq - q0 : WG_BQ;
  // keys up to the tile's last query row (causal) or all of them
  const int k_end = causal ? (q0 + qrows < Tk ? q0 + qrows : Tk) : Tk;
  const int n_kt = (k_end + WG_BK - 1) / WG_BK;
  // the role of this thread's warpgroup, made warp-uniform by a shuffle so
  // that ptxas holds each branch to its setmaxnreg count
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], WG_CONSUMER_WARPS);
      mbar_init(&v_empty[s], WG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The two roles never meet again: one branch each to the kernel's end,
  // so that ptxas can hold each to its setmaxnreg count.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kv_head = b * Kh + kvh;
      mbar_expect_tx(q_full, BOXES * Q_BOX);
      for (int c = 0; c < BOXES; ++c)
        tma_load_3d(q_s + c * Q_BOX, &q_map, c * WG_BOX, q0, b * H + h, q_full);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % WG_STAGES;
        // use j / STAGES of a slot waits for the consumers' release of the use before
        const uint32_t parity = (j / WG_STAGES - 1) & 1;
        unsigned char* st = kv_s + s * STAGE;
        if (j >= WG_STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], STAGE / 2);
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(st + c * KV_BOX, &k_map, c * WG_BOX, j * WG_BK, kv_head, &k_full[s]);
        if (j >= WG_STAGES) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], STAGE / 2);
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(st + (BOXES + c) * KV_BOX, &v_map, c * WG_BOX, j * WG_BK, kv_head,
                      &v_full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
    const int cw = wg - 1;                   // consumer 0 or 1
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;   // fragment rows g and g + 8, columns 2 t4, 2 t4 + 1
    const int wg_row0 = q0 + 64 * cw;        // the warpgroup's first query row
    const int row0 = wg_row0 + 16 * warp + g;
    const unsigned char* q_wg = q_s + cw * 64 * 128;   // its 64 rows of each Q box
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};     // running max of the raw scores, rows g and g + 8
    float l_r[2] = {0.f, 0.f};             // this thread's part of the running sum
    float corr[2];                         // the rescale of O a tile brings
    float sc[WG_BK / 2] = {};              // a score tile, then its P in fp32
    uint32_t p[WG_BK / 16][4];             // P in bf16: keys 16 kk .. 16 kk + 15 are the
                                           // A fragment of the k16 step kk

    auto wait_k = [&](int j) {
      mbar_wait_consumer(&k_full[j % WG_STAGES], (j / WG_STAGES) & 1);
      __syncwarp();                        // wgmma wants the warp converged
    };
    auto wait_v = [&](int j) {
      mbar_wait_consumer(&v_full[j % WG_STAGES], (j / WG_STAGES) & 1);
      __syncwarp();
    };
    auto release = [&](uint64_t* bar) {    // this warp is done with a K or V slot
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K^T of tile j over hd in k16 steps (32 bytes along each swizzled row)
    auto issue_s = [&](int j) {
      const unsigned char* ks = kv_s + (j % WG_STAGES) * STAGE;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qoff = (kk / 4) * Q_BOX + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * KV_BOX + (kk % 4) * 32;
        wgmma_ss_n128(sc, wg_desc(q_wg + qoff, 16, 1024), wg_desc(ks + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile j over its keys in k16 steps (16 rows, 2 KB, of each V box)
    auto issue_pv = [&](int j) {
      const unsigned char* vs = kv_s + (j % WG_STAGES) * STAGE + BOXES * KV_BOX;
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t vd = wg_desc(vs + kk * 16 * 128, KV_BOX, 1024);
        if constexpr (HD == 128) {
          wgmma_rs_n128(o, p[kk], vd);
        } else {
          wgmma_rs_n64(o, p[kk], vd);
        }
      }
      wgmma_commit();
    };
    // the online softmax of tile j (only tiles that cross the diagonal or Tk
    // are masked); O is rescaled for its max and its P rounded to bf16 after
    // the P V before it is done
    auto softmax = [&](int j) {
      const int k0 = j * WG_BK;
      if (k0 + WG_BK > Tk || (causal && k0 + WG_BK - 1 > wg_row0))
        wg_softmax<true>(sc, m_r, l_r, corr, scale_log2, k0, row0, t4, Tk, causal);
      else
        wg_softmax<false>(sc, m_r, l_r, corr, scale_log2, k0, row0, t4, Tk, causal);
    };
    auto rescale_pack = [&]() {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 0] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // A turn on the tensor cores is one block of issues: S of tile 0, then
    // S of tile j with P V of tile j - 1 (n_kt - 1 blocks), then P V of the
    // last tile.  Each turn_wait meets one turn_pass of the other consumer.
    int blocks_left = n_kt + 1;
    auto turn_begin = [&]() { turn_wait(cw); };
    auto turn_end = [&]() {
      if (cw == 0 || --blocks_left > 0) turn_pass(cw);
    };

    if (cw == 1) turn_pass(cw);            // consumer 0 issues first
    mbar_wait_consumer(q_full, 0);
    wait_k(0);
    wg_pin(sc);
    turn_begin();
    wgmma_fence();
    issue_s(0);
    turn_end();
    wgmma_wait<0>();
    wg_pin(sc);
    release(&k_empty[0]);
    softmax(0);
    rescale_pack();
    for (int j = 1; j < n_kt; ++j) {
      wait_k(j);
      wait_v(j - 1);
      wg_pin(sc);
      wg_pin(o);
      turn_begin();
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      turn_end();
      wgmma_wait<1>();                     // S of j is done: its softmax runs beside
      wg_pin(sc);                          // the rest of P V of j - 1
      release(&k_empty[j % WG_STAGES]);
      softmax(j);
      wgmma_wait<0>();                     // P V of j - 1 is done
      wg_pin(o);
      release(&v_empty[(j - 1) % WG_STAGES]);
      rescale_pack();
    }
    wait_v(n_kt - 1);
    wg_pin(o);
    turn_begin();
    wgmma_fence();
    issue_pv(n_kt - 1);
    turn_end();
    wgmma_wait<0>();
    wg_pin(o);
    release(&v_empty[(n_kt - 1) % WG_STAGES]);

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
      const int row = row0 + 8 * i;
      if (row >= Tq) continue;
      bf16* og = out + (((size_t)b * H + h) * Tq + row) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(og + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv[i], o[4 * n + 2 * i + 1] * inv[i]);
    }
  }
}

// Dynamic shared memory of a wgmma-design launch at head dim HD: the
// alignment slack, Q, two stages of K and V tiles (128-byte rows, no
// padding: the swizzle spreads the banks), and 1 + 4 * stages mbarriers
// (Q's; a full and an empty one for each K and each V slot).
__host__ __device__ constexpr size_t wg_smem(int HD) {
  return (size_t)WG_ALIGN + (size_t)(WG_BQ + 2 * WG_STAGES * WG_BK) * HD * sizeof(bf16) +
         (size_t)(1 + 4 * WG_STAGES) * sizeof(uint64_t);
}

// x [heads, T, hd] in boxes of 64 columns by `rows` rows, 128-byte swizzled.
int prefill_map(CUtensorMap* map, const void* x, int heads, int T, int hd, int rows) {
  const uint64_t dims[3] = {(uint64_t)hd, (uint64_t)T, (uint64_t)heads};
  const uint64_t pitch[2] = {(uint64_t)hd * 2, (uint64_t)T * hd * 2};
  const uint32_t box[3] = {WG_BOX, (uint32_t)rows, 1};
  return dak_encode(map, x, 2, 3, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
              int Tq, int Tk, int causal, cudaStream_t stream) {
  constexpr size_t smem = wg_smem(HD);
  static_assert(smem <= 227 * 1024, "Q and the K/V ring must fit in shared memory");
  CUtensorMap qm, km, vm;
  int rc = prefill_map(&qm, q, B * H, Tq, HD, WG_BQ);
  if (rc == 0) rc = prefill_map(&km, k, B * Kh, Tk, HD, WG_BK);
  if (rc == 0) rc = prefill_map(&vm, v, B * Kh, Tk, HD, WG_BK);
  if (rc != 0) return rc;
  auto kern = flash_prefill_wg_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((Tq + WG_BQ - 1) / WG_BQ) * B * H);
  kern<<<grid, WG_THREADS, smem, stream>>>(qm, km, vm, static_cast<bf16*>(out), H, Kh, Tq, Tk,
                                            causal, 1.4426950408889634f / sqrtf((float)HD));
  return cudaGetLastError();
}

int dispatch_wg(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  const long long ctas = (long long)((Tq + WG_BQ - 1) / WG_BQ) * B * H;
  if (ctas > 0x7fffffff || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return DAK_ERR_BAD_ARGUMENT;
  if (hd == 64) return launch_wg<64>(q, k, v, out, B, H, Kh, Tq, Tk, causal, stream);
  if (hd == 128) return launch_wg<128>(q, k, v, out, B, H, Kh, Tq, Tk, causal, stream);
  return DAK_ERR_BAD_ARGUMENT;
}

}  // namespace

// The designs of `dak_flash_prefill` (flash_prefill.py `_DESIGNS`).
enum { DESIGN_FMA = 0, DESIGN_MMA = 1, DESIGN_WGMMA = 2 };

static inline bool prefill_args_ok(int B, int H, int Kh, int Tq, int Tk, int hd, int dtype,
                                   int design) {
  const bool fits = design == DESIGN_FMA     ? dtype == 0
                    : design == DESIGN_MMA   ? dtype == 1
                    : design == DESIGN_WGMMA ? dtype == 1 && (hd == 64 || hd == 128)
                                             : false;
  return fits && B > 0 && H > 0 && Kh > 0 && H % Kh == 0 && Tq > 0 && Tk > 0 && hd > 0 &&
         hd <= 256 && H <= 65535 && B <= 65535;
}

// dtype: 0 = float32, 1 = bfloat16; design: DESIGN_FMA (float32),
// DESIGN_MMA (bfloat16, hd <= 256) or DESIGN_WGMMA (bfloat16, hd 64 or 128,
// every pointer 16-byte aligned).  Returns 0, a cudaError_t, or a DAK_ERR_*
// code (a design the arguments do not fit is DAK_ERR_BAD_ARGUMENT).
extern "C" int dak_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int Kh, int Tq, int Tk, int hd, int causal, int dtype,
                                 int design, void* stream) {
  if (!prefill_args_ok(B, H, Kh, Tq, Tk, hd, dtype, design)) return DAK_ERR_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case DESIGN_FMA: return dispatch_prefill(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
    case DESIGN_MMA: return dispatch_tc(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
    default: return dispatch_wg(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
  }
}

// The dynamic shared memory a dak_flash_prefill launch of `design` at head
// dim `hd` would hold (its tiles are fixed at compile time).  Launches
// nothing; the wrapper's shared-memory footprint is checked against it.
// Returns 0 or DAK_ERR_BAD_ARGUMENT.
extern "C" int dak_flash_prefill_smem(int hd, int dtype, int design, long long* bytes) {
  if (!prefill_args_ok(1, 1, 1, 1, 1, hd, dtype, design) || bytes == nullptr)
    return DAK_ERR_BAD_ARGUMENT;
  const int padded = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  *bytes = (long long)(design == DESIGN_FMA   ? fma_smem(hd)
                       : design == DESIGN_MMA ? tc_smem(padded)
                                              : wg_smem(hd));
  return 0;
}
