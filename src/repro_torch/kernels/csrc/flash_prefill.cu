// Causal (or full) flash attention for prefill on Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py `_kernel` (line 30;
// pallas_call at :107, wrapper `flash_prefill` :90).  As in the reference it
// is off the serving path (prefill attends through `layers.attend`); its
// callers are the kernel benchmarks and tests.
//
// q [B, H, Tq, hd], k/v [B, Kh, Tk, hd] -> out [B, H, Tq, hd].  Group-major
// GQA: query head h reads kv head h % Kh (not h // G).  Causal masks key
// positions above the query position (both counted from 0).
//
// Bound on this card: operations for any prompt longer than a few dozen
// tokens.  Attention does ~2*T*hd multiply-adds per query row (half that,
// causal) on q/k/v bytes that are each read once, so at T = 2048 it needs
// ~1000 FLOP per byte, far above the ~295 at which the H100's bf16 tensor
// cores (989 TFLOP/s) rather than HBM become the limit.
//
// What this first version does (it is right and simple; wgmma/mma.sync
// with TMA-fed tiles is the later, fast version):
//  * One CTA (256 threads) per (q tile, head, batch); blockIdx.x runs the
//    q tiles last to first, so the causal tiles with the most keys start
//    first and the short ones fill in behind them.
//  * The CTA's q tile (pre-scaled by hd**-0.5) and each k/v tile live in
//    shared memory as fp32, rows padded by one float against bank conflicts.
//    Every tile is 64 rows (TILE): a q tile and two k/v tiles in fp32 at
//    hd 128 take 114 KiB, at hd 256 210 KiB, within the 227 KiB a block may
//    use.
//  * Key tiles wholly above the diagonal are never loaded (the loop stops
//    at the tile's last query row); ragged Tq/Tk edges are masked, so any
//    T is taken (the reference demands T % block == 0).
//  * fp32 online softmax (one warp per query row), scores and P·V by plain
//    FMA in fp32 registers: each thread owns 4x4 scores and 4 rows of the
//    output at 16-column stride.
#include <cmath>

#include "dak_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;              // rows of a q tile and of a k tile
static_assert(TILE * TILE == 16 * THREADS, "each thread owns 4 x 4 scores of a tile");
constexpr float NEG_INF = -1e30f;     // the reference's mask value, finite

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

template <typename T, int DJ>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int H, int Kh,
                   int Tq, int Tk, int hd, int causal, cudaStream_t stream) {
  const size_t smem =
      ((size_t)3 * TILE * (hd + 1) + (size_t)TILE * (TILE + 1) + 3 * TILE) * sizeof(float);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd <= 256.  Returns 0, a cudaError_t, or
// a DAK_ERR_* code.
extern "C" int dak_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int Kh, int Tq, int Tk, int hd, int causal, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh || Tq <= 0 || Tk <= 0 || hd <= 0 || hd > 256 ||
      (dtype != 0 && dtype != 1) || H > 65535 || B > 65535)
    return DAK_ERR_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_prefill<float>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s)
             : dispatch_prefill<__nv_bfloat16>(q, k, v, out, B, H, Kh, Tq, Tk, hd, causal != 0, s);
}
