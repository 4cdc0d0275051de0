// Prefill attention with an online softmax (flash attention), causal or
// not, with an optional sliding window and grouped-query heads.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// `flash_attention` (body `_flash_kernel`). q is (B, Hq, T, D); k and v are
// (B, Hkv, T, D) with Hq a multiple of Hkv (q head h reads kv head
// h / (Hq / Hkv)); all three f32 or all three bf16; out is (B, Hq, T, D) in
// q's type. D <= 128 in f32, D <= 224 in bf16; the scores are scaled by the
// caller's `scale` (D^-1/2 unless the model says otherwise). Query i
// attends to key j when j < T, j <= i if causal, and i - j < window if a
// window is given. The TPU kernel pads T
// up to a block multiple with zero keys and lets the mask drop them;
// without a causal mask it does not, so padded keys are attended. Here
// keys at j >= T never count. A row with no reachable key (only possible
// with an empty window) writes zeros, as the TPU kernel's finalize does.
// Both paths walk only the reachable key tiles of a query tile, so under
// a causal mask or a window the unreachable tiles are never loaded (the
// TPU kernel's `pl.when(reachable)`).
//
// Bound on an H100: operations for long sequences (4 D FLOP per reachable
// (query, key) pair against 2 D (1 + 1/G) bytes per key row read), bytes
// for short ones.
//
// bf16 inputs: the tensor cores, FA2-style on `mma.sync.m16n8k16` (bf16
// in, f32 accumulate). One block of 4 warps owns a 64-query tile of one
// (b, h); each warp owns 16 query rows. The Q tile's A fragments stay in
// registers for the whole walk. K and V tiles of 64 keys arrive by
// 16-byte `cp.async` (zero-filled past T; element by element when D is
// not a multiple of 8) into a double-buffered ring in shared memory, the
// next tile in flight while this one computes. S =
// Q K^T comes from `ldmatrix` of K rows (K is the "col" B operand as it
// lies); S stays in registers, is scaled by `scale` in f32, masked, and
// drives the f32 online softmax; P is rounded to bf16 and re-packed in
// registers as the A fragment of O += P V, with V read by
// `ldmatrix.trans`. The row sum l adds the bf16-rounded P, so the weights
// that multiply V sum to one. Rows have a stride of D + 8 bf16, which puts
// the 8 rows an `ldmatrix` reads in distinct banks; a head dim that is not
// a multiple of 16 is zero-padded in shared memory (never in device
// memory) up to the next one. Rounding against the reference's f32
// function: bf16 x bf16 products are exact in f32, so S differs only by
// the order of f32 sums; the one real change is P in bf16 before P V
// (relative 2^-9 per weight). Causal grids start with the heaviest query
// tiles. Head dims 129-224 (Zamba2-7B-Instruct's shared attention, D 224
// over its 7168-wide [residual, embedding] input) take one more
// instantiation, 224 columns padded like the others: its O accumulators
// alone are 112 registers a thread, so the Q tile's A fragments are read
// from shared memory at each key tile (`ldmatrix`, 14 a tile and warp)
// instead of held, and its 148 KB of shared memory leave one block an SM.
// What `wgmma` would add (a later design): 64-row warpgroup
// products issued asynchronously from shared memory, TMA loads and a
// producer warp, for the rest of the way to the 989 TFLOP/s peak.
//
// f32 inputs: the CUDA cores (no f32 tensor-core product without TF32,
// which would break the f32 tolerance): one block of 128 threads per
// (b * Hq + h, 64-query tile). q is scaled by D^-1/2 in f32 before QK^T;
// scores, softmax and PV run in f32. The scaled Q tile stays in shared
// memory; the K tile and then the V tile share one buffer. Rows have an
// odd stride, so the rows a warp reads fall in distinct banks. Each
// thread owns 4 query rows: 8 of a tile's 64 scores per row (a shuffle
// over the 8 threads of a row gives its max and sum) and 16 columns of
// the output accumulator per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups of 4 x 8 column lanes
constexpr int DMAX = 128;
constexpr int DCOLS = DMAX / 8;

// Copy rows [row0, row0 + rows) of a (seq, D) matrix into a tile of
// stride ld, zero-filling rows at or past seq.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows, int seq,
                                          int D, int ld, float scale) {
  const int n = rows * D;
  const long long base = (long long)row0 * D;
  const long long limit = (long long)seq * D;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const long long g = base + i;
    dst[r * ld + d] = g < limit ? src[g] * scale : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Hq, int Hkv, int seq, int D, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D | 1;                // odd stride: distinct banks
  const int ldp = BK + 1;
  float* Qs = smem;                    // [BQ][ld], scaled
  float* KV = Qs + BQ * ld;            // [BK][ld]: K tile, then V tile
  float* Ps = KV + BK * ld;            // [BQ][ldp]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const float* qh = q + (long long)bh * seq * D;
  const float* kh = k + ((long long)b * Hkv + kvh) * seq * D;
  const float* vh = v + ((long long)b * Hkv + kvh) * seq * D;
  const int q0 = blockIdx.x * BQ;

  load_tile(Qs, qh, q0, BQ, seq, D, ld, scale);

  // reachable keys of the tile's queries: [k_begin, k_end)
  int k_end = causal ? min(seq, q0 + BQ) : seq;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][DCOLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                   // previous tile's PV is done
    load_tile(KV, kh, k0, BK, seq, D, ld, 1.0f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = KV[(tx + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        bool ok = kj < seq;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && qi - kj < window;
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * ldp + tx + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                   // every thread is done with K
    load_tile(KV, vh, k0, BK, seq, D, ld, 1.0f);
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int col = tx + 8 * c;
        if (col < D) {
          const float vv = KV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  float* oh = out + (long long)bh * seq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= seq) continue;
    const float safe = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int col = tx + 8 * c;
      if (col < D) oh[(long long)qi * D + col] = acc[i][c] / safe;
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int seq, int D, int causal, int window,
           float scale, void* stream) {
  if (B <= 0 || seq <= 0) return 0;
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int ld = D | 1;
  const size_t bytes = sizeof(float) * (size_t)(BQ * ld + BK * ld +
                                                BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Hq,
      Hkv, seq, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------
namespace tensor_core {

using namespace ::tc;
constexpr int BQ = 64;              // queries per block, 16 per warp
constexpr int BKV = 64;             // keys per tile
constexpr int THREADS = 128;        // 4 warps
constexpr int DMAX_TC = 224;        // the widest head dim of this path
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
__global__ void __launch_bounds__(THREADS, DP <= DMAX ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int Hq,
                int Hkv, int T, int D, int causal, int window, float scale,
                int vec) {
  constexpr int LD = DP + 8;        // ldmatrix's 8 rows in distinct banks
  constexpr int KC = DP / 16;       // 16-wide head-dim chunks (QK^T depth)
  constexpr int NB = BKV / 8;       // 8-key blocks of S
  constexpr int DB = DP / 8;        // 8-wide blocks of O
  constexpr bool QREG = DP <= DMAX; // Q's A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                   // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  // causal: the heaviest query tiles (most keys) first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const bf16* qh = q + (long long)bh * T * D;
  const bf16* kh = k + ((long long)b * Hkv + kvh) * T * D;
  const bf16* vh = v + ((long long)b * Hkv + kvh) * T * D;

  // reachable keys of the tile's queries: [k_begin, k_end), k_end >= 1
  const int k_end = causal ? min(T, q0 + BQ) : T;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_begin / BKV, t_last = (k_end - 1) / BKV;

  // head-dim columns D .. DP-1 of every buffer are zero (never copied to)
  if (D < DP) {
    const int pad = DP - D;
    for (int i = tid; i < (BQ + 4 * BKV) * pad; i += THREADS)
      Qs[(i / pad) * LD + D + i % pad] = __float2bfloat16(0.0f);
  }
  load_rows<BKV, THREADS>(Qs, DP + 8, qh, D, q0, T, D, vec);
  load_rows<BKV, THREADS>(Ks, DP + 8, kh, D, t_first * BKV, T, D, vec);
  load_rows<BKV, THREADS>(Vs, DP + 8, vh, D, t_first * BKV, T, D, vec);
  cp_async_commit();

  const float sl2 = scale * LOG2E;  // exp(x * scale) = exp2(x * sl2)
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  uint32_t qf[QREG ? KC : 1][4];
  float o[DB][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;

  for (int t = t_first; t <= t_last; ++t) {
    const int buf = (t - t_first) & 1;
    if (t < t_last) {
      const int nxt = (buf ^ 1) * BKV * LD;
      load_rows<BKV, THREADS>(Ks + nxt, DP + 8, kh, D, (t + 1) * BKV, T, D,
                              vec);
      load_rows<BKV, THREADS>(Vs + nxt, DP + 8, vh, D, (t + 1) * BKV, T, D,
                              vec);
      cp_async_commit();
      cp_async_wait<1>();            // tile t has landed, t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (t == t_first) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldsm_x4(qf[kc], Qs + (warp * 16 + lane % 16) * LD + kc * 16 +
                              (lane / 16) * 8);
      }
    }
    const bf16* Kt = Ks + buf * BKV * LD;
    const bf16* Vt = Vs + buf * BKV * LD;

    // S = Q K^T (raw, unscaled) for this warp's 16 rows x 64 keys
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    // depth outermost: successive products into one accumulator are 8
    // MMAs apart, so the tensor pipe does not wait on their latency
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
      } else {
        ldsm_x4(qa, Qs + (warp * 16 + lane % 16) * LD + kc * 16 +
                        (lane / 16) * 8);
      }
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4(r, Kt + (n2 * 16 + lane % 8 + 8 * (lane / 16)) * LD +
                       kc * 16 + 8 * ((lane / 8) % 2));
        mma(s[2 * n2], qa, r[0], r[1]);
        mma(s[2 * n2 + 1], qa, r[2], r[3]);
      }
    }

    const int k0 = t * BKV;
    if (k0 + BKV > T || (causal && k0 + BKV - 1 > q0) ||
        (window > 0 && q0 + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qi = e < 2 ? row_a : row_b;
          bool ok = kj < T;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && qi - kj < window;
          if (!ok) s[n][e] = -INFINITY;
        }
    }

    // online softmax in f32; rows row_a (e = 0, 1) and row_b (e = 2, 3),
    // each spread over the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * sl2;
      corr[r] = exp2f(m[r] * sl2 - base[r]);   // 0 while m is -inf
      m[r] = mx[r];
    }
    // P in bf16, packed as the A fragments of P V: 16-key chunk c takes
    // S blocks 2c (a0 row_a, a1 row_b) and 2c + 1 (a2, a3)
    uint32_t pa[NB / 2][4];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const __nv_bfloat162 pa_lo = __floats2bfloat162_rn(
          exp2f(fmaf(s[n][0], sl2, -base[0])),
          exp2f(fmaf(s[n][1], sl2, -base[0])));
      const __nv_bfloat162 pa_hi = __floats2bfloat162_rn(
          exp2f(fmaf(s[n][2], sl2, -base[1])),
          exp2f(fmaf(s[n][3], sl2, -base[1])));
      rs[0] += __low2float(pa_lo) + __high2float(pa_lo);
      rs[1] += __low2float(pa_hi) + __high2float(pa_hi);
      pa[n / 2][(n & 1) * 2] = bits(pa_lo);
      pa[n / 2][(n & 1) * 2 + 1] = bits(pa_hi);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P V; V rows are keys, read transposed as the "col" B operand
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
#pragma unroll
      for (int d2 = 0; d2 < DB / 2; ++d2) {
        uint32_t r[4];
        ldsm_x4_t(r, Vt + (c * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                         d2 * 16 + 8 * (lane / 16));
        mma(o[2 * d2], pa[c], r[0], r[1]);
        mma(o[2 * d2 + 1], pa[c], r[2], r[3]);
      }
    }
    __syncthreads();                   // this buffer is free for tile t + 2
  }

  bf16* oh = out + (long long)bh * T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r == 0 ? row_a : row_b;
    if (qi >= T) continue;
    const float safe = l[r] > 0.0f ? l[r] : 1.0f;   // no key: zeros
    bf16* orow = oh + (long long)qi * D;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      const int col = d * 8 + 2 * t4;
      const float x = o[d][2 * r] / safe, y = o[d][2 * r + 1] / safe;
      if (D % 2 == 0) {
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
           int Hq, int Hkv, int T, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const int bytes = (BQ + 4 * BKV) * (DP + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const dim3 grid((T + BQ - 1) / BQ, B * Hq);
  flash_tc_kernel<DP><<<grid, THREADS, bytes, stream>>>(
      q, k, v, out, Hq, Hkv, T, D, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int T, int D, int causal, int window,
             float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || D > DMAX_TC || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const bf16 *Q = (const bf16*)q, *K = (const bf16*)k, *V = (const bf16*)v;
  bf16* O = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  // head dim padded to a multiple of 16 up to 128, else to 224
#define FLASH_TC(DP) \
  launch<DP>(Q, K, V, O, B, Hq, Hkv, T, D, causal, window, scale, s)
  switch ((D + 15) / 16) {
    case 1: return FLASH_TC(16);
    case 2: return FLASH_TC(32);
    case 3: return FLASH_TC(48);
    case 4: return FLASH_TC(64);
    case 5: return FLASH_TC(80);
    case 6: return FLASH_TC(96);
    case 7: return FLASH_TC(112);
    case 8: return FLASH_TC(128);
    default: return FLASH_TC(224);
  }
#undef FLASH_TC
}

}  // namespace tensor_core

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int seq, int D, int causal,
                                   int window, float scale, void* stream) {
  return launch(q, k, v, out, B, Hq, Hkv, seq, D, causal, window, scale,
                stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int seq, int D, int causal,
                                    int window, float scale, void* stream) {
  return tensor_core::dispatch(q, k, v, out, B, Hq, Hkv, seq, D, causal, window,
                      scale, stream);
}
