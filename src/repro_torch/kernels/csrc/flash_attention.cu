// Prefill attention with an online softmax (flash attention), causal or
// not, with an optional sliding window and grouped-query heads.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// `flash_attention` (body `_flash_kernel`). q is (B, Hq, T, D); k and v are
// (B, Hkv, T, D) with Hq a multiple of Hkv (q head h reads kv head
// h / (Hq / Hkv)); all three f32 or all three bf16; out is (B, Hq, T, D) in
// q's type. D <= 128. Query i attends to key j when j < T, j <= i if
// causal, and i - j < window if a window is given. q is scaled by
// D^-1/2 in f32 before QK^T; scores, softmax and PV run in f32.
//
// Bound on an H100: operations for long sequences (4 D FLOP per reachable
// (query, key) pair against 2 D (1 + 1/G) bytes per key row read), bytes
// for short ones. This first version runs on the CUDA cores in f32 (no
// tensor cores, no TMA): one block of 128 threads per (b * Hq + h, 64-query
// tile) walks the reachable 64-key tiles only, so under a causal mask or a
// window the unreachable tiles cost nothing (the TPU kernel's
// `pl.when(reachable)`). The scaled Q tile stays in shared memory; the K
// tile and then the V tile share one buffer. Rows have an odd stride, so
// the rows a warp reads fall in distinct banks. Each thread owns 4 query
// rows: 8 of a tile's 64 scores per row (a shuffle over the 8 threads of
// a row gives its max and sum) and 16 columns of the output accumulator
// per row. The TPU kernel pads T up to a block multiple with zero keys and
// lets the mask drop them; without a causal mask it does not, so padded
// keys are attended. Here keys at j >= T never count. A row with no
// reachable key (only possible with an empty window) writes zeros, as the
// TPU kernel's finalize does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups of 4 x 8 column lanes
constexpr int DMAX = 128;
constexpr int DCOLS = DMAX / 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Copy rows [row0, row0 + rows) of a (seq, D) matrix into a tile of
// stride ld, zero-filling rows at or past seq.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int rows, int seq,
                                          int D, int ld, float scale) {
  const int n = rows * D;
  const long long base = (long long)row0 * D;
  const long long limit = (long long)seq * D;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const long long g = base + i;
    dst[r * ld + d] = g < limit ? to_f32(src[g]) * scale : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
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
  const T* qh = q + (long long)bh * seq * D;
  const T* kh = k + ((long long)b * Hkv + kvh) * seq * D;
  const T* vh = v + ((long long)b * Hkv + kvh) * seq * D;
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

  T* oh = out + (long long)bh * seq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= seq) continue;
    const float safe = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int col = tx + 8 * c;
      if (col < D) store(oh + (long long)qi * D + col, acc[i][c] / safe);
    }
  }
}

template <typename T>
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
      flash_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, seq, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int seq, int D, int causal,
                                   int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, Hq, Hkv, seq, D, causal, window,
                       scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Hq,
                                    int Hkv, int seq, int D, int causal,
                                    int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, seq, D, causal,
                               window, scale, stream);
}
