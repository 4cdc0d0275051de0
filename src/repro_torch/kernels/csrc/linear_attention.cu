// Chunked gated linear attention (the Mamba-2 SSD recurrence), with the
// (Dk, Dv) state carried on chip across the chunks of one head.
//
// Replaces the Pallas kernel repro/kernels/linear_attention.py
// `linear_attention` (body `_gla_kernel`). Per head: S_t = exp(ld_t) S_{t-1}
// + k_t^T v_t and o_t = q_t S_t, for q, k (BH, T, Dk), v (BH, T, Dv) (all f32
// or all bf16), log-decays ld (BH, T) f32 (entries <= 0); out (BH, T, Dv) in
// q's type. Dk <= 128, any Dv. Everything is computed in f32.
//
// Bound on an H100: bytes (each input read once, the output written once)
// against 5 Dk Dv FLOP per step of the plain recurrence; the chunk form
// below does (C + 1)(Dk + Dv) + 4 Dk Dv per step and Dv tile. The TPU
// kernel carries S in scratch across a sequential grid axis. Blocks here
// run in no order, so one block of 256 threads owns a (head, 32-column Dv
// tile) and loops over the chunks itself, with S in shared memory. Per
// chunk of C = 64 steps (padded steps take log-decay 0 and zero q, k, v,
// which leaves the recurrence as it was):
//   cum_i = sum_{t<=i} ld_t (a warp scan), total = cum_{C-1};
//   A_ij = (q_i . k_j) exp(cum_i - cum_j) for i >= j, else 0;
//   o_i = sum_j A_ij v_j + exp(cum_i) (q_i . S);
//   S <- exp(total) S + sum_j exp(total - cum_j) k_j^T v_j.
// exp(cum_i - cum_j) is formed for i >= j only: for i < j it is a growth,
// which overflows to inf at Mamba-2's decays (the TPU kernel forms it and
// discards it with a where). Every exponent used is <= 0. The C x C
// scores are recomputed for each Dv tile. Rows of q and k have an odd
// stride, so the rows a warp reads fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 64;         // steps per chunk
constexpr int DVT = 32;       // Dv columns per block
constexpr int THREADS = 256;
constexpr int DKMAX = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ log_decay,
                        T* __restrict__ out, int seq, int Dk, int Dv) {
  extern __shared__ float smem[];
  const int ldk = Dk | 1;
  const int lda = C + 1;
  float* qs = smem;                    // [C][ldk]
  float* ks = qs + C * ldk;            // [C][ldk]
  float* vs = ks + C * ldk;            // [C][DVT]
  float* As = vs + C * DVT;            // [C][lda]
  float* S = As + C * lda;             // [Dk][DVT]
  float* cum = S + Dk * DVT;           // [C]
  float* ecum = cum + C;               // [C] exp(cum_i)
  float* w = ecum + C;                 // [C] exp(total - cum_j)
  float* etotal = w + C;               // [1] exp(total)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int dv0 = blockIdx.x * DVT;
  const long long row0 = (long long)bh * seq;
  const T* qh = q + row0 * Dk;
  const T* kh = k + row0 * Dk;
  const T* vh = v + row0 * Dv;
  const float* ldh = log_decay + row0;
  T* oh = out + row0 * Dv;

  for (int i = tid; i < Dk * DVT; i += THREADS) S[i] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += C) {
    // -- load the chunk (zero past the end) --------------------------------
    const long long kbase = (long long)t0 * Dk;
    const long long klimit = (long long)seq * Dk;
    for (int i = tid; i < C * Dk; i += THREADS) {
      const int r = i / Dk, d = i - r * Dk;
      const long long g = kbase + i;
      qs[r * ldk + d] = g < klimit ? to_f32(qh[g]) : 0.0f;
      ks[r * ldk + d] = g < klimit ? to_f32(kh[g]) : 0.0f;
    }
    for (int i = tid; i < C * DVT; i += THREADS) {
      const int r = i / DVT, c = i - r * DVT;
      const int t = t0 + r, col = dv0 + c;
      vs[i] = (t < seq && col < Dv)
                  ? to_f32(vh[(long long)t * Dv + col]) : 0.0f;
    }
    if (tid < 32) {                    // inclusive scan of the log-decays
      const int t = t0 + 2 * tid;
      const float a = t < seq ? ldh[t] : 0.0f;
      const float b = t + 1 < seq ? ldh[t + 1] : 0.0f;
      float s = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += up;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) prev = 0.0f;
      cum[2 * tid] = prev + a;
      cum[2 * tid + 1] = s;
      __syncwarp();
      const float total = __shfl_sync(0xffffffffu, s, 31);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * tid + e;
        ecum[j] = expf(cum[j]);
        w[j] = expf(total - cum[j]);
      }
      if (tid == 0) *etotal = expf(total);
    }
    __syncthreads();

    // -- decayed causal scores A (a 4 x 4 micro-tile per thread) -----------
    {
      const int ti = tid >> 4, tj = tid & 15;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
      for (int d = 0; d < Dk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[(ti * 4 + r) * ldk + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ks[(tj + 16 * c) * ldk + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          As[i * lda + j] = i >= j ? s[r][c] * expf(cum[i] - cum[j]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // -- outputs: intra-chunk part plus the carried state's ---------------
    {
      const int tr = tid >> 3, tc = tid & 7;
      float intra[2][4], inter[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) intra[r][c] = inter[r][c] = 0.0f;
      for (int j = 0; j < C; ++j) {
        float a[2], b[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = As[(tr + 32 * r) * lda + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = vs[j * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            intra[r][c] = fmaf(a[r], b[c], intra[r][c]);
      }
      for (int d = 0; d < Dk; ++d) {
        float a[2], b[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = qs[(tr + 32 * r) * ldk + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = S[d * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(a[r], b[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tr + 32 * r, t = t0 + i;
        if (t >= seq) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = dv0 + tc + 8 * c;
          if (col < Dv)
            store(oh + (long long)t * Dv + col,
                  intra[r][c] + ecum[i] * inter[r][c]);
        }
      }
    }
    __syncthreads();                   // every output has read S

    // -- state update: each thread owns up to 4 x 4 entries of S ----------
    {
      const int tr = tid >> 3, tc = tid & 7;
      const float decay = *etotal;
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) upd[r][c] = 0.0f;
      for (int j = 0; j < C; ++j) {
        const float wj = w[j];
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = tr + 32 * r;
          a[r] = d < Dk ? ks[j * ldk + d] * wj : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = vs[j * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) upd[r][c] = fmaf(a[r], b[c], upd[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = tr + 32 * r;
        if (d >= Dk) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* sp = S + d * DVT + tc + 8 * c;
          *sp = decay * *sp + upd[r][c];
        }
      }
    }
    __syncthreads();                   // S is whole before the next chunk
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const void* log_decay, void* out, int BH, int seq, int Dk, int Dv,
           void* stream) {
  if (BH <= 0 || seq <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > DKMAX) return (int)cudaErrorInvalidValue;
  const int ldk = Dk | 1;
  const size_t bytes = sizeof(float) * (size_t)(2 * C * ldk + C * DVT +
                                                C * (C + 1) + Dk * DVT +
                                                3 * C + 1);
  cudaError_t err = cudaFuncSetAttribute(
      linear_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Dv + DVT - 1) / DVT, BH);
  linear_attention_kernel<T><<<grid, THREADS, bytes,
                               (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)log_decay,
      (T*)out, seq, Dk, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int linear_attention_f32(const void* q, const void* k,
                                    const void* v, const void* log_decay,
                                    void* out, int BH, int seq, int Dk,
                                    int Dv, void* stream) {
  return launch<float>(q, k, v, log_decay, out, BH, seq, Dk, Dv, stream);
}

extern "C" int linear_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* log_decay,
                                     void* out, int BH, int seq, int Dk,
                                     int Dv, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, log_decay, out, BH, seq, Dk, Dv,
                               stream);
}
