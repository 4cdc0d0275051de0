// C = A @ B in f32 with f32 accumulation (paper benchmark: MatMul).
//
// Replaces the Pallas kernel repro/kernels/matmul.py `matmul`
// (body `_matmul_kernel`): a tiled product whose K loop accumulates in an
// f32 scratch tile.
//
// Bound on an H100: operations. At the main path's sizes (a row block of
// A against the whole 4864 x 4864 B) the product does 2*M*N*K FLOP over
// (M*K + K*N + M*N) * 4 bytes, hundreds of FLOP per byte, so the f32 rate
// of the CUDA cores (67 TFLOP/s on the SXM part) is the ceiling. TF32, the
// tensor cores and split-K stay off: each output is one fmaf per k in
// ascending k from 0, so the result equals `matmul_plain` bit for bit.
//
// Design: a register-tiled SGEMM. A 256-thread block owns a BM x BN output
// tile (128 x 128, or 64 x 64 / 32 x 64 when M is small, so that a
// package of ~50 rows still puts enough blocks on the 132 SMs; the
// wrapper's `tile_for` picks it and passes it here). Threads form a
// 16 x 16 grid; each keeps a TM x TN register micro-tile (8 x 8 at
// 128 x 128) laid out as four quadrants, rows {ty*TM/2 + i} and
// {BM/2 + ty*TM/2 + i}, columns likewise, so each step reads its A and B
// values as contiguous vectors (float4 at 8 x 8) and the 16 threads of a
// half-warp read 16 distinct vectors: no bank conflict. Per step of
// BK = 16 k values the block stages A transposed (As[k][m], 4-byte
// cp.async copies) and B as it lies (Bs[k][n], 16-byte cp.async copies
// when N is a multiple of 4 and B 16-byte aligned, else 4-byte ones) in a
// double buffer: the copies of slice t+1 are in flight while slice t
// multiplies. Every ragged edge (M, N and K) is masked: rows and columns
// past the edge are zero-filled by the copy's source size, the last K
// slice runs only its real k values, and stores are guarded, so the
// wrapper pads nothing (the TPU version pads to block multiples). Under
// USM, A and B are host memory mapped into the device, so every tile that
// misses L2 crosses PCIe.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int THREADS = 256;   // a 16 x 16 thread grid
constexpr int BK = 16;
constexpr int PAD = 4;         // As row pad: keeps rows 16-byte aligned

// n contiguous floats from shared memory (n = 1, 2 or 4, aligned to n).
template <int N>
__device__ __forceinline__ void load_vec(float* r, const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = p[0];
  }
}

template <int BM, int BN>
struct Tile {
  float As[2][BK][BM + PAD];
  float Bs[2][BK][BN];
};

template <int BM, int BN>
__device__ __forceinline__ void load_slice(Tile<BM, BN>& s, int buf,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           long long m0, int n0, int k0,
                                           int M, int N, int K, bool vec_b) {
  const int tid = threadIdx.x;
  // A: element e is (row e / BK, k e % BK), so a warp reads whole 64-byte
  // runs of two rows; stored transposed
#pragma unroll
  for (int e = tid; e < BM * BK; e += THREADS) {
    const int r = e / BK, kk = e % BK;
    const long long gm = m0 + r;
    const int gk = k0 + kk;
    const bool ok = gm < M && gk < K;
    cp_async4(&s.As[buf][kk][r], ok ? A + gm * K + gk : A, ok ? 4 : 0);
  }
  if (vec_b) {
    constexpr int V = BN / 4;   // float4 per row of the slice
#pragma unroll
    for (int e = tid; e < BK * V; e += THREADS) {
      const int kk = e / V, c = (e % V) * 4;
      const int gk = k0 + kk, gn = n0 + c;
      const bool ok = gk < K && gn < N;   // N % 4 == 0: all or nothing
      cp_async16(&s.Bs[buf][kk][c], ok ? B + (long long)gk * N + gn : B,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async4(&s.Bs[buf][kk][c], ok ? B + (long long)gk * N + gn : B,
                ok ? 4 : 0);
    }
  }
}

template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void step(const Tile<BM, BN>& s, int buf, int kk,
                                     int ty, int tx, float (&acc)[TM][TN]) {
  constexpr int HM = TM / 2, HN = TN / 2;
  float a[TM], b[TN];
  load_vec<HM>(a, &s.As[buf][kk][ty * HM]);
  load_vec<HM>(a + HM, &s.As[buf][kk][BM / 2 + ty * HM]);
  load_vec<HN>(b, &s.Bs[buf][kk][tx * HN]);
  load_vec<HN>(b + HN, &s.Bs[buf][kk][BN / 2 + tx * HN]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K, int vec_b) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int HM = TM / 2, HN = TN / 2;
  static_assert(TM >= 2 && TN >= 2 && TM <= 8 && TN <= 8, "micro-tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile<BM, BN>& s = *reinterpret_cast<Tile<BM, BN>*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int slices = (K + BK - 1) / BK;
  if (slices > 0) load_slice(s, 0, A, B, m0, n0, 0, M, N, K, vec_b);
  cp_async_commit();
  for (int t = 0; t < slices; ++t) {
    const int buf = t & 1;
    if (t + 1 < slices) {
      load_slice(s, buf ^ 1, A, B, m0, n0, (t + 1) * BK, M, N, K, vec_b);
      cp_async_commit();
      cp_async_wait<1>();          // slice t has landed, t + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kmax = min(BK, K - t * BK);
    if (kmax == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        step<BM, BN, TM, TN>(s, buf, kk, ty, tx, acc);
    } else {                       // the ragged last slice: real k only
      for (int kk = 0; kk < kmax; ++kk)
        step<BM, BN, TM, TN>(s, buf, kk, ty, tx, acc);
    }
    __syncthreads();               // buf is free for slice t + 2
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm =
        m0 + (i < HM ? ty * HM + i : BM / 2 + ty * HM + i - HM);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * (BN / 2) + tx * HN;
      float* out = C + gm * N + gn;
      if constexpr (HN == 4) {
        if (vec_b && gn + 3 < N) {
          *reinterpret_cast<float4*>(out) = make_float4(
              acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
              acc[i][h * 4 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < HN; ++j)
        if (gn + j < N) out[j] = acc[i][h * HN + j];
    }
  }
}

template <int BM, int BN>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           int vec_b, cudaStream_t stream) {
  const int bytes = (int)sizeof(Tile<BM, BN>);
  cudaError_t err = cudaFuncSetAttribute(
      sgemm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  sgemm_kernel<BM, BN><<<grid, THREADS, bytes, stream>>>(a, b, c, M, N, K,
                                                         vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// tile_m x tile_n is one of 128 x 128, 64 x 64, 32 x 64 (kernels/matmul.py
// `tile_for`); any other is refused.
extern "C" int matmul_f32(const void* a, const void* b, void* c, int M, int N,
                          int K, int tile_m, int tile_n, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  // float4 copies of B and stores of C need every row 16-byte aligned
  const int vec_b = N % 4 == 0 && ((uintptr_t)b & 15) == 0 &&
                    ((uintptr_t)c & 15) == 0;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* C = (float*)c;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_m == 128 && tile_n == 128)
    return launch<128, 128>(A, B, C, M, N, K, vec_b, s);
  if (tile_m == 64 && tile_n == 64)
    return launch<64, 64>(A, B, C, M, N, K, vec_b, s);
  if (tile_m == 32 && tile_n == 64)
    return launch<32, 64>(A, B, C, M, N, K, vec_b, s);
  return (int)cudaErrorInvalidValue;
}
