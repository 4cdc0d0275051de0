// C = A @ B in f32 with f32 accumulation (paper benchmark: MatMul).
//
// Replaces the Pallas kernel repro/kernels/matmul.py `matmul`
// (body `_matmul_kernel`): a tiled product whose K loop accumulates in an
// f32 scratch tile.
//
// Bound on an H100: operations. At the main path's sizes (a row block of
// A against the whole 4864 x 4864 B) the product does 2*M*N*K FLOP over
// (M*K + K*N + M*N) * 4 bytes, hundreds of FLOP per byte, so the f32 rate
// of the CUDA cores (67 TFLOP/s on the SXM part) is the ceiling; TF32 and
// the tensor cores stay off to keep f32 parity with the reference.
// Design: the classic shared-memory SIMT tiling. Each 256-thread block owns
// a 64 x 64 output tile, stages 64 x 16 of A and 16 x 64 of B per step in
// shared memory, and each thread keeps a 4 x 4 register micro-tile that it
// updates with FMAs in ascending k. Every ragged edge (M, N and K) is
// masked on load and store, so the wrapper pads nothing (the TPU version
// pads to block multiples).
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16

__global__ void __launch_bounds__(256)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int e = tid + l * 256;
      int ar = e / BK, ac = e % BK;
      long long gm = m0 + ar;
      int gk = k0 + ac;
      As[ac][ar] = (gm < M && gk < K) ? A[gm * K + gk] : 0.0f;
      int br = e / BN, bc = e % BN;
      int gkb = k0 + br, gn = n0 + bc;
      Bs[br][bc] = (gkb < K && gn < N) ? B[(long long)gkb * N + gn] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn < N) C[gm * N + gn] = acc[i][j];
    }
  }
}

extern "C" int matmul_f32(const void* a, const void* b, void* c, int M, int N,
                          int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  matmul_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}
