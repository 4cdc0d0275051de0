// Separable 5x5 Gaussian blur over a row range (paper benchmark: Gaussian).
//
// Replaces the Pallas kernel repro/kernels/gaussian.py `_blur_kernel`
// (reached through `_blur_blocks` from `gaussian_blur` and
// `gaussian_blur_halo`): taps [1,4,6,4,1]/16, vertical pass then
// horizontal pass, zero padding at the image edges.
//
// Geometry. The logical input is `lo_pad` zero rows, the `src_rows` x W
// source, then zero rows up to `out_rows + 4` rows; output row r is the
// blur centred on logical row r + 2. The halo entry point (an (H+4, W)
// chunk that already holds its 2+2 context rows) is lo_pad = 0; a package
// read in place from the whole image passes only the rows that exist and
// says how many are missing, so edge packages need no zero-filled copy.
//
// Bound on an H100: bytes. 10 multiply-adds per pixel against 8 bytes, so
// the card's memory rate decides. Design: one 32x32 output tile per block;
// the block loads its (32+4) x (32+4) input window once into shared memory
// (the TPU version built five row-shifted copies because its blocks cannot
// overlap), runs the vertical pass into a second shared tile and the
// horizontal pass from there. Each sum is written with __fmul_rn/__fadd_rn
// in the plain version's order, so the kernel equals it bit for bit.
#include <cuda_runtime.h>

#define TW 32
#define TH 32

__device__ __forceinline__ float taps5(float a, float b, float c, float d,
                                       float e) {
  float s = __fmul_rn(0.0625f, a);
  s = __fadd_rn(s, __fmul_rn(0.25f, b));
  s = __fadd_rn(s, __fmul_rn(0.375f, c));
  s = __fadd_rn(s, __fmul_rn(0.25f, d));
  return __fadd_rn(s, __fmul_rn(0.0625f, e));
}

__global__ void gaussian_rows_kernel(const float* __restrict__ src,
                                     long long src_rows, int W,
                                     long long lo_pad, float* __restrict__ out,
                                     long long out_rows) {
  __shared__ float tile[TH + 4][TW + 4];
  __shared__ float vert[TH][TW + 4];
  const long long r0 = (long long)blockIdx.x * TH;
  const int c0 = blockIdx.y * TW;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;

  for (int e = tid; e < (TH + 4) * (TW + 4); e += nth) {
    int lr = e / (TW + 4), lc = e % (TW + 4);
    long long sr = r0 + lr - lo_pad;
    int c = c0 + lc - 2;
    float v = 0.0f;
    if (sr >= 0 && sr < src_rows && c >= 0 && c < W) v = src[sr * W + c];
    tile[lr][lc] = v;
  }
  __syncthreads();
  for (int e = tid; e < TH * (TW + 4); e += nth) {
    int lr = e / (TW + 4), lc = e % (TW + 4);
    vert[lr][lc] = taps5(tile[lr][lc], tile[lr + 1][lc], tile[lr + 2][lc],
                         tile[lr + 3][lc], tile[lr + 4][lc]);
  }
  __syncthreads();
  for (int e = tid; e < TH * TW; e += nth) {
    int lr = e / TW, lc = e % TW;
    long long r = r0 + lr;
    int c = c0 + lc;
    if (r < out_rows && c < W)
      out[r * W + c] = taps5(vert[lr][lc], vert[lr][lc + 1], vert[lr][lc + 2],
                             vert[lr][lc + 3], vert[lr][lc + 4]);
  }
}

extern "C" int gaussian_rows_f32(const void* src, long long src_rows, int W,
                                 long long lo_pad, void* out,
                                 long long out_rows, void* stream) {
  if (out_rows <= 0 || W <= 0) return 0;
  dim3 block(32, 8);
  dim3 grid((unsigned)((out_rows + TH - 1) / TH), (unsigned)((W + TW - 1) / TW));
  gaussian_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, src_rows, W, lo_pad, (float*)out, out_rows);
  return (int)cudaGetLastError();
}
