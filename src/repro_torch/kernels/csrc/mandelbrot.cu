// Mandelbrot escape counts, one thread per point (paper benchmark:
// Mandelbrot).
//
// Replaces the Pallas kernel repro/kernels/mandelbrot.py `mandelbrot`
// (body `_mandel_kernel`): per point c = cre + i*cim, iterate z <- z^2 + c
// from z = 0 while |z|^2 <= 4 (tested before the update), at most
// `max_iter` times, and return the number of updates as f32.
//
// Bound on an H100: operations, and data dependent. Each point reads 8
// bytes and writes 4, then runs up to max_iter steps of ~8 f32 operations;
// interior points run all of them, background points leave after a few.
// Design: one thread per point that leaves its loop as soon as its own
// point escapes, so a warp retires once its 32 points have escaped. That
// per-warp early exit is the irregularity the dynamic schedulers feed on
// (the TPU version leaves a whole block once all its lanes escaped). Every
// update is written with __fmul_rn/__fadd_rn/__fsub_rn: nvcc would
// otherwise fuse `zr2 - zi2 + cre` and `2*zr*zi + cim` into FMAs and move
// boundary points by an iteration, and the counts must equal the plain
// PyTorch version exactly.
#include <cuda_runtime.h>

__global__ void mandelbrot_kernel(const float* __restrict__ cre,
                                  const float* __restrict__ cim,
                                  float* __restrict__ out, long long n,
                                  int max_iter) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cr = cre[i], ci = cim[i];
  float zr = 0.0f, zi = 0.0f, it = 0.0f;
  for (int k = 0; k < max_iter; ++k) {
    float zr2 = __fmul_rn(zr, zr);
    float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.0f)) break;
    float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zr), zi), ci);
    zr = nzr;
    zi = nzi;
    it = __fadd_rn(it, 1.0f);
  }
  out[i] = it;
}

extern "C" int mandelbrot_f32(const void* cre, const void* cim, void* out,
                              long long n, int max_iter, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  mandelbrot_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cre, (const float*)cim, (float*)out, n, max_iter);
  return (int)cudaGetLastError();
}
