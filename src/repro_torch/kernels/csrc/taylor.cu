// Taylor-series sine, one thread per element (paper benchmark: Taylor).
//
// Replaces the Pallas kernel repro/kernels/taylor.py `taylor_sin`
// (body `_taylor_kernel`): acc += term; term = -term * x^2 / ((2k+2)(2k+3))
// for `terms` steps, in f32.
//
// Bound on an H100: bytes. At 12 terms the kernel does ~40 f32 operations
// per element against 8 bytes moved (one read, one write), far below the
// card's ~20 FLOP/byte ridge for f32 on CUDA cores, so it runs at memory
// rate plus launch latency. Design: a grid-stride loop of coalesced 4-byte
// loads and stores; the ragged tail is masked by the loop bound, so the
// wrapper pads nothing (the TPU version pads to (rows, 128) tiles). The
// IEEE division stays (nvcc's default --prec-div=true) so the result
// equals the plain PyTorch version operation for operation.
#include <cuda_runtime.h>

__global__ void taylor_sin_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, long long n,
                                  int terms) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float xv = x[i];
    float x2 = __fmul_rn(xv, xv);
    float acc = 0.0f;
    float term = xv;
    for (int k = 0; k < terms; ++k) {
      acc = __fadd_rn(acc, term);
      float denom = (2.0f * k + 2.0f) * (2.0f * k + 3.0f);
      term = __fdiv_rn(__fmul_rn(-term, x2), denom);
    }
    y[i] = acc;
  }
}

extern "C" int taylor_sin_f32(const void* x, void* y, long long n, int terms,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  taylor_sin_kernel<<<(unsigned)blocks, threads, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n,
                                              terms);
  return (int)cudaGetLastError();
}
