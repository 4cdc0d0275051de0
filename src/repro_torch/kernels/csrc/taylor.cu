// Taylor-series sine (paper benchmark: Taylor).
//
// Replaces the Pallas kernel repro/kernels/taylor.py `taylor_sin`
// (body `_taylor_kernel`): acc += term; term = -term * x^2 / ((2k+2)(2k+3))
// for `terms` steps, in f32. The result equals the plain PyTorch version
// bit for bit, for every input.
//
// Bound on an H100: bytes (8 per element) at 3.35 TB/s; at 1e6 elements
// that is 0.0024 ms, under the launch and DRAM latency that also hold
// `torch.sin` at ~0.009 ms.
//
// What held the first version back (one element per thread, `terms` a
// runtime loop, IEEE `__fdiv_rn` per step) was the division, measured by
// chip_smoke.py's probe on an H100 80GB HBM3 at 700 W: 1 term took the
// memory-and-launch floor of `torch.sin` (0.0096 ms at 1e6 elements), 12
// terms 0.0347 ms, and 12 terms on x in [1, 2] 0.0171 ms. `__fdiv_rn` is a
// reciprocal, Newton steps and FCHK, which sends a lane to a slow-path call
// when the quotient leaves the normal range; for |x| below about 0.3 the
// late terms do, and nearly every warp of a random x holds such a lane.
// That path took half the time, the division's ~10 instructions per step
// most of the rest (456 SASS instructions, 6 FCHK and 7 CALL).
//
// Design. The main path asks for 12 terms, which the TPU kernel also
// makes static, so `taylor_series<12>` unrolls them and its divisors
// 6, 20, ..., 600 become constants. Each division n / d becomes
// q = RN(n * RN(1/d)) corrected by one FMA, q' = RN(q + RN(n - q d) RN(1/d))
// (Markstein). For each of these 12 divisors q' equals the correctly
// rounded n / d for every normal significand (checked exactly on the CPU
// in tests/test_torch_kernels.py, and the whole function is held to the
// plain version on all 2^32 inputs on the card by chip_smoke.py); an
// infinite n keeps q, where the correction would form inf - inf. There is
// no slow path and no branch. Each thread takes 4 elements as one 16-byte
// load and store (4 independent chains) over a grid sized to the SMs;
// views at any element offset peel up to 3 elements to 16-byte alignment
// when x and y share it, and otherwise run element by element. Any other
// term count runs the runtime-loop kernel with `__fdiv_rn`.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;       // 2048 threads, a full SM
constexpr int UNROLLED_TERMS = 12;     // the main path's count (ops.py)

// RN(1 / ((2k+2)(2k+3))) for k = 0 ... 11
__device__ __forceinline__ float reciprocal(int k) {
  switch (k) {
    case 0: return 0x1.555556p-3f;    // 1/6
    case 1: return 0x1.99999ap-5f;    // 1/20
    case 2: return 0x1.861862p-6f;    // 1/42
    case 3: return 0x1.c71c72p-7f;    // 1/72
    case 4: return 0x1.29e412p-7f;    // 1/110
    case 5: return 0x1.a41a42p-8f;    // 1/156
    case 6: return 0x1.381382p-8f;    // 1/210
    case 7: return 0x1.e1e1e2p-9f;    // 1/272
    case 8: return 0x1.7f4060p-9f;    // 1/342
    case 9: return 0x1.381382p-9f;    // 1/420
    case 10: return 0x1.03091cp-9f;   // 1/506
    default: return 0x1.b4e81cp-10f;  // 1/600
  }
}

// RN(n / d_k) without a division: see the note above
__device__ __forceinline__ float divide_step(float n, int k) {
  const float d = (float)((2 * k + 2) * (2 * k + 3));
  const float r = reciprocal(k);
  const float q = __fmul_rn(n, r);
  const float c = __fmaf_rn(__fmaf_rn(-q, d, n), r, q);
  return isinf(q) ? q : c;
}

template <int TERMS>
__device__ __forceinline__ float taylor_series(float x) {
  const float x2 = __fmul_rn(x, x);
  float acc = 0.0f;
  float term = x;
#pragma unroll
  for (int k = 0; k < TERMS; ++k) {
    acc = __fadd_rn(acc, term);
    term = divide_step(__fmul_rn(-term, x2), k);
  }
  return acc;
}

// head: elements before x's first 16-byte boundary (y shares it);
// vec == 0: x and y are misaligned against each other, element by element
template <int TERMS>
__global__ void __launch_bounds__(THREADS)
taylor_unrolled_kernel(const float* __restrict__ x, float* __restrict__ y,
                       long long n, int head, int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (!vec) {
    for (long long i = tid; i < n; i += stride)
      y[i] = taylor_series<TERMS>(x[i]);
    return;
  }
  if (tid < head) y[tid] = taylor_series<TERMS>(x[tid]);
  const long long nv = (n - head) / 4;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  for (long long i = tid; i < nv; i += stride) {
    float4 a = xv[i];
    a.x = taylor_series<TERMS>(a.x);
    a.y = taylor_series<TERMS>(a.y);
    a.z = taylor_series<TERMS>(a.z);
    a.w = taylor_series<TERMS>(a.w);
    yv[i] = a;
  }
  const long long t0 = head + 4 * nv;
  if (tid < n - t0) y[t0 + tid] = taylor_series<TERMS>(x[t0 + tid]);
}

// any other term count: a runtime loop with IEEE division
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

long long grid_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;      // grid-stride beyond this
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" int taylor_sin_f32(const void* x, void* y, long long n, int terms,
                              void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (terms != UNROLLED_TERMS) {
    taylor_sin_kernel<<<(unsigned)grid_for(n), THREADS, 0, s>>>(
        (const float*)x, (float*)y, n, terms);
    return (int)cudaGetLastError();
  }
  const uintptr_t ax = (uintptr_t)x, ay = (uintptr_t)y;
  const int vec = ((ax ^ ay) & 15) == 0 && (ax & 3) == 0;
  long long head = vec ? (long long)(((16 - (ax & 15)) & 15) / 4) : 0;
  if (head > n) head = n;
  const long long work = vec ? (n - head) / 4 : n;
  taylor_unrolled_kernel<UNROLLED_TERMS>
      <<<(unsigned)grid_for(work), THREADS, 0, s>>>(
          (const float*)x, (float*)y, n, (int)head, vec);
  return (int)cudaGetLastError();
}
