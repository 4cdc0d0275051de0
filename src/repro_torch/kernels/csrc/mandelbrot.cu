// Mandelbrot escape counts, one lane per point (paper benchmark:
// Mandelbrot).
//
// Replaces the Pallas kernel repro/kernels/mandelbrot.py `mandelbrot`
// (body `_mandel_kernel`): per point c = cre + i*cim, iterate z <- z^2 + c
// from z = 0 while |z|^2 <= 4 (tested before the update), at most
// `max_iter` times, and return the number of updates as f32.
//
// Bound on an H100: issue slots. A point reads 8 bytes and writes 4, but
// runs up to max_iter steps of 9 f32 operations (zr*zr, zi*zi, their sum,
// the test, zr2 - zi2, + cre, 2*zr, * zi, + cim), every one a separate
// round-to-nearest op: fused into FMAs, `zr2 - zi2 + cre` and
// `2*zr*zi + cim` would move boundary points by an iteration, and the
// counts must equal the plain PyTorch version exactly. Unfused, each op
// takes an issue slot of its own, and the card issues at most 132 SMs x
// 128 lanes x 1.98 GHz = 33.5e12 of them a second. At the paper's Table 1
// size (a 7030 x 10000 grid over the classic viewport) the points run
// 1,096,156,026 steps, 0.30 ms of issue, above the 0.25 ms its 12 bytes a
// point take at 3.35 TB/s.
//
// What held the first version back (one thread per point that left its
// loop on its own escape; chip_smoke.py's probe on an H100 80GB HBM3 at
// 700 W): where every point runs all 64 steps it spent 14.7 issue slots a
// warp step on the 9 ops, with a data-dependent break and its divergence
// bookkeeping, a float counter, and a loop counter with its own compare
// and branch; and a block of 8 warps held its SM slots until its slowest
// warp was done.
//
// Design. A lane keeps a sticky `alive` predicate, AND-ed with
// |z|^2 <= 4 at every step, and an integer count incremented under it; the
// count becomes f32 once, at the store (exact below 2^24 steps). Steps run
// in groups of U = kUnroll between warp votes (__any_sync), so a warp
// still leaves once all its 32 points have escaped, at U-step granularity:
// that per-warp early exit is the irregularity the dynamic schedulers feed
// on (the TPU version leaves a whole block once all its lanes escaped).
// A group is PTX that keeps the predicate in a register from step to step
// (from C++, nvcc carried `alive` as an integer and spent 2-3 more slots a
// step on it), and the main path's budget of 64 unrolls into 16 groups
// with no loop counter: 10 slots a step and 4 a group (the vote, its
// branch and divergence check). Escaped lanes run on with the warp: their
// z grows into inf and NaN, NaN <= 4 is false, and the sticky predicate
// keeps them counted out; their z is never read. Any other budget runs a
// loop of groups and ends in single steps, each after its own vote. U = 4
// gives the fewest slots over the Table 1 grid's warps (their steps
// rounded up to whole groups, against a vote per group), and was the
// fastest of U = 1, 2, 4 and 8 there on an H100 (PERF.md). Each warp walks
// chunks of 32 consecutive points a grid-stride apart, with the next
// chunk's c loaded while this one runs. In device memory the grid is 8
// blocks of 256 threads per SM, so a warp whose points escaped takes its
// next chunk at once instead of idling in its block. Mapped host memory
// (the USM plane's arrays) is read over PCIe, and there a grid of one
// chunk per warp reads faster (chip_smoke.py's launch-shape probe times
// both shapes on both kinds of memory). Lanes past n take part in the
// votes with `alive` false.
#include <cuda_runtime.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;       // 2048 threads, a full SM
constexpr int kUnroll = 4;
constexpr int kMainIter = 64;          // the main path's budget (ops.py;
                                       // a test holds the two equal)
constexpr unsigned FULL = 0xffffffffu;

// One step in PTX, in the plain version's order: test |z|^2 <= 4 into the
// sticky predicate p, count under it, then update z. Every op carries .rn,
// which keeps ptxas from contracting it into an FMA. Operands: %0 zr,
// %1 zi, %2 count, %3 alive (0 or 1), %4 cre, %5 cim.
#define MANDEL_STEP                       \
  "mul.rn.f32 m_zr2, %0, %0;\n\t"          \
  "mul.rn.f32 m_zi2, %1, %1;\n\t"          \
  "add.rn.f32 m_s, m_zr2, m_zi2;\n\t"      \
  "setp.le.and.f32 m_p, m_s, 0f40800000, m_p;\n\t" \
  "@m_p add.s32 %2, %2, 1;\n\t"           \
  "sub.rn.f32 m_t, m_zr2, m_zi2;\n\t"      \
  "mul.rn.f32 m_u, %0, 0f40000000;\n\t"    \
  "mul.rn.f32 m_u, m_u, %1;\n\t"           \
  "add.rn.f32 %1, m_u, %5;\n\t"            \
  "add.rn.f32 %0, m_t, %4;\n\t"
#define MANDEL_STEPS2 MANDEL_STEP MANDEL_STEP
#define MANDEL_STEPS4 MANDEL_STEPS2 MANDEL_STEPS2
#define MANDEL_STEPS8 MANDEL_STEPS4 MANDEL_STEPS4
#define MANDEL_GROUP(STEPS)                                              \
  asm("{\n\t"                                                             \
      ".reg .pred m_p;\n\t"                                               \
      ".reg .f32 m_zr2, m_zi2, m_s, m_t, m_u;\n\t"                        \
      "setp.ne.u32 m_p, %3, 0;\n\t" STEPS "selp.u32 %3, 1, 0, m_p;\n\t"   \
      "}"                                                                 \
      : "+f"(zr), "+f"(zi), "+r"(count), "+r"(alive)                      \
      : "f"(cr), "f"(ci))

// U steps, the predicate in a register between them.
template <int U>
__device__ __forceinline__ void steps(float& zr, float& zi, int& count,
                                      int& alive, float cr, float ci) {
  static_assert(U == 1 || U == 2 || U == 4 || U == 8, "unroll 1, 2, 4, 8");
  if constexpr (U == 1) MANDEL_GROUP(MANDEL_STEP);
  if constexpr (U == 2) MANDEL_GROUP(MANDEL_STEPS2);
  if constexpr (U == 4) MANDEL_GROUP(MANDEL_STEPS4);
  if constexpr (U == 8) MANDEL_GROUP(MANDEL_STEPS8);
}

// The steps of one point (lanes past n come in with `in` false), MAX > 0:
// a budget of MAX known here, its groups unrolled; MAX = 0: max_iter.
template <int U, int MAX>
__device__ __forceinline__ int count_steps(float cr, float ci, bool in,
                                           int max_iter) {
  float zr = 0.0f, zi = 0.0f;
  int count = 0, alive = in;
  if constexpr (MAX > 0) {
    static_assert(MAX % U == 0, "the unrolled budget is whole groups");
#pragma unroll
    for (int g = 0; g < MAX / U; ++g) {
      if (!__any_sync(FULL, alive)) break;
      steps<U>(zr, zi, count, alive, cr, ci);
    }
  } else {
    int left = max_iter;
    for (; left >= U && __any_sync(FULL, alive); left -= U)
      steps<U>(zr, zi, count, alive, cr, ci);
    if (left < U) {    // the budget's last max_iter % U steps
      for (; left > 0 && __any_sync(FULL, alive); --left)
        steps<1>(zr, zi, count, alive, cr, ci);
    }
  }
  return count;
}

// Each warp walks chunks of 32 consecutive points, a grid-stride apart,
// with the next chunk's c loaded while this one runs.
template <int MAX>
__device__ __forceinline__ void walk(const float* __restrict__ cre,
                                     const float* __restrict__ cim,
                                     float* __restrict__ out, long long n,
                                     int max_iter) {
  const int lane = threadIdx.x & 31;
  const long long chunks = (n + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  long long chunk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  long long i = chunk * 32 + lane;
  float cr = 0.0f, ci = 0.0f;
  if (i < n) {
    cr = cre[i];
    ci = cim[i];
  }
  for (; chunk < chunks; chunk += stride) {
    const long long next = i + stride * 32;
    float ncr = 0.0f, nci = 0.0f;
    if (next < n) {
      ncr = cre[next];
      nci = cim[next];
    }
    const int count = count_steps<kUnroll, MAX>(cr, ci, i < n, max_iter);
    if (i < n) out[i] = (float)count;
    i = next;
    cr = ncr;
    ci = nci;
  }
}

__global__ void __launch_bounds__(THREADS)
    mandelbrot_kernel(const float* __restrict__ cre,
                      const float* __restrict__ cim, float* __restrict__ out,
                      long long n, int max_iter) {
  if (max_iter == kMainIter)
    walk<kMainIter>(cre, cim, out, n, max_iter);
  else
    walk<0>(cre, cim, out, n, max_iter);
}

}  // namespace

extern "C" int mandelbrot_f32(const void* cre, const void* cim, void* out,
                              long long n, int max_iter, void* stream) {
  if (n <= 0) return 0;
  long long blocks = ((n + 31) / 32 + WARPS - 1) / WARPS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  // in device memory, a grid the card holds at once whose warps take
  // turns; over PCIe (mapped host memory), a chunk per warp
  if (blocks > cap && on_device(cre) && on_device(cim) && on_device(out))
    blocks = cap;
  mandelbrot_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)cre, (const float*)cim, (float*)out, n, max_iter);
  return (int)cudaGetLastError();
}
