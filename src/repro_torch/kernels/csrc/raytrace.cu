// Ray-sphere nearest-hit Lambert shading (paper benchmark: Ray).
//
// Replaces the Pallas kernel repro/kernels/raytrace.py `raytrace` (body
// `_ray_kernel`): for each unit ray d from the origin and each sphere
// [cx, cy, cz, r, albedo] in table order, b = d.c, disc = b*b - (|c|^2 -
// r*r), t = b - sqrt(max(disc, 0)); a hit needs disc > 0, t > 1e-3 and t
// below the nearest hit so far, and shades albedo * max(0, (n.light) / r)
// with n = t*d - c and light (0.577, 0.577, 0.577). Rays that hit nothing
// give 0.
//
// Bound on an H100: bytes. A ray reads 12 bytes and writes 4: 0.0449 ms for
// the Table 1 size over 3.35 TB/s. The operations the function needs (8 a
// ray and sphere, 10 more where disc > 0, 14 a hit, as chip_smoke.py counts
// them) take half that at the card's unfused f32 issue rate.
//
// What held the first version back was issue (chip_smoke.py's probe on an
// H100 80GB HBM3 at 700 W): one ray a thread took the IEEE root of every ray
// and sphere, with the table row read from shared memory each time, so the
// scene moved out of view, where no pair has disc > 0, took 0.121 ms, as
// long as the scene itself (0.124 ms).
//
// Design. Only a pair with disc > 0 can hit, and 7.2 % of the Table 1
// scene's pairs have it. A thread takes kRays consecutive rays with one
// 16-byte load of each of dx, dy, dz and one 16-byte store (independent
// chains; the next rays' loads are issued before these are shaded), and for
// each sphere computes b and disc for its rays; the root, t and the hit
// tests run only when a warp vote finds a lane with disc > 0, which skips
// them for most (warp, sphere) pairs of the Table 1 scene. Skipping them
// changes no bit: where disc <= 0 the hit test fails whatever t is. The main
// path's scene of kMainSpheres spheres runs an instantiation with the
// sphere loop unrolled; any other count keeps a runtime loop. The table is
// a BROADCAST argument, which under USM lies in mapped host memory, so each
// block reads it once into shared memory, rows of 8 floats (cx, cy, cz,
// |c|^2 - r^2, 1/max(r, 1e-6), albedo and 2 of padding: two 16-byte
// reads), and the grid is sized to the blocks the SMs hold, striding over
// the rays. Views at any element offset peel up to 3 rays to a 16-byte
// boundary when dx, dy, dz and out share it, and otherwise run ray by ray.
// The same launch shape serves device memory and mapped host memory. It
// takes 1.05-1.08x a device copy of its bytes (chip_smoke.py's probe, an
// H100 80GB HBM3 at 700 W).
// Every operation is written with __fmul_rn/__fadd_rn/__fsub_rn and
// __fsqrt_rn/__fdiv_rn in the plain PyTorch version's order: nvcc would
// otherwise contract the dot products and b*b - c into FMAs, move disc by
// an ulp and flip hits at sphere silhouettes, where the shade is not small.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int kThreads = 256;
constexpr int kMaxSpheres = 2048;
constexpr int kMainSpheres = 8;     // demo_spheres()' default: unrolled
constexpr int kRays = 4;            // consecutive rays a thread shades
constexpr unsigned kFull = 0xffffffffu;

// One sphere's table row: (cx, cy, cz, |c|^2 - r^2), (1/max(r, eps),
// albedo, 0, 0).
struct Sphere {
  float4 c;
  float4 s;
};

// Shade R rays against one sphere. VOTE: the warp's 32 lanes all take
// part and skip the root together when none of their rays has disc > 0.
template <int R, bool VOTE>
__device__ __forceinline__ void sphere_pass(const float (&x)[R],
                                            const float (&y)[R],
                                            const float (&z)[R],
                                            float (&best_t)[R],
                                            float (&shade)[R],
                                            const Sphere& sp) {
  const float light = 0.577f;
  float b[R], disc[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    b[r] = __fadd_rn(__fadd_rn(__fmul_rn(x[r], sp.c.x),
                               __fmul_rn(y[r], sp.c.y)),
                     __fmul_rn(z[r], sp.c.z));
    disc[r] = __fsub_rn(__fmul_rn(b[r], b[r]), sp.c.w);
    any |= disc[r] > 0.0f;
  }
  if (VOTE ? !__any_sync(kFull, any) : !any) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!(disc[r] > 0.0f)) continue;
    // disc > 0 is its own max with 0
    const float t = __fsub_rn(b[r], __fsqrt_rn(disc[r]));
    if (t > 1e-3f && t < best_t[r]) {
      const float nx = __fsub_rn(__fmul_rn(x[r], t), sp.c.x);
      const float ny = __fsub_rn(__fmul_rn(y[r], t), sp.c.y);
      const float nz = __fsub_rn(__fmul_rn(z[r], t), sp.c.z);
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(nx, light),
                                            __fmul_rn(ny, light)),
                                  __fmul_rn(nz, light));
      best_t[r] = t;
      shade[r] = __fmul_rn(sp.s.y, fmaxf(0.0f, __fmul_rn(dot, sp.s.x)));
    }
  }
}

// R rays against the scene (S > 0: exactly S spheres, unrolled)
template <int S, int R, bool VOTE>
__device__ __forceinline__ void shade_rays(const float (&x)[R],
                                           const float (&y)[R],
                                           const float (&z)[R],
                                           float (&shade)[R],
                                           const Sphere* table, int num) {
  float best_t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = __int_as_float(0x7f800000);  // +inf
    shade[r] = 0.0f;
  }
  if (S > 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      sphere_pass<R, VOTE>(x, y, z, best_t, shade, table[s]);
  } else {
#pragma unroll 1
    for (int s = 0; s < num; ++s)
      sphere_pass<R, VOTE>(x, y, z, best_t, shade, table[s]);
  }
}

template <int S>
__device__ __forceinline__ void shade_one(const float* dx, const float* dy,
                                          const float* dz, float* out,
                                          long long i, const Sphere* table,
                                          int num) {
  const float x[1] = {dx[i]}, y[1] = {dy[i]}, z[1] = {dz[i]};
  float shade[1];
  shade_rays<S, 1, false>(x, y, z, shade, table, num);
  out[i] = shade[0];
}

// head: rays before dx's first 16-byte boundary (dy, dz and out share it);
// vec == 0: the four are misaligned against each other, ray by ray
template <int S>
__global__ void __launch_bounds__(kThreads)
raytrace_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                const float* __restrict__ dz,
                const float* __restrict__ spheres, int num,
                float* __restrict__ out, long long n, int head, int vec) {
  extern __shared__ Sphere table[];
  for (int s = threadIdx.x; s < num; s += blockDim.x) {
    const float cx = spheres[5 * s + 0], cy = spheres[5 * s + 1];
    const float cz = spheres[5 * s + 2], r = spheres[5 * s + 3];
    const float c = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(cx, cx),
                                                  __fmul_rn(cy, cy)),
                                        __fmul_rn(cz, cz)),
                              __fmul_rn(r, r));
    table[s].c = make_float4(cx, cy, cz, c);
    table[s].s = make_float4(__fdiv_rn(1.0f, fmaxf(r, 1e-6f)),
                             spheres[5 * s + 4], 0.0f, 0.0f);
  }
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (!vec) {
    for (long long i = tid; i < n; i += stride)
      shade_one<S>(dx, dy, dz, out, i, table, num);
    return;
  }
  if (tid < head) shade_one<S>(dx, dy, dz, out, tid, table, num);
  const long long nv = (n - head) / kRays;
  const float4* xv = reinterpret_cast<const float4*>(dx + head);
  const float4* yv = reinterpret_cast<const float4*>(dy + head);
  const float4* zv = reinterpret_cast<const float4*>(dz + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // every lane of a warp takes the same turns, so each vote sees all 32
  long long i = tid;
  float4 nx = i < nv ? xv[i] : none, ny = i < nv ? yv[i] : none,
         nz = i < nv ? zv[i] : none;
  for (long long w = tid - (threadIdx.x & 31); w < nv; w += stride) {
    const float x[kRays] = {nx.x, nx.y, nx.z, nx.w};
    const float y[kRays] = {ny.x, ny.y, ny.z, ny.w};
    const float z[kRays] = {nz.x, nz.y, nz.z, nz.w};
    const long long j = i + stride;
    if (j < nv) {
      nx = xv[j];
      ny = yv[j];
      nz = zv[j];
    }
    float shade[kRays];
    shade_rays<S, kRays, true>(x, y, z, shade, table, num);
    if (i < nv) ov[i] = make_float4(shade[0], shade[1], shade[2], shade[3]);
    i = j;
  }
  const long long t0 = head + kRays * nv;
  if (tid < n - t0) shade_one<S>(dx, dy, dz, out, t0 + tid, table, num);
}

// resident blocks an SM of one instantiation at `smem` bytes of table
template <int S>
int blocks_per_sm(size_t smem) {
  int b = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, raytrace_kernel<S>, kThreads, smem) != cudaSuccess || b < 1) {
    cudaGetLastError();
    b = 1;
  }
  return b;
}

template <int S>
int launch(const float* dx, const float* dy, const float* dz,
           const float* spheres, int num, float* out, long long n,
           cudaStream_t stream) {
  const size_t smem = sizeof(Sphere) * (num > 0 ? num : 1);
  if (smem > 48 * 1024) {     // above the default dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        raytrace_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  static int main_per_sm = 0;  // the main path's table size, cached
  int per_sm;
  if (S > 0) {
    if (main_per_sm == 0) main_per_sm = blocks_per_sm<S>(smem);
    per_sm = main_per_sm;
  } else {
    per_sm = blocks_per_sm<S>(smem);
  }
  const uintptr_t ax = (uintptr_t)dx;
  const int vec = ((ax ^ (uintptr_t)dy) & 15) == 0 &&
                  ((ax ^ (uintptr_t)dz) & 15) == 0 &&
                  ((ax ^ (uintptr_t)out) & 15) == 0 && (ax & 3) == 0;
  long long head = vec ? (long long)(((16 - (ax & 15)) & 15) / 4) : 0;
  if (head > n) head = n;
  const long long work = vec ? (n - head) / kRays : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * per_sm;
  if (blocks > cap) blocks = cap;             // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  raytrace_kernel<S><<<(unsigned)blocks, kThreads, smem, stream>>>(
      dx, dy, dz, spheres, num, out, n, (int)head, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raytrace_f32(const void* dx, const void* dy, const void* dz,
                            const void* spheres, int num, void* out,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  if (num < 0 || num > kMaxSpheres) return (int)cudaErrorInvalidValue;
  const auto run = num == kMainSpheres ? launch<kMainSpheres> : launch<0>;
  return run((const float*)dx, (const float*)dy, (const float*)dz,
             (const float*)spheres, num, (float*)out, n,
             (cudaStream_t)stream);
}
