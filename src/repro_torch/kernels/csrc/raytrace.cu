// Ray-sphere nearest-hit Lambert shading, one thread per ray (paper
// benchmark: Ray).
//
// Replaces the Pallas kernel repro/kernels/raytrace.py `raytrace` (body
// `_ray_kernel`): for each unit ray d from the origin and each sphere
// [cx, cy, cz, r, albedo] in table order, b = d.c, disc = b*b - (|c|^2 -
// r*r), t = b - sqrt(max(disc, 0)); a hit needs disc > 0, t > 1e-3 and t
// below the nearest hit so far, and shades albedo * max(0, (n.light) / r)
// with n = t*d - c and light (0.577, 0.577, 0.577). Rays that hit nothing
// give 0.
//
// Bound on an H100: bytes. A ray reads 12 bytes and writes 4; it does ~30
// f32 operations per sphere, 240 for the demo scene's 8, which at the
// card's 67 TFLOP/s f32 stays below the time to move its 16 bytes at
// 3.35 TB/s. Design: the sphere table is a BROADCAST argument, which under
// USM lies in mapped host memory, so every read of it crosses PCIe. Each
// block loads it once into shared memory, with the per-sphere constants
// |c|^2 - r^2 and 1/max(r, 1e-6) precomputed there, and the grid is a
// fixed 8 blocks per SM (1056) that stride over the rays: the table is read
// about a thousand times per launch instead of once per 256 rays (~36,700
// times at Table 1 size). S is a runtime argument, at most kMaxSpheres
// (dynamic shared memory, 24 bytes a sphere, under the 48 KB default).
// Every operation is written with __fmul_rn/__fadd_rn/__fsub_rn and
// __fsqrt_rn/__fdiv_rn in the plain PyTorch version's order: nvcc would
// otherwise contract the dot products and b*b - c into FMAs, move disc by
// an ulp and flip hits at sphere silhouettes, where the shade is not small.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpheres = 2048;
constexpr int kFields = 6;  // cx, cy, cz, |c|^2 - r^2, 1/max(r, eps), albedo

__global__ void raytrace_kernel(const float* __restrict__ dx,
                                const float* __restrict__ dy,
                                const float* __restrict__ dz,
                                const float* __restrict__ spheres, int num,
                                float* __restrict__ out, long long n) {
  extern __shared__ float table[];
  for (int s = threadIdx.x; s < num; s += blockDim.x) {
    const float cx = spheres[5 * s + 0], cy = spheres[5 * s + 1];
    const float cz = spheres[5 * s + 2], r = spheres[5 * s + 3];
    float* row = table + kFields * s;
    row[0] = cx;
    row[1] = cy;
    row[2] = cz;
    row[3] = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(cx, cx),
                                           __fmul_rn(cy, cy)),
                                 __fmul_rn(cz, cz)),
                       __fmul_rn(r, r));
    row[4] = __fdiv_rn(1.0f, fmaxf(r, 1e-6f));
    row[5] = spheres[5 * s + 4];
  }
  __syncthreads();
  const float light = 0.577f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = dx[i], y = dy[i], z = dz[i];
    float best_t = __int_as_float(0x7f800000);  // +inf
    float shade = 0.0f;
    for (int s = 0; s < num; ++s) {
      const float* row = table + kFields * s;
      const float cx = row[0], cy = row[1], cz = row[2];
      const float b = __fadd_rn(__fadd_rn(__fmul_rn(x, cx), __fmul_rn(y, cy)),
                                __fmul_rn(z, cz));
      const float disc = __fsub_rn(__fmul_rn(b, b), row[3]);
      const float t = __fsub_rn(b, __fsqrt_rn(fmaxf(disc, 0.0f)));
      if (disc > 0.0f && t > 1e-3f && t < best_t) {
        const float nx = __fsub_rn(__fmul_rn(x, t), cx);
        const float ny = __fsub_rn(__fmul_rn(y, t), cy);
        const float nz = __fsub_rn(__fmul_rn(z, t), cz);
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(nx, light),
                                              __fmul_rn(ny, light)),
                                    __fmul_rn(nz, light));
        best_t = t;
        shade = __fmul_rn(row[5], fmaxf(0.0f, __fmul_rn(dot, row[4])));
      }
    }
    out[i] = shade;
  }
}

}  // namespace

extern "C" int raytrace_f32(const void* dx, const void* dy, const void* dz,
                            const void* spheres, int num, void* out,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  if (num < 0 || num > kMaxSpheres) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;  // grid-stride beyond this
  const size_t smem = sizeof(float) * kFields * (num > 0 ? num : 1);
  raytrace_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)dx, (const float*)dy, (const float*)dz,
      (const float*)spheres, num, (float*)out, n);
  return (int)cudaGetLastError();
}
