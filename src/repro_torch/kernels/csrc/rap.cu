// Resource Allocation Problem row utilities, one warp per row (paper
// benchmark: Rap).
//
// Replaces the Pallas kernel repro/kernels/rap.py `rap` (body
// `_rap_kernel`): out[i] = sum over j < lengths[i] of log1p(max(v[i][j], 0))
// for an (N, L) f32 matrix and (N,) int32 lengths; a length above L counts
// as L and one at or below 0 gives 0.
//
// Bound on an H100: bytes, and data dependent. The TPU kernel reads every
// row in full and masks columns past the row's length with an iota. Here
// the lanes of a warp stride over only the columns that count, j <
// min(len, L), so the bytes moved are 4 * sum(min(len_i, L)) for the values
// plus 8 per row (its length read, its result written); the rows' lengths
// differ, which is the benchmark's irregularity, and a short row costs a
// warp few loads. Each lane sums its columns, then a __shfl_xor_sync tree
// adds the 32 partial sums (every lane of the warp takes the same number
// of row iterations, so the full mask is safe). The summation order
// differs from the plain version's row sum, hence its stated tolerance.
#include <cuda_runtime.h>

namespace {

__global__ void rap_kernel(const float* __restrict__ values,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, long long n, int L) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < n; row += warps) {
    const int len = min(max(lengths[row], 0), L);
    const float* v = values + row * (long long)L;
    float acc = 0.0f;
    for (int j = lane; j < len; j += 32) acc += log1pf(fmaxf(v[j], 0.0f));
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[row] = acc;
  }
}

}  // namespace

extern "C" int rap_f32(const void* values, const void* lengths, void* out,
                       long long n, int L, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;  // 8 rows per block at a time
  long long blocks = (n + 7) / 8;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  rap_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)lengths, (float*)out, n, L);
  return (int)cudaGetLastError();
}
