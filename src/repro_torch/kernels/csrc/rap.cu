// Resource Allocation Problem row utilities (paper benchmark: Rap).
//
// Replaces the Pallas kernel repro/kernels/rap.py `rap` (body
// `_rap_kernel`): out[i] = sum over j < lengths[i] of log1p(max(v[i][j], 0))
// for an (N, L) f32 matrix and (N,) int32 lengths; a length above L counts
// as L and one at or below 0 gives 0.
//
// Bound on an H100: bytes, and data dependent. The TPU kernel reads every
// row in full and masks columns past the row's length with an iota. Here
// only the columns that count are read, j < min(len, L), so the bytes moved
// are 4 * sum(min(len_i, L)) for the values plus 8 per row (its length read,
// its result written): 0.0155 ms at the Table 1 size over 3.35 TB/s. Its
// operations (the max, the add and log1pf's 21, as chip_smoke.py counts
// them) take about half that at the card's unfused f32 issue rate.
//
// What held the first version back was latency (chip_smoke.py's probe on an
// H100 80GB HBM3 at 700 W): one warp took one row at a time, a load of its
// length and then of its values, two DRAM round trips a row with about 6 KB
// in flight an SM, so every length 0 took 0.040 ms and every length 48
// 0.101 ms, against 0.0012 and 0.0299 ms of bytes.
//
// Design. A warp takes 32 consecutive rows a turn. Their 32 lengths are copied
// kAhead turns ahead into a ring in shared memory (cp.async, a lane a row) and
// handed out by shuffle. A segment of SEG lanes takes a row, its lanes taking
// 16-byte chunks of 4 columns at a stride of SEG chunks, so 32 / SEG rows run
// at once (a step). The chunks of a row's first kRowChunks (48 columns) that
// hold a counted column are loaded into registers a turn ahead: as soon as a
// step's chunks are summed, the same step of the warp's next turn is loaded
// into them, so about one turn of rows (3 KB at Table 1) stays in flight a
// warp while the log1pf arithmetic runs. A chunk holding the row's end counts
// its columns past the length as 0, and log1p(0) adds exactly 0. Each lane
// sums its chunks in order, the segment adds its lanes with log2(SEG) shuffles
// (every lane ends with the same sum, as float addition commutes), and the 32
// sums are gathered into one coalesced store. What a lane loads is written by
// nothing else until it is summed, and a chunk's columns past the length are
// masked only then: an instruction that wrote a loaded register (a select, a
// clamp, a move) would wait for the load there. When L % 4 != 0 or the values
// are not 16-byte aligned (a package's rows start anywhere) each chunk is read
// as 4-byte loads, with the same chunks summed in the same order, so the
// result does not depend on alignment. The order of summation differs from the
// plain version's row sum, hence its stated tolerance. Segments are kSegment
// lanes on device memory, where they waste the fewest lanes on short rows, and
// kSegmentHost on mapped host memory (USM), where a load reads 128 contiguous
// bytes of a row and fewer, longer reads cross PCIe (chip_smoke.py times both
// shapes on both memories).
//
// chip_smoke.py's probe (an H100 80GB HBM3 at 700 W) finds it at about 1.7x
// a device copy of its bytes, 0.018-0.020 ms more whether 12 M or 24 M
// values count: latency, with one turn of rows in flight a warp at the 16
// warps an SM its 100 registers allow.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int kThreads = 256;
constexpr int kSegment = 2;         // lanes that share a row: device memory
constexpr int kSegmentHost = 8;     // and mapped host memory
constexpr int kRowChunks = 12;      // a row's chunks loaded ahead: L = 48
constexpr int kAhead = 2;           // turns the lengths run ahead
constexpr unsigned kFull = 0xffffffffu;

// The walk of SEG-lane segments: 32 / SEG rows at once (a step), SEG steps
// a turn of 32 rows, kSlots chunks a lane loaded ahead.
template <int SEG>
struct Walk {
  static constexpr int kSteps = SEG;
  static constexpr int kRowsAtOnce = 32 / SEG;
  static constexpr int kSlots = (kRowChunks + SEG - 1) / SEG;
};

__device__ __forceinline__ float utility(float v) {
  return log1pf(fmaxf(v, 0.0f));
}

// Load chunk c (columns 4c ... 4c+3) of a row whose first `len` columns
// count, 4c < len, into `a`. Only loads: nothing else writes `a` here, so
// no instruction waits for the load before the chunk is summed, and the
// 4-byte path leaves the columns past the length as they were.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float4& a, const float* row,
                                           int c, int len) {
  const int j = 4 * c;
  if (VEC) {
    a = __ldg(reinterpret_cast<const float4*>(row) + c);
  } else {
    a.x = __ldg(row + j);
    if (j + 1 < len) a.y = __ldg(row + j + 1);
    if (j + 2 < len) a.z = __ldg(row + j + 2);
    if (j + 3 < len) a.w = __ldg(row + j + 3);
  }
}

// acc plus the utilities of chunk c's counted columns, in order; a column
// past the length counts as 0, whose utility log1p(0) adds exactly 0
__device__ __forceinline__ float add_chunk(float acc, const float4& a, int c,
                                           int len) {
  const int j = 4 * c;
  acc += utility(a.x);
  acc += utility(j + 1 < len ? a.y : 0.0f);
  acc += utility(j + 2 < len ? a.z : 0.0f);
  return acc + utility(j + 3 < len ? a.w : 0.0f);
}

// Copy the lengths of the turn at row r0 into its ring slot, a lane a row
// (0 past the last row), as one cp.async group.
__device__ __forceinline__ void fetch_lengths(int* slot, const int* lengths,
                                              long long r0, long long n) {
  const int lane = threadIdx.x & 31;
  const bool in = r0 + lane < n;
  cp_async4(slot + lane, in ? lengths + r0 + lane : lengths, in ? 4 : 0);
  cp_async_commit();
}

// Load the chunks of step `s` of the turn at row `r0` (rows r0 + s *
// kRowsAtOnce + seg), whose 32 lengths are `lens`, that hold a counted
// column; the other slots keep what they held.
template <bool VEC, int SEG>
__device__ __forceinline__ void load_step(float4 (&v)[Walk<SEG>::kSlots],
                                          const float* values, long long r0,
                                          int s, int lens, int L) {
  using W = Walk<SEG>;
  const int lane = threadIdx.x & 31;
  const int seg = lane / SEG, sub = lane % SEG;
  const int len = __shfl_sync(kFull, lens, s * W::kRowsAtOnce + seg);
  const float* row = values + (r0 + s * W::kRowsAtOnce + seg) * (long long)L;
#pragma unroll
  for (int k = 0; k < W::kSlots; ++k) {
    const int c = sub + SEG * k;
    if (4 * c < len) load_chunk<VEC>(v[k], row, c, len);
  }
}

// VEC: L % 4 == 0 and `values` 16-byte aligned (every chunk is a float4);
// SEG: lanes that share a row
template <bool VEC, int SEG>
__global__ void __launch_bounds__(kThreads)
rap_kernel(const float* __restrict__ values, const int* __restrict__ lengths,
           float* __restrict__ out, long long n, int L) {
  using W = Walk<SEG>;
  // each warp's lengths, kAhead turns ahead: a ring of kAhead + 1 turns
  __shared__ int ring[kThreads / 32][kAhead + 1][32];
  const int lane = threadIdx.x & 31;
  const int seg = lane / SEG, sub = lane % SEG;
  int(*lens_of)[32] = ring[threadIdx.x / 32];
  const long long stride = (long long)gridDim.x * kThreads;  // rows a turn
  long long r0 = ((long long)blockIdx.x * kThreads + threadIdx.x) & ~31LL;
  for (int a = 0; a < kAhead; ++a)
    fetch_lengths(lens_of[a], lengths, r0 + a * stride, n);
  cp_async_wait<kAhead - 1>();              // this turn's lengths are in
  int lens = min(max(lens_of[0][lane], 0), L);
  float4 v[W::kSteps][W::kSlots];
#pragma unroll
  for (int s = 0; s < W::kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < W::kSlots; ++k)
      v[s][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    load_step<VEC, SEG>(v[s], values, r0, s, lens, L);
  }
  for (int t = 0; r0 < n; r0 += stride, ++t) {  // warp-uniform: 32 rows a turn
    fetch_lengths(lens_of[(t + kAhead) % (kAhead + 1)], lengths,
                  r0 + kAhead * stride, n);
    cp_async_wait<kAhead - 1>();            // the next turn's are in
    const int lens_next =
        min(max(lens_of[(t + 1) % (kAhead + 1)][lane], 0), L);
    float res = 0.0f;
#pragma unroll
    for (int s = 0; s < W::kSteps; ++s) {
      const int len = __shfl_sync(kFull, lens, s * W::kRowsAtOnce + seg);
      const float* row =
          values + (r0 + s * W::kRowsAtOnce + seg) * (long long)L;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < W::kSlots; ++k) {
        const int c = sub + SEG * k;
        if (4 * c < len) acc = add_chunk(acc, v[s][k], c, len);
      }
      // rows longer than the chunks loaded ahead (L > 48)
      for (int c = sub + SEG * W::kSlots; 4 * c < len; c += SEG) {
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        load_chunk<VEC>(a, row, c, len);
        acc = add_chunk(acc, a, c, len);
      }
      // the step's registers are free: load the next turn's same step
      load_step<VEC, SEG>(v[s], values, r0 + stride, s, lens_next, L);
#pragma unroll
      for (int o = 1; o < SEG; o <<= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
      const float sum =
          __shfl_sync(kFull, acc, (lane % W::kRowsAtOnce) * SEG);
      if (lane / W::kRowsAtOnce == s) res = sum;
    }
    if (r0 + lane < n) out[r0 + lane] = res;
    lens = lens_next;
  }
  cp_async_wait<0>();
}

template <bool VEC, int SEG>
int launch(const float* values, const int* lengths, float* out, long long n,
           int L, cudaStream_t stream) {
  static int per_sm = 0;                    // resident blocks an SM
  if (per_sm == 0) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, rap_kernel<VEC, SEG>, kThreads, 0) != cudaSuccess || b < 1)
      b = 1;
    per_sm = b;
  }
  const long long warps = (n + 31) / 32;
  long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = (long long)sm_count() * per_sm;
  if (blocks > cap) blocks = cap;           // grid-stride beyond this
  rap_kernel<VEC, SEG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      values, lengths, out, n, L);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_segments(const float* values, const int* lengths, float* out,
                    long long n, int L, int seg, cudaStream_t stream) {
  return seg == kSegment
             ? launch<VEC, kSegment>(values, lengths, out, n, L, stream)
             : launch<VEC, kSegmentHost>(values, lengths, out, n, L, stream);
}

}  // namespace

extern "C" int rap_f32(const void* values, const void* lengths, void* out,
                       long long n, int L, void* stream) {
  if (n <= 0) return 0;
  const bool vec = L % 4 == 0 && ((uintptr_t)values & 15) == 0;
  // over PCIe a wider segment reads longer runs of a row at once
  const int seg = on_device(values) ? kSegment : kSegmentHost;
  const float* v = (const float*)values;
  const int* len = (const int*)lengths;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_segments<true>(v, len, (float*)out, n, L, seg, s)
             : launch_segments<false>(v, len, (float*)out, n, L, seg, s);
}
