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
// Bound on an H100: bytes. 18 f32 operations per pixel against 8 bytes,
// so the card's memory rate decides: 0.0626 ms for the Table 1 image
// (5124 x 5120 in, 5120 x 5120 out) at 3.35 TB/s.
//
// What held the first version back (one 32 x 32 output tile per block,
// read as a 36 x 36 window into shared memory; 0.146 ms against 0.0755 ms
// for a device copy of the same bytes in chip_smoke.py's probe on an H100
// 80GB HBM3 at 700 W): its three phases (load, vertical pass, horizontal
// pass) sat between barriers, so a block had no load in flight while it
// computed; every access was 4 bytes wide, every element paid an integer
// / and % by 36 or 32, and the window read 1.27x the tile's bytes.
//
// Design: a streaming kernel with no barrier. Each warp owns a strip of
// 128 columns, 4 per lane, and walks down (or up) a run of rows with the 5
// input rows of its columns in registers, a rolling window: each row is
// read once per strip, and the strip's 2 + 2 halo columns come in beside
// it (lanes 0 and 31 copy them). Rows arrive by `cp.async` into a ring of
// kDepth + 1 row slots in shared memory, kDepth rows ahead of use, so every
// warp keeps kDepth rows in flight while it computes; a lane reads back
// only what it copied, so no barrier is needed. Each step runs the
// vertical pass in registers, trades the two columns on either side with
// the neighbouring lanes by shuffles (lanes 0 and 31 take the halo's), runs
// the horizontal pass and writes its 4 outputs. With W % 4 == 0 and both
// base pointers 16-byte aligned, rows come in and go out as 16-byte
// accesses (8 bytes for the halo); otherwise as 4-byte ones, in the same
// kernel. A warp walks a run of output rows, and alternate blocks walk up,
// so the 4 rows two runs share are read by both at about the same time.
// In device memory the runs are short (kRows), so the grid holds several
// blocks per SM slot and the card stays full to the end of a launch, and
// the rows read twice come the second time from L2. Mapped host memory
// (the USM plane's arrays) is read over PCIe, where every row read twice
// crosses it again, so there the runs are longer (kRowsHost; chip_smoke.py's
// launch-shape probe times both run lengths on both kinds of memory).
// Each sum is written with __fmul_rn/__fadd_rn in the plain version's
// order, so the kernel equals it bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using namespace cu;

constexpr int kWarps = 4;                 // a block: 4 strips side by side
constexpr int THREADS = 32 * kWarps;
constexpr int kStrip = 128;               // columns a warp owns, 4 a lane
constexpr int kSlot = kStrip + 4;         // a row slot: strip, then halo
constexpr int kDepth = 4;                 // rows in flight per warp
constexpr int kSlots = kDepth + 1;
constexpr int kRows = 16;                 // output rows a warp walks
constexpr int kRowsHost = 64;             // the same over mapped host memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float taps5(float a, float b, float c, float d,
                                       float e) {
  float s = __fmul_rn(0.0625f, a);
  s = __fadd_rn(s, __fmul_rn(0.25f, b));
  s = __fadd_rn(s, __fmul_rn(0.375f, c));
  s = __fadd_rn(s, __fmul_rn(0.25f, d));
  return __fadd_rn(s, __fmul_rn(0.0625f, e));
}

// One lane's part of an input row: its 4 columns and, in lanes 0 and 31,
// the strip's 2 halo columns on that side (zeros in the other lanes).
struct Cols {
  float4 m;
  float2 h;
};

__device__ __forceinline__ Cols taps5(const Cols& a, const Cols& b,
                                      const Cols& c, const Cols& d,
                                      const Cols& e) {
  Cols v;
  v.m.x = taps5(a.m.x, b.m.x, c.m.x, d.m.x, e.m.x);
  v.m.y = taps5(a.m.y, b.m.y, c.m.y, d.m.y, e.m.y);
  v.m.z = taps5(a.m.z, b.m.z, c.m.z, d.m.z, e.m.z);
  v.m.w = taps5(a.m.w, b.m.w, c.m.w, d.m.w, e.m.w);
  v.h.x = taps5(a.h.x, b.h.x, c.h.x, d.h.x, e.h.x);
  v.h.y = taps5(a.h.y, b.h.y, c.h.y, d.h.y, e.h.y);
  return v;
}

struct Strip {
  const float* src;    // the source rows
  const float* dummy;  // a valid address for zero-byte copies
  float* out;
  long long src_rows, lo_pad;
  int W;
  int c;               // this lane's first column
  int hc;              // its first halo column (lanes 0 and 31), else -1
  int hoff;            // where its halo sits in a slot, else -1
};

// Start the copies of logical row `lrow` into `slot`; missing rows and
// columns are zero-filled.
template <bool VEC>
__device__ __forceinline__ void copy_row(const Strip& s, float* slot,
                                         long long lrow, int lane) {
  const long long sr = lrow - s.lo_pad;
  const bool row_ok = sr >= 0 && sr < s.src_rows;
  const float* row = s.src + (row_ok ? sr : 0) * (long long)s.W;
  float* dst = slot + 4 * lane;
  if (VEC) {
    const bool ok = row_ok && s.c < s.W;
    cp_async16(dst, ok ? row + s.c : s.dummy, ok ? 16 : 0);
    if (s.hoff >= 0) {
      const bool hok = row_ok && s.hc >= 0 && s.hc < s.W;
      cp_async8(slot + s.hoff, hok ? row + s.hc : s.dummy, hok ? 8 : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row_ok && s.c + j < s.W;
      cp_async4(dst + j, ok ? row + s.c + j : s.dummy, ok ? 4 : 0);
    }
    if (s.hoff >= 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int hc = s.hc + j;
        const bool hok = row_ok && hc >= 0 && hc < s.W;
        cp_async4(slot + s.hoff + j, hok ? row + hc : s.dummy, hok ? 4 : 0);
      }
    }
  }
}

// Output rows [r_lo, r_hi) of one strip, walking down (DOWN) or up. The
// rows enter in the order L_j = r_lo + j (down) or r_hi + 3 - j (up),
// j = 0 ... n + 3. Row j lands in ring slot j % kSlots, kDepth steps after
// its copy started, and is read into window register R[(j + 1) % 5]; from
// j = 4 on, step j writes output row L_{j-4} (down) or L_j (up) from its 5
// input rows. Steps run 5 at a time, so every register index is a constant
// and the window turns without a move.
template <bool VEC, bool DOWN>
struct Walk {
  const Strip& s;
  float* ring;
  long long r_lo, r_hi;
  int steps, lane;
  int rd = 0, wr = kDepth;   // slots of rows j and j + kDepth
  Cols R[5];

  __device__ __forceinline__ long long lrow(int j) const {
    return DOWN ? r_lo + j : r_hi + 3 - j;
  }

  // Wait for row j, read it into R[reg] and start the copy of row
  // j + kDepth into the slot row j - 1 left one step ago.
  __device__ __forceinline__ void next(int j, int reg) {
    cp_async_wait<kDepth - 1>();
    const float* row = ring + rd * kSlot;
    R[reg].m = *reinterpret_cast<const float4*>(row + 4 * lane);
    R[reg].h = s.hoff >= 0 ? *reinterpret_cast<const float2*>(row + s.hoff)
                           : make_float2(0.f, 0.f);
    if (j + kDepth < steps)
      copy_row<VEC>(s, ring + wr * kSlot, lrow(j + kDepth), lane);
    cp_async_commit();
    rd = rd == kSlots - 1 ? 0 : rd + 1;
    wr = wr == kSlots - 1 ? 0 : wr + 1;
  }

  // Step j = 4 + 5m + S: false once the rows are done.
  template <int S>
  __device__ __forceinline__ bool step(int j) {
    if (j >= steps) return false;
    next(j, S);
    const Cols v =
        DOWN ? taps5(R[(S + 1) % 5], R[(S + 2) % 5], R[(S + 3) % 5],
                     R[(S + 4) % 5], R[S])
             : taps5(R[S], R[(S + 4) % 5], R[(S + 3) % 5], R[(S + 2) % 5],
                     R[(S + 1) % 5]);
    // vertical sums two columns left and right of this lane's four
    float l2 = __shfl_up_sync(FULL, v.m.z, 1);
    float l1 = __shfl_up_sync(FULL, v.m.w, 1);
    float r4 = __shfl_down_sync(FULL, v.m.x, 1);
    float r5 = __shfl_down_sync(FULL, v.m.y, 1);
    if (lane == 0) {
      l2 = v.h.x;
      l1 = v.h.y;
    }
    if (lane == 31) {
      r4 = v.h.x;
      r5 = v.h.y;
    }
    float4 o;
    o.x = taps5(l2, l1, v.m.x, v.m.y, v.m.z);
    o.y = taps5(l1, v.m.x, v.m.y, v.m.z, v.m.w);
    o.z = taps5(v.m.x, v.m.y, v.m.z, v.m.w, r4);
    o.w = taps5(v.m.y, v.m.z, v.m.w, r4, r5);
    float* dst = s.out + (DOWN ? lrow(j - 4) : lrow(j)) * s.W + s.c;
    if (VEC) {
      if (s.c < s.W) *reinterpret_cast<float4*>(dst) = o;
    } else {
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s.c + k < s.W) dst[k] = ov[k];
    }
    return true;
  }

  __device__ __forceinline__ void run() {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      if (j < steps) copy_row<VEC>(s, ring + j * kSlot, lrow(j), lane);
      cp_async_commit();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) next(j, j + 1);   // steps >= 5
    for (int j = 4;; j += 5) {
      if (!step<0>(j) || !step<1>(j + 1) || !step<2>(j + 2) ||
          !step<3>(j + 3) || !step<4>(j + 4))
        break;
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gaussian_rows_kernel(const float* __restrict__ src, long long src_rows,
                         int W, long long lo_pad, float* __restrict__ out,
                         long long out_rows, long long run) {
  __shared__ __align__(16) float ring[kWarps][kSlots * kSlot];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = (blockIdx.x * kWarps + warp) * kStrip;
  if (cs >= W) return;               // the whole warp lies past W
  Strip s;
  s.src = src;
  s.dummy = out;
  s.out = out;
  s.src_rows = src_rows;
  s.lo_pad = lo_pad;
  s.W = W;
  s.c = cs + 4 * lane;
  s.hc = lane == 0 ? cs - 2 : (lane == 31 ? cs + kStrip : -1);
  s.hoff = lane == 0 ? kStrip : (lane == 31 ? kStrip + 2 : -1);
  const long long r_lo = (long long)blockIdx.y * run;
  const long long r_hi = r_lo + run < out_rows ? r_lo + run : out_rows;
  const int steps = (int)(r_hi - r_lo) + 4;
  if (blockIdx.y & 1)
    Walk<VEC, false>{s, ring[warp], r_lo, r_hi, steps, lane}.run();
  else
    Walk<VEC, true>{s, ring[warp], r_lo, r_hi, steps, lane}.run();
}

}  // namespace

extern "C" int gaussian_rows_f32(const void* src, long long src_rows, int W,
                                 long long lo_pad, void* out,
                                 long long out_rows, void* stream) {
  if (out_rows <= 0 || W <= 0) return 0;
  const long long strips = (W + kWarps * kStrip - 1) / (kWarps * kStrip);
  // longer runs past the grid's y limit of 65535
  long long run = (out_rows + 65534) / 65535;
  const int rows = on_device(src) && on_device(out) ? kRows : kRowsHost;
  if (run < rows) run = rows;
  dim3 grid((unsigned)strips, (unsigned)((out_rows + run - 1) / run));
  const bool vec = W % 4 == 0 && ((uintptr_t)src % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  if (vec)
    gaussian_rows_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)src, src_rows, W, lo_pad, (float*)out, out_rows, run);
  else
    gaussian_rows_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)src, src_rows, W, lo_pad, (float*)out, out_rows, run);
  return (int)cudaGetLastError();
}
