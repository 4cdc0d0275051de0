// Decode attention: one new query token of each q head against the K/V
// ring of its kv head, with an online softmax, straight from the ring's
// own dtype.
//
// Replaces no Pallas kernel: the reference's decode attends with einsums
// over its cache (src/repro/models/attention.py:173-178), and so does the
// plain version (`decode_attention_plain`), which casts the whole ring to
// f32 first. q is (B, Hkv, G, D) (q head h * G + g reads kv head h), k and
// v are rings (B, Hkv, S, D), all f32 or bf16 (q and out may differ from
// the rings); out is (B, Hkv, G, D) in q's type. `pos` is the new token's
// absolute position, read from device memory when `pos_ptr` is given (so a
// replayed CUDA graph sees each step's), else `pos`; its key and value are
// already in slot pos % S. A slot of age a = (pos % S - slot) mod S counts
// when a <= min(pos, S - 1) and, with a window, a < window: the valid
// slots are the L = min(pos + 1, S, window) newest, a circular range
// ending at pos % S, and only those are read. Scores q . k in f32 with
// q scaled by `scale` in f32 first, the softmax in f32, P kept in f32 for
// P V; the result rounds once, to out's type. (Scores run in log2 units,
// q scaled by scale * log2 e, and the weights are exp2 of differences.)
//
// Bound on an H100: bytes. Each valid K and V row is read once, 4 D bytes
// a slot in bf16, against 4 G D FLOP: G FLOP a byte, far below the card's
// ~295 (bf16) or ~20 (f32 CUDA cores) line for the port's G <= 16. At
// Zamba2-7B-Instruct's decode (B 32, Hkv 32, G 1, S 1056, D 224) one call
// reads up to 969 MB, 0.289 ms at 3.35 TB/s.
//
// The design is about bytes in flight:
// - One block of 8 warps per (batch row, kv head, slice of the valid
//   range). It carries all G query heads of the kv head, so under GQA the
//   ring is read once, not G times. Where B * Hkv fills the card (>= 2
//   blocks an SM) there is one slice; else the wrapper asks for more
//   (`decode_attention.py` `split_count`), each slice writes its (max, sum,
//   unnormalised output) to scratch, and a second small kernel merges them
//   in slice order. No atomics: the result does not depend on timing, so
//   a graph replay equals an eager call bit for bit.
// - Tiles of K and V rows arrive by 16-byte `cp.async` into a 3-stage
//   ring in shared memory (~16 KB a tile): two tiles in flight while one
//   computes. At the cell's shape a block holds 43 KB and, at one query
//   head a kv head, 64 registers a thread, so four blocks share an SM:
//   ~115 KB in flight an SM, several times what the HBM's latency needs
//   (on an H100 80GB HBM3 at 700 W, 3 stages at 4 blocks an SM ran 3-4 %
//   faster than 4 stages at 3, or than 32 KB tiles). No f32 copy of a
//   ring is ever written: a row converts to f32 in registers.
// - A warp owns 8 elements of each row per lane (16 bytes of bf16; for f32
//   the lane's 4 at 4c and 4 at D/2 + 4c, so a phase of 8 lanes reads
//   distinct banks), `lanes` = the next power of two >= D / 8 lanes a row,
//   32 / lanes rows at a time. A score is the lanes' partial dot products
//   summed by xor shuffles, so every lane of the row holds the same bits.
//   The warps of a block split the tile's rows (and, for G > 4, the heads
//   into groups of 4); each row group of each warp keeps its own running
//   (max, sum, output) over the rows it saw, two rows a step. At the end
//   the row groups merge by shuffles and the warps through shared memory,
//   in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;
constexpr int TILE_BYTES = 16384;   // K and V rows of one tile, about
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
// the most dynamic shared memory a launch asks for: an f32 tile of D 256
// is 16 rows (32 KB), three of them; the merge's scratch is smaller
constexpr int MAX_SMEM = STAGES * 16 * 2 * MAX_D * 4;

struct Shape {
  int G, S, D;
  int window;        // 0: none
  float scale;
  int kw;            // warps that split a tile's rows (WARPS / head groups)
  int lanes;         // lanes a row: the next power of two >= D / 8
  int tile;          // rows a tile
  int splits;        // slices of the valid range
  int io_bf16;       // q and out are bf16, else f32
};

__device__ __forceinline__ void unpack8(const bf16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// The d index of element i (0..7) of the lane that owns row chunk c.
template <typename T>
__device__ __forceinline__ int elem(int c, int i, int D) {
  if (sizeof(T) == 2) return 8 * c + i;
  return i < 4 ? 4 * c + i : D / 2 + 4 * c + (i - 4);
}

// The lane's 8 elements of a row in shared memory, as f32.
template <typename T>
__device__ __forceinline__ void read_row(const T* row, int c, int D,
                                         float* dst) {
  if constexpr (sizeof(T) == 2) {
    unpack8(reinterpret_cast<const bf16*>(row) + 8 * c, dst);
  } else {
    const float* r = reinterpret_cast<const float*>(row);
    const float4 a = *reinterpret_cast<const float4*>(r + 4 * c);
    const float4 b = *reinterpret_cast<const float4*>(r + D / 2 + 4 * c);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  }
}

// Scores are kept in log2 units (q carries scale * log2 e), so softmax
// weights are exp2 of differences: exp2f is the card's own EX2 unit, within
// 2 ulp, and saves expf's range reduction on every row.
constexpr float LOG2E = 1.4426950408889634f;

// 2^(m - M), 0 for an empty state (m = -inf)
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.0f : exp2f(m - M);
}

// One tile into a stage: logical rows [t0, t0 + tile) of the valid range
// (row t is slot (start + t) % S), K's then V's, as 2 tile rows of cpr
// 16-byte chunks. This thread copies chunk (r0, c0) and every THREADS-th
// after it, walked by additions (no division in the loop). Rows at or past
// `hi` are zero-filled: their scores are masked, and 0 * v must not meet
// stale bits.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* kb, const T* vb,
                                          int t0, int hi, int start, int S,
                                          int D, int tile, int cpr, int r0,
                                          int c0, int dr, int dc) {
  constexpr int PER_CHUNK = 16 / (int)sizeof(T);
  for (int r = r0, col = c0; r < 2 * tile;) {
    const int half = r >= tile;
    const int t = t0 + r - half * tile;
    int phys = start + t;
    if (phys >= S) phys -= S;
    const T* src = t < hi ? (half ? vb : kb) + (long long)phys * D +
                                col * PER_CHUNK
                          : kb;
    cu::cp_async16(dst + r * D + col * PER_CHUNK, src, t < hi ? 16 : 0);
    r += dr;
    col += dc;
    if (col >= cpr) {
      col -= cpr;
      ++r;
    }
  }
}

// GW = 1 (one query head a kv head, most of the port's decodes) is held
// to 64 registers, so that four blocks share an SM (a few bytes spill).
template <typename T, int GW>
__global__ void __launch_bounds__(THREADS, GW == 1 ? 4 : 1)
decode_attention_kernel(const void* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, void* __restrict__ out,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        const long long* __restrict__ pos_ptr,
                        long long pos_val, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x % s.splits;
  const int bh = blockIdx.x / s.splits;
  const int D = s.D, S = s.S, G = s.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hg = warp / s.kw, kw = warp - hg * s.kw;
  const int per_pass = 32 / s.lanes;           // rows a warp reads at once
  const int j = lane / s.lanes, c = lane - j * s.lanes;
  const bool active = c < D / 8;

  // the valid range, oldest first: logical row t is slot (start + t) % S
  const long long pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  const int slot = (int)(pos % S);
  long long span = pos + 1 < S ? pos + 1 : S;
  if (s.window > 0 && s.window < span) span = s.window;
  const int L = (int)span;
  int start = slot - L + 1;
  if (start < 0) start += S;
  const int per_split =
      ((L + s.splits - 1) / s.splits + s.tile - 1) / s.tile * s.tile;
  const int lo = split * per_split;
  const int hi = min(L, lo + per_split);
  const int ntiles = hi > lo ? (hi - lo + s.tile - 1) / s.tile : 0;

  const long long ring = (long long)bh * S * D;
  const T* kb = k + ring;
  const T* vb = v + ring;
  T* ring_smem = reinterpret_cast<T*>(smem);
  const int stage_elems = 2 * s.tile * D;
  // this thread's first 16-byte chunk of a tile and its stride in rows
  // and chunks (see load_rows)
  const int cpr = D * (int)sizeof(T) / 16;
  const int r0 = threadIdx.x / cpr, c0 = threadIdx.x - r0 * cpr;
  const int dr = THREADS / cpr, dc = THREADS - dr * cpr;

  auto load_tile = [&](int it) {
    load_rows(ring_smem + (it % STAGES) * stage_elems, kb, vb,
              lo + it * s.tile, hi, start, S, D, s.tile, cpr, r0, c0, dr,
              dc);
  };

  // this warp's heads: hg * GW + gi, scaled in f32 before q . k as the
  // plain version scales q, and by log2 e
  const int bh_q = bh * G;
  const float qscale = s.scale * LOG2E;
  float qr[GW][8], acc[GW][8], m[GW], l[GW];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    const int g = hg * GW + gi;
    m[gi] = -INFINITY;
    l[gi] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[gi][i] = 0.0f;
      float x = 0.0f;
      if (active && g < G) {
        const long long at = (long long)(bh_q + g) * D + elem<T>(c, i, D);
        x = s.io_bf16 ? __bfloat162float(static_cast<const bf16*>(q)[at])
                      : static_cast<const float*>(q)[at];
        x *= qscale;
      }
      qr[gi][i] = x;
    }
  }

  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < ntiles) load_tile(it);
    cu::cp_async_commit();
  }
  const int passes = s.tile / per_pass / s.kw;   // this warp's, a tile; even
  for (int it = 0; it < ntiles; ++it) {
    cu::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // tile it is in; tile it - 1 is done
    if (it + STAGES - 1 < ntiles) load_tile(it + STAGES - 1);
    cu::cp_async_commit();
    const T* Ks = ring_smem + (it % STAGES) * stage_elems;
    const T* Vs = Ks + s.tile * D;
    const int t0 = lo + it * s.tile;
    for (int p = 0; p < passes; p += 2) {
      int row[2];
      float sc[2][GW];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        row[u] = ((p + u) * s.kw + kw) * per_pass + j;
        float kr[8];
        if (active) {
          read_row(Ks + row[u] * D, c, D, kr);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kr[i] = 0.0f;
        }
        const bool valid = t0 + row[u] < hi;
#pragma unroll
        for (int gi = 0; gi < GW; ++gi) {
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(qr[gi][i], kr[i], dot);
          for (int off = s.lanes >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[u][gi] = valid ? dot : -INFINITY;
        }
      }
      float vr[2][8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (active) {
          read_row(Vs + row[u] * D, c, D, vr[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) vr[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        const float M = fmaxf(m[gi], fmaxf(sc[0][gi], sc[1][gi]));
        if (M == -INFINITY) continue;      // nothing valid yet
        const float a = weight(m[gi], M);
        const float p0 = exp2f(sc[0][gi] - M), p1 = exp2f(sc[1][gi] - M);
        l[gi] = l[gi] * a + p0 + p1;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[gi][i] = fmaf(p1, vr[1][i], fmaf(p0, vr[0][i], acc[gi][i] * a));
        m[gi] = M;
      }
    }
  }
  cu::cp_async_wait<0>();

  // the warp's row groups, merged by shuffles (same bits in every group)
  for (int off = s.lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lother = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float M = fmaxf(m[gi], mo);
      const float a = weight(m[gi], M), b = weight(mo, M);
      l[gi] = l[gi] * a + lother * b;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
        acc[gi][i] = acc[gi][i] * a + ao * b;
      }
      m[gi] = M;
    }
  }

  // the warps, through shared memory: [kw][head][D] outputs, then
  // [kw][head] maxima and sums
  __syncthreads();                         // the ring is free
  const int Gp = WARPS / s.kw * GW;        // heads the block's groups hold
  float* sm_acc = reinterpret_cast<float*>(smem);
  float* sm_m = sm_acc + s.kw * Gp * D;
  float* sm_l = sm_m + s.kw * Gp;
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    const int g = hg * GW + gi;
    if (j == 0 && active) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sm_acc[(kw * Gp + g) * D + elem<T>(c, i, D)] = acc[gi][i];
    }
    if (lane == 0) {
      sm_m[kw * Gp + g] = m[gi];
      sm_l[kw * Gp + g] = l[gi];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e - g * D;
    float M = -INFINITY;
    for (int w = 0; w < s.kw; ++w) M = fmaxf(M, sm_m[w * Gp + g]);
    float sum = 0.0f, o = 0.0f;
    for (int w = 0; w < s.kw; ++w) {
      const float a = weight(sm_m[w * Gp + g], M);
      sum += sm_l[w * Gp + g] * a;
      o += sm_acc[(w * Gp + g) * D + d] * a;
    }
    if (s.splits == 1) {
      const float x = o / sum;
      const long long at = (long long)(bh_q + g) * D + d;
      if (s.io_bf16)
        static_cast<bf16*>(out)[at] = __float2bfloat16(x);
      else
        static_cast<float*>(out)[at] = x;
    } else {
      const long long part = (long long)(bh * s.splits + split) * G + g;
      part_acc[part * D + d] = o;
      if (d == 0) {
        part_ml[2 * part] = M;
        part_ml[2 * part + 1] = sum;
      }
    }
  }
}

// The slices of each (b, kv head), merged in slice order. Slice 0 holds
// the oldest valid rows and is never empty, so the max is finite.
__global__ void __launch_bounds__(THREADS)
decode_attention_merge(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml,
                       void* __restrict__ out, int G, int D, int splits,
                       int io_bf16) {
  const int bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e - g * D;
    float M = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      M = fmaxf(M, part_ml[2 * ((long long)(bh * splits + sp) * G + g)]);
    float sum = 0.0f, o = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const long long part = (long long)(bh * splits + sp) * G + g;
      const float a = weight(part_ml[2 * part], M);
      sum += part_ml[2 * part + 1] * a;
      o += part_acc[part * D + d] * a;
    }
    const float x = o / sum;
    const long long at = ((long long)bh * G + g) * D + d;
    if (io_bf16)
      static_cast<bf16*>(out)[at] = __float2bfloat16(x);
    else
      static_cast<float*>(out)[at] = x;
  }
}

template <typename T, int GW>
int launch_gw(const void* q, const void* k, const void* v, void* out,
              float* part_acc, float* part_ml, const long long* pos_ptr,
              long long pos, int rows, Shape s, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, GW>;
  static bool attr_set[64];            // per device; a race sets the same
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  const int heads = WARPS / s.kw * GW;
  const int ring = STAGES * 2 * s.tile * s.D * (int)sizeof(T);
  const int merge = s.kw * heads * (s.D + 2) * (int)sizeof(float);
  const int bytes = ring > merge ? ring : merge;
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  kernel<<<rows * s.splits, THREADS, bytes, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), out, part_acc,
      part_ml, pos_ptr, pos, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.splits == 1) return (int)err;
  decode_attention_merge<<<rows, THREADS, 0, stream>>>(
      part_acc, part_ml, out, s.G, s.D, s.splits, s.io_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* part_acc, void* part_ml, const void* pos_ptr, long long pos,
           int B, int Hkv, int G, int S, int D, int window, float scale,
           int splits, int io_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (G < 1 || G > MAX_G || S < 1 || D < 8 || D > MAX_D || D % 8 != 0 ||
      splits < 1 || window < 0 || pos < 0)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.G = G;
  s.S = S;
  s.D = D;
  s.window = window;
  s.scale = scale;
  s.splits = splits;
  s.io_bf16 = io_bf16;
  const int groups = G <= 4 ? 1 : G <= 8 ? 2 : 4;   // heads in groups of 4
  s.kw = WARPS / groups;
  int lanes = 1;
  while (lanes < D / 8) lanes <<= 1;
  s.lanes = lanes;
  // a tile is a whole number of two-row steps of every warp
  const int unit = 2 * (32 / lanes) * s.kw;
  const int want = TILE_BYTES / (2 * D * (int)sizeof(T));
  s.tile = want > unit ? want / unit * unit : unit;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pp = static_cast<const long long*>(pos_ptr);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const int rows = B * Hkv;
  if (G == 1)
    return launch_gw<T, 1>(q, k, v, out, pa, pm, pp, pos, rows, s, st);
  if (G == 2)
    return launch_gw<T, 2>(q, k, v, out, pa, pm, pp, pos, rows, s, st);
  return launch_gw<T, 4>(q, k, v, out, pa, pm, pp, pos, rows, s, st);
}

}  // namespace

// q, k, v, out, split scratch (outputs, then max and sum; unused for one
// split), the position on the device (null: `pos`), pos, B, Hkv, G, S, D,
// window (0: none), scale, splits, q and out bf16, stream
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out,
                                     void* part_acc, void* part_ml,
                                     const void* pos_ptr, long long pos,
                                     int B, int Hkv, int G, int S, int D,
                                     int window, float scale, int splits,
                                     int io_bf16, void* stream) {
  return launch<bf16>(q, k, v, out, part_acc, part_ml, pos_ptr, pos, B, Hkv,
                      G, S, D, window, scale, splits, io_bf16, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, void* part_acc,
                                    void* part_ml, const void* pos_ptr,
                                    long long pos, int B, int Hkv, int G,
                                    int S, int D, int window, float scale,
                                    int splits, int io_bf16, void* stream) {
  return launch<float>(q, k, v, out, part_acc, part_ml, pos_ptr, pos, B, Hkv,
                       G, S, D, window, scale, splits, io_bf16, stream);
}
