// Chunked gated linear attention (the Mamba-2 SSD recurrence), with the
// (Dk, Dv) state carried on chip across the chunks of one head.
//
// Replaces the Pallas kernel repro/kernels/linear_attention.py
// `linear_attention` (body `_gla_kernel`). Per head: S_t = exp(ld_t) S_{t-1}
// + k_t^T v_t and o_t = q_t S_t, for q, k (BH, T, Dk), v (BH, T, Dv) (all f32
// or all bf16), log-decays ld (BH, T) f32 (entries <= 0); out (BH, T, Dv) in
// q's type. Dk <= 1024, any Dv. On the Dk <= 128 paths an optional `state`
// (BH, Dk, Dv) f32 receives each head's S after the last step (a prefill
// hands it to decode), written from the f32 state the block carried. The
// TPU kernel carries S in scratch across a sequential grid axis; blocks
// here run in no order, so one block owns a (head, Dv tile) and walks the
// chunks itself with S on chip. Per chunk of
// C = 64 steps (padded steps take log-decay 0 and zero q, k, v, which
// leaves the recurrence as it was):
//   cum_i = sum_{t<=i} ld_t (a warp scan), total = cum_{C-1};
//   A_ij = (q_i . k_j) exp(cum_i - cum_j) for i >= j, else 0;
//   o_i = sum_j A_ij v_j + exp(cum_i) (q_i . S);
//   S <- exp(total) S + sum_j exp(total - cum_j) k_j^T v_j.
// exp(cum_i - cum_j) is formed for i >= j only: for i < j it is a growth,
// which overflows to inf at Mamba-2's decays (the TPU kernel forms it and
// discards it with a where). Every exponent used is <= 0.
//
// Bound on an H100: bytes. Each input is read once and the output
// written once, 2 (2 Dk + 2 Dv) + 4 bytes per step in bf16, against
// 5 Dk Dv FLOP per step of the recurrence. The chunk form does about
// 2 C (Dk + Dv) + 4 Dk Dv FLOP per step (7.5 GFLOP at the zamba2-7b
// prefill, BH 448, T 512, Dk = Dv = 64): 0.11 ms at the CUDA cores' f32
// peak, 3x the 0.035 ms byte bound, and 0.008 ms at the tensor cores' bf16
// peak, so only the tensor cores leave the bytes as the bound.
//
// bf16 inputs: the tensor cores, `mma.sync.m16n8k16` (bf16 in, f32
// accumulate; helpers and fragment layouts in tensor_core.cuh). One block
// of 4 warps owns a head and a Dv tile of 64 columns (32 when Dk > 64,
// which keeps the state's registers in bounds, or Dv <= 32; the wrapper's
// `dv_tile_for` picks it), so at Dv = 64 the scores are formed once per
// head. Splitting Dv = 64 into two tiles, to double the blocks of a small
// batch, is slower on an H100 (chip_smoke.py times both at 224 heads):
// each tile forms the scores again. q, k and v chunks arrive by 16-byte `cp.async` (element by element
// when Dk or Dv is not a multiple of 8) into a 2-stage ring in shared
// memory, chunk c + 1 in flight while c computes; rows past T are
// zero-filled. Each warp scans the chunk's log-decays itself (no barrier)
// and owns 16 query rows: Q K^T from `ldmatrix` of K, the causal decay mask
// applied in registers, A split into a bf16 hi + lo pair and re-packed as A
// fragments of A V (V by `ldmatrix.trans`), plus exp(cum_i) (Q S). Key tiles
// past a warp's last row are skipped. The state stays f32 in accumulator
// fragments, 16 (Dk) rows per warp, across all chunks; the update's A
// operand (K o w)^T comes from `ldmatrix.trans` of K, scaled by w_j in f32
// and split into a bf16 hi + lo pair. Where S is an operand (Q S) it goes
// through shared memory as a hi + lo pair too, so the carried state is never
// rounded to bf16. Every f32 operand enters as hi + lo (about 2^-16
// relative) and only q, k, v, which are bf16 already, enter as they are:
// tests/test_torch_lm_kernels.py rebuilds these roundings on the CPU, where
// single-bf16 K o w put a row 1.4e-2 (relative L2) from the plain version,
// over the card's 1e-2 gate, and single-bf16 A (as flash rounds P) missed
// the 2e-2 abs gate by up to 0.125 where outputs reach 25 (the card tests'
// inputs). Dk and the Dv tile are padded to 32, 64 or 128 and to 32 or 64 in
// shared memory only. Two barriers per chunk: one before the chunk's tiles
// and S are read, one before S is rewritten. The next chunk's log-decays
// are loaded a chunk ahead. Exponentials are `__expf` (ex2.approx, about
// 2^-21 relative, below the hi + lo pairs' 2^-16): at 50 per lane and
// chunk, IEEE `expf` is a real share of the instructions. What bounds it
// now is not measured (no profiler on the card's machine); 3 blocks of 158
// registers and 75 KB fit an SM, so 12 warps walk dependent phases.
//
// f32 inputs: the CUDA cores, one block of 256 threads per (head,
// 32-column Dv tile), S in shared memory in f32; the C x C scores are
// recomputed for each Dv tile. Rows of q and k have an odd stride, so the
// rows a warp reads fall in distinct banks. The chunk's prefix sums of
// log-decays are f64 (scan_chunk), so each decay is f32-exact.
//
// Dk in (128, 1024] (xlstm-1.3b's mLSTM: Dk 1024, Dv 1025 with the
// normaliser's ones-column): `wide`. A head's state is 1024 x 1025 f32
// (4.2 MB), so no block can own it, and a chunk of Q alone is 64 x 1024.
// Bound: operations, the chunk form's causal count at its best chunk
// length c (c = 23 here), (c + 1)(Dk + Dv) + 4 Dk Dv + Dk Dv / c a step
// (35.2 GFLOP at BH 16, T 512): 0.036 ms at the tensor cores' bf16 peak
// (0.52 ms at the CUDA cores' f32 peak), against 0.02 ms of bf16 bytes.
// bf16 runs on the tensor cores, in two launches. Pass 1, one block of 4
// warps per (chunk, head), forms the chunk's scores Q K^T by `mma.sync` (Q
// and K streamed in 64-dim tiles through a 2-stage `cp.async` ring),
// applies the causal decay and writes A once, to a (BH, chunks, 64, 64)
// f32 scratch (2 MB at BH 16, T 512). Pass 2 splits the state by key dims
// as well as by value columns, so that each block's share lives in
// accumulator fragments: a block of 4 warps owns 128 key dims x 64 value
// columns of one head (64 f32 registers a thread), transposed (S^T), since
// the accumulators' layout is then the A operand of the next chunk's
// (Q S)^T = S^T Q^T. The ceil(Dk / 128) key-slice blocks of a (value
// tile, head) form a thread-block cluster (8 at Dk 1024); each computes
// its slice's partial of (Q S)^T and its slice's update, and rank r sums
// the partials of the 8-step output tiles r, r + 8, ... through
// distributed shared memory in rank order (no atomics: a launch repeats
// its bits), adds A V (A from the scratch as hi + lo) and writes bf16.
// One cluster barrier a chunk, the partials double-buffered; K and V
// arrive by 16-byte `cp.async` a chunk ahead, Q once the chunk's partial
// is formed. Dv = 1025 is handled on purpose: V and out rows are 2050
// bytes apart, so no 16-byte access lines up with a row; V is loaded 2
// bytes an element into the free stage after the update, and the 17th
// value tile holds the one column in its first warp (16 columns) while
// the other three skip their products. The rounding contract is the
// Dk <= 128 path's: q, k, v enter as they are; S, A and the
// decay-weighted operand enter as hi + lo pairs, with w scaling V instead
// of K ((K o w)^T V = K^T (w o V)), so each warp splits only its own 16
// columns' weights; the carried state stays f32 on chip. At the xLSTM
// shape: 2176 blocks of 128 threads, 106 KB and 244 registers, 2 an SM.
// What holds it at about 17x its bound is not measured (no profiler of the SM's stalls on the card's machine): the
// registers leave no room to prefetch more, and each chunk every rank of
// a cluster waits for the slowest.
// f32 stays on the CUDA cores, two kernels: pass 1 forms A as above with
// f32 FMAs; pass 2, one block of 256 threads per (32-column Dv tile,
// head), holds its (Dk, 32) slice of S in shared memory (190 KB at Dk
// 1024: one block an SM) and walks the chunks: A V, then per 64-dim tile
// of Q and K, the tile's rows of S feed the outputs (q . S) before the
// update (K o w)^T V rewrites them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int C = 64;         // steps per chunk
constexpr int DVT = 32;       // Dv columns per block (f32 path)
constexpr int THREADS = 256;  // f32 path
constexpr int DKMAX = 128;
// The f32 paths sum a dot product over the key dims in runs of DSUM fmaf
// steps, each run's partial then added to the total: with one accumulator
// over Dk = 1024 keys (|q . k| about 32 at unscaled keys) the wide path was
// 3x the plain version's distance from an f64 run on an H100, and within
// it with runs of 16.
constexpr int DSUM = 16;

// Inclusive scan of a chunk's C = 64 log-decays by one warp, lane l holding
// steps 2l and 2l + 1 (a and b): writes cum and returns the chunk's total.
__device__ __forceinline__ float scan_pair(float a, float b, int lane,
                                          float* cum) {
  float s = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += up;
  }
  float prev = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) prev = 0.0f;
  cum[2 * lane] = prev + a;
  cum[2 * lane + 1] = s;
  return __shfl_sync(0xffffffffu, s, 31);
}

// scan_pair in f64, for the f32 paths.
__device__ __forceinline__ double scan_pair_f64(double a, double b, int lane,
                                                double* cum) {
  double s = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += up;
  }
  double prev = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) prev = 0.0;
  cum[2 * lane] = prev + a;
  cum[2 * lane + 1] = s;
  return __shfl_sync(0xffffffffu, s, 31);
}

// Warp 0 loads chunk t0's log-decays (zero past seq) and scans them into
// cum; with ecum given, also exp(cum_i), w_j = exp(total - cum_j) and
// exp(total). The f32 paths keep cum in f64: a decay exp(cum_i - cum_j)
// comes from the difference of two prefix sums, which reach -256 within a
// chunk at Mamba-2's decays, and an f32 difference would carry an error of
// a few ulps of |cum| (about 1e-5 at 256) into the exponent, so a near
// step's decay would be off by as much, relatively. At unscaled 1024-wide
// keys (q . k about 32) that put the f32 wide path 1.5e-3 from an f64
// run of the recurrence on an H100, 13x the plain sequential version's
// distance; differences of f64 sums are exact to their own f32 rounding.
__device__ __forceinline__ void scan_chunk(const float* ldh, int t0, int seq,
                                           double* cum, float* ecum, float* w,
                                           float* etotal) {
  const int lane = threadIdx.x;
  const int t = t0 + 2 * lane;
  const double a = t < seq ? ldh[t] : 0.0;
  const double b = t + 1 < seq ? ldh[t + 1] : 0.0;
  const double total = scan_pair_f64(a, b, lane, cum);
  if (ecum != nullptr) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {     // the lane's own entries of cum
      const int j = 2 * lane + e;
      ecum[j] = expf((float)cum[j]);
      w[j] = expf((float)(total - cum[j]));
    }
    if (lane == 0) *etotal = expf((float)total);
  }
}

__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ log_decay,
                        float* __restrict__ out, float* __restrict__ state,
                        int seq, int Dk, int Dv) {
  extern __shared__ float smem[];
  const int ldk = Dk | 1;
  const int lda = C + 1;
  float* qs = smem;                    // [C][ldk]
  float* ks = qs + C * ldk;            // [C][ldk]
  float* vs = ks + C * ldk;            // [C][DVT]
  float* As = vs + C * DVT;            // [C][lda]
  float* S = As + C * lda;             // [Dk][DVT]
  double* cum = reinterpret_cast<double*>(S + Dk * DVT);  // [C], f64
  float* ecum = reinterpret_cast<float*>(cum + C);  // [C] exp(cum_i)
  float* w = ecum + C;                 // [C] exp(total - cum_j)
  float* etotal = w + C;               // [1] exp(total)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int dv0 = blockIdx.x * DVT;
  const long long row0 = (long long)bh * seq;
  const float* qh = q + row0 * Dk;
  const float* kh = k + row0 * Dk;
  const float* vh = v + row0 * Dv;
  const float* ldh = log_decay + row0;
  float* oh = out + row0 * Dv;

  for (int i = tid; i < Dk * DVT; i += THREADS) S[i] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += C) {
    // -- load the chunk (zero past the end) --------------------------------
    const long long kbase = (long long)t0 * Dk;
    const long long klimit = (long long)seq * Dk;
    for (int i = tid; i < C * Dk; i += THREADS) {
      const int r = i / Dk, d = i - r * Dk;
      const long long g = kbase + i;
      qs[r * ldk + d] = g < klimit ? qh[g] : 0.0f;
      ks[r * ldk + d] = g < klimit ? kh[g] : 0.0f;
    }
    for (int i = tid; i < C * DVT; i += THREADS) {
      const int r = i / DVT, c = i - r * DVT;
      const int t = t0 + r, col = dv0 + c;
      vs[i] = (t < seq && col < Dv)
                  ? vh[(long long)t * Dv + col] : 0.0f;
    }
    if (tid < 32) scan_chunk(ldh, t0, seq, cum, ecum, w, etotal);
    __syncthreads();

    // -- decayed causal scores A (a 4 x 4 micro-tile per thread) -----------
    {
      const int ti = tid >> 4, tj = tid & 15;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
      for (int d0 = 0; d0 < Dk; d0 += DSUM) {
        float p[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = 0.0f;
        const int dend = min(d0 + DSUM, Dk);
        for (int d = d0; d < dend; ++d) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qs[(ti * 4 + r) * ldk + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = ks[(tj + 16 * c) * ldk + d];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[r][c] = fmaf(a[r], b[c], p[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] += p[r][c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          As[i * lda + j] =
              i >= j ? s[r][c] * expf((float)(cum[i] - cum[j])) : 0.0f;
        }
      }
    }
    __syncthreads();

    // -- outputs: intra-chunk part plus the carried state's ---------------
    {
      const int tr = tid >> 3, tc = tid & 7;
      float intra[2][4], inter[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) intra[r][c] = inter[r][c] = 0.0f;
      for (int j = 0; j < C; ++j) {
        float a[2], b[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = As[(tr + 32 * r) * lda + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = vs[j * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            intra[r][c] = fmaf(a[r], b[c], intra[r][c]);
      }
      for (int d0 = 0; d0 < Dk; d0 += DSUM) {
        float p[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = 0.0f;
        const int dend = min(d0 + DSUM, Dk);
        for (int d = d0; d < dend; ++d) {
          float a[2], b[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) a[r] = qs[(tr + 32 * r) * ldk + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = S[d * DVT + tc + 8 * c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[r][c] = fmaf(a[r], b[c], p[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] += p[r][c];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tr + 32 * r, t = t0 + i;
        if (t >= seq) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = dv0 + tc + 8 * c;
          if (col < Dv)
            oh[(long long)t * Dv + col] = intra[r][c] + ecum[i] * inter[r][c];
        }
      }
    }
    __syncthreads();                   // every output has read S

    // -- state update: each thread owns up to 4 x 4 entries of S ----------
    {
      const int tr = tid >> 3, tc = tid & 7;
      const float decay = *etotal;
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) upd[r][c] = 0.0f;
      for (int j = 0; j < C; ++j) {
        const float wj = w[j];
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = tr + 32 * r;
          a[r] = d < Dk ? ks[j * ldk + d] * wj : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = vs[j * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) upd[r][c] = fmaf(a[r], b[c], upd[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = tr + 32 * r;
        if (d >= Dk) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* sp = S + d * DVT + tc + 8 * c;
          *sp = decay * *sp + upd[r][c];
        }
      }
    }
    __syncthreads();                   // S is whole before the next chunk
  }

  if (state != nullptr) {              // the block's columns of S
    float* sh = state + (long long)bh * Dk * Dv + dv0;
    for (int i = tid; i < Dk * DVT; i += THREADS) {
      const int d = i / DVT, c = i - d * DVT;
      if (dv0 + c < Dv) sh[(long long)d * Dv + c] = S[i];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v,
               const void* log_decay, void* out, void* state, int BH,
               int seq, int Dk, int Dv, void* stream) {
  if (BH <= 0 || seq <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > DKMAX) return (int)cudaErrorInvalidValue;
  const int ldk = Dk | 1;
  // cum is f64: 2 C floats' room
  const size_t bytes = sizeof(float) * (size_t)(2 * C * ldk + C * DVT +
                                                C * (C + 1) + Dk * DVT +
                                                4 * C + 1);
  // once, for the largest key dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      linear_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * (2 * C * (DKMAX | 1) + C * DVT + C * (C + 1) +
                             DKMAX * DVT + 4 * C + 1)));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Dv + DVT - 1) / DVT, BH);
  linear_attention_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)log_decay, (float*)out, (float*)state, seq, Dk, Dv);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------
namespace tensor_core {

using namespace ::tc;
constexpr int WARPS = 4;            // 16 query rows each
constexpr int THREADS = 32 * WARPS;

// x (two bf16) times (wa, wb) in f32, as a bf16 hi + lo pair
__device__ __forceinline__ void scaled(uint32_t x, float wa, float wb,
                                       uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const float a = f.x * wa, b = f.y * wb;
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// DKP: Dk padded (32, 64 or 128); DVT: the block's Dv columns (32 or 64)
template <int DKP, int DVT>
__global__ void __launch_bounds__(THREADS)
linear_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const float* __restrict__ log_decay, bf16* __restrict__ out,
                 float* __restrict__ state, int T, int Dk, int Dv, int vec) {
  constexpr int LDK = DKP + 8;      // ldmatrix's 8 rows in distinct banks
  constexpr int LDV = DVT + 8;
  constexpr int KC = DKP / 16;      // 16-deep chunks of Q K^T and Q S
  constexpr int VB = DVT / 8;       // 8-wide column blocks of O and S
  constexpr int MT = (DKP + 16 * WARPS - 1) / (16 * WARPS);  // S row tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [2][C][LDK]
  bf16* Ks = Qs + 2 * C * LDK;                    // [2][C][LDK]
  bf16* Vs = Ks + 2 * C * LDK;                    // [2][C][LDV]
  bf16* Shi = Vs + 2 * C * LDV;                   // [DKP][LDV]
  bf16* Slo = Shi + DKP * LDV;                    // [DKP][LDV]
  float* cum = reinterpret_cast<float*>(Slo + DKP * LDV);  // [WARPS][C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y, dv0 = blockIdx.x * DVT;
  const int vcols = min(DVT, Dv - dv0);
  const long long row0 = (long long)bh * T;
  const bf16* qh = q + row0 * Dk;
  const bf16* kh = k + row0 * Dk;
  const bf16* vh = v + row0 * Dv + dv0;
  const float* ldh = log_decay + row0;
  bf16* oh = out + row0 * Dv + dv0;
  float* wcum = cum + warp * C;     // this warp's own scan

  // padding columns and S start at zero; no copy ever writes them
  {
    constexpr int words = (2 * C * (2 * LDK + LDV) + 2 * DKP * LDV) / 2;
    uint32_t* z = reinterpret_cast<uint32_t*>(smem_raw);
    for (int i = tid; i < words; i += THREADS) z[i] = 0u;
  }
  __syncthreads();
  load_rows<C, THREADS>(Qs, LDK, qh, Dk, 0, T, Dk, vec);
  load_rows<C, THREADS>(Ks, LDK, kh, Dk, 0, T, Dk, vec);
  load_rows<C, THREADS>(Vs, LDV, vh, Dv, 0, T, vcols, vec);
  cp_async_commit();

  const int ra = warp * 16 + g, rb = ra + 8;      // this lane's query rows
  float sf[MT][VB][4];              // S rows 16 (warp + WARPS mt) + g (+ 8)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < VB; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[mt][d][e] = 0.0f;

  const int chunks = (T + C - 1) / C;
  // this lane's two log-decays of a chunk, one chunk ahead
  float la = 2 * lane < T ? ldh[2 * lane] : 0.0f;
  float lb = 2 * lane + 1 < T ? ldh[2 * lane + 1] : 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, t0 = c * C;
    const float ld_a = la, ld_b = lb;
    const int tn = t0 + C + 2 * lane;
    la = tn < T ? ldh[tn] : 0.0f;
    lb = tn + 1 < T ? ldh[tn + 1] : 0.0f;
    if (c + 1 < chunks) {
      const int nxt = buf ^ 1, r1 = t0 + C;
      load_rows<C, THREADS>(Qs + nxt * C * LDK, LDK, qh, Dk, r1, T, Dk, vec);
      load_rows<C, THREADS>(Ks + nxt * C * LDK, LDK, kh, Dk, r1, T, Dk, vec);
      load_rows<C, THREADS>(Vs + nxt * C * LDV, LDV, vh, Dv, r1, T, vcols,
                            vec);
      cp_async_commit();
      cp_async_wait<1>();           // chunk c has landed, c + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // chunk c's tiles and S are whole

    // inclusive scan of the chunk's log-decays, lane l owning steps 2l, 2l+1
    const float total = scan_pair(ld_a, ld_b, lane, wcum);
    __syncwarp();
    const bf16* Qt = Qs + buf * C * LDK;
    const bf16* Kt = Ks + buf * C * LDK;
    const bf16* Vt = Vs + buf * C * LDV;

    uint32_t qf[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[kc], Qt + (warp * 16 + lane % 16) * LDK + kc * 16 +
                          (lane / 16) * 8);

    // scores Q K^T for this warp's 16 rows; keys past its last row skipped
    float s[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        if (n2 > warp) continue;
        uint32_t r[4];
        ldsm_x4(r, Kt + (n2 * 16 + lane % 8 + 8 * (lane / 16)) * LDK +
                       kc * 16 + 8 * ((lane / 8) % 2));
        mma(s[2 * n2], qf[kc], r[0], r[1]);
        mma(s[2 * n2 + 1], qf[kc], r[2], r[3]);
      }
    }

    // A = scores * exp(cum_i - cum_j) for j <= i as a bf16 hi + lo pair,
    // packed as the A fragments of A V: 16-step chunk c2 takes blocks 2 c2
    // and 2 c2 + 1
    const float ca = wcum[ra], cb = wcum[rb];
    uint32_t pa[C / 16][4], pl[C / 16][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const int j = n * 8 + 2 * t4;
      const float c0 = wcum[j], c1 = wcum[j + 1];
      const float a0 = j <= ra ? s[n][0] * __expf(ca - c0) : 0.0f;
      const float a1 = j + 1 <= ra ? s[n][1] * __expf(ca - c1) : 0.0f;
      const float a2 = j <= rb ? s[n][2] * __expf(cb - c0) : 0.0f;
      const float a3 = j + 1 <= rb ? s[n][3] * __expf(cb - c1) : 0.0f;
      const __nv_bfloat162 ha = __floats2bfloat162_rn(a0, a1);
      const __nv_bfloat162 hb = __floats2bfloat162_rn(a2, a3);
      pa[n / 2][(n & 1) * 2] = bits(ha);
      pa[n / 2][(n & 1) * 2 + 1] = bits(hb);
      pl[n / 2][(n & 1) * 2] = bits(__floats2bfloat162_rn(
          a0 - __low2float(ha), a1 - __high2float(ha)));
      pl[n / 2][(n & 1) * 2 + 1] = bits(__floats2bfloat162_rn(
          a2 - __low2float(hb), a3 - __high2float(hb)));
    }

    // O = exp(cum_i) (Q S_hi + Q S_lo) + A V
    float o[VB][4];
#pragma unroll
    for (int d = 0; d < VB; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int d2 = 0; d2 < VB / 2; ++d2) {
        const int at = (kc * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDV +
                       d2 * 16 + 8 * (lane / 16);
        uint32_t r[4];
        ldsm_x4_t(r, Shi + at);
        mma(o[2 * d2], qf[kc], r[0], r[1]);
        mma(o[2 * d2 + 1], qf[kc], r[2], r[3]);
        ldsm_x4_t(r, Slo + at);
        mma(o[2 * d2], qf[kc], r[0], r[1]);
        mma(o[2 * d2 + 1], qf[kc], r[2], r[3]);
      }
    }
    const float ea = __expf(ca), eb = __expf(cb);
#pragma unroll
    for (int d = 0; d < VB; ++d) {
      o[d][0] *= ea;
      o[d][1] *= ea;
      o[d][2] *= eb;
      o[d][3] *= eb;
    }
#pragma unroll
    for (int c2 = 0; c2 < C / 16; ++c2) {
      if (c2 > warp) continue;
#pragma unroll
      for (int d2 = 0; d2 < VB / 2; ++d2) {
        uint32_t r[4];
        ldsm_x4_t(r, Vt + (c2 * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDV +
                         d2 * 16 + 8 * (lane / 16));
        mma(o[2 * d2], pa[c2], r[0], r[1]);
        mma(o[2 * d2 + 1], pa[c2], r[2], r[3]);
        mma(o[2 * d2], pl[c2], r[0], r[1]);
        mma(o[2 * d2 + 1], pl[c2], r[2], r[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + (h == 0 ? ra : rb);
      if (t >= T) continue;
      bf16* orow = oh + (long long)t * Dv;
#pragma unroll
      for (int d = 0; d < VB; ++d) {
        const int col = d * 8 + 2 * t4;
        const float x = o[d][2 * h], y = o[d][2 * h + 1];
        if (Dv % 2 == 0) {
          if (col < vcols)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(x, y);
        } else {
          if (col < vcols) orow[col] = __float2bfloat16(x);
          if (col + 1 < vcols) orow[col + 1] = __float2bfloat16(y);
        }
      }
    }

    // S <- exp(total) S + (K o w)^T V, w_j = exp(total - cum_j); the A
    // operand is K read transposed: its rows are key dims, columns steps
    float w[C / 16][4];
#pragma unroll
    for (int c2 = 0; c2 < C / 16; ++c2) {
      const int j = c2 * 16 + 2 * t4;
      w[c2][0] = __expf(total - wcum[j]);
      w[c2][1] = __expf(total - wcum[j + 1]);
      w[c2][2] = __expf(total - wcum[j + 8]);
      w[c2][3] = __expf(total - wcum[j + 9]);
    }
    const float et = __expf(total);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = 16 * (warp + WARPS * mt);
      if (m0 >= DKP) continue;
#pragma unroll
      for (int d = 0; d < VB; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) sf[mt][d][e] *= et;
#pragma unroll
      for (int c2 = 0; c2 < C / 16; ++c2) {
        uint32_t ak[4], hi[4], lo[4];
        ldsm_x4_t(ak, Kt + (c2 * 16 + lane % 8 + 8 * (lane / 16)) * LDK + m0 +
                          8 * ((lane / 8) % 2));
        scaled(ak[0], w[c2][0], w[c2][1], hi[0], lo[0]);
        scaled(ak[1], w[c2][0], w[c2][1], hi[1], lo[1]);
        scaled(ak[2], w[c2][2], w[c2][3], hi[2], lo[2]);
        scaled(ak[3], w[c2][2], w[c2][3], hi[3], lo[3]);
#pragma unroll
        for (int d2 = 0; d2 < VB / 2; ++d2) {
          uint32_t r[4];
          ldsm_x4_t(r, Vt + (c2 * 16 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                LDV + d2 * 16 + 8 * (lane / 16));
          mma(sf[mt][2 * d2], hi, r[0], r[1]);
          mma(sf[mt][2 * d2 + 1], hi, r[2], r[3]);
          mma(sf[mt][2 * d2], lo, r[0], r[1]);
          mma(sf[mt][2 * d2 + 1], lo, r[2], r[3]);
        }
      }
    }
    __syncthreads();                // every warp is done with S and the tiles

    // S as hi + lo for the next chunk's Q S
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = 16 * (warp + WARPS * mt);
      if (m0 >= DKP) continue;
#pragma unroll
      for (int d = 0; d < VB; ++d) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (m0 + g + 8 * h) * LDV + d * 8 + 2 * t4;
          const float x = sf[mt][d][2 * h], y = sf[mt][d][2 * h + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          *reinterpret_cast<__nv_bfloat162*>(Shi + at) = hi;
          *reinterpret_cast<__nv_bfloat162*>(Slo + at) = __floats2bfloat162_rn(
              x - __low2float(hi), y - __high2float(hi));
        }
      }
    }
  }

  if (state != nullptr) {           // this warp's rows of the f32 S
    float* sh = state + (long long)bh * Dk * Dv + dv0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = 16 * (warp + WARPS * mt);
      if (m0 >= DKP) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + g + 8 * h;
        if (row >= Dk) continue;
#pragma unroll
        for (int d = 0; d < VB; ++d) {
          const int col = d * 8 + 2 * t4;
          if (col < vcols) sh[(long long)row * Dv + col] = sf[mt][d][2 * h];
          if (col + 1 < vcols)
            sh[(long long)row * Dv + col + 1] = sf[mt][d][2 * h + 1];
        }
      }
    }
  }
}

template <int DKP, int DVT>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* ld,
           bf16* out, float* state, int BH, int T, int Dk, int Dv,
           cudaStream_t stream) {
  constexpr int bytes =
      (int)sizeof(bf16) * (2 * C * (2 * (DKP + 8) + DVT + 8) +
                           2 * DKP * (DVT + 8)) +
      (int)sizeof(float) * WARPS * C;
  static const cudaError_t attr = cudaFuncSetAttribute(
      linear_tc_kernel<DKP, DVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = Dk % 8 == 0 && Dv % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const dim3 grid((Dv + DVT - 1) / DVT, BH);
  linear_tc_kernel<DKP, DVT><<<grid, THREADS, bytes, stream>>>(
      q, k, v, ld, out, state, T, Dk, Dv, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v,
             const void* log_decay, void* out, void* state, int BH, int T,
             int Dk, int Dv, int dv_tile, void* stream) {
  if (BH <= 0 || T <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > DKMAX || (dv_tile != 32 && dv_tile != 64) ||
      (Dk > 64 && dv_tile != 32))
    return (int)cudaErrorInvalidValue;
  const bf16 *Q = (const bf16*)q, *K = (const bf16*)k, *V = (const bf16*)v;
  const float* L = (const float*)log_decay;
  bf16* O = (bf16*)out;
  float* S = (float*)state;
  cudaStream_t s = (cudaStream_t)stream;
#define LINEAR_TC(DKP, DVT) \
  launch<DKP, DVT>(Q, K, V, L, O, S, BH, T, Dk, Dv, s)
  if (Dk > 64) return LINEAR_TC(128, 32);
  if (Dk > 32) return dv_tile == 64 ? LINEAR_TC(64, 64) : LINEAR_TC(64, 32);
  return dv_tile == 64 ? LINEAR_TC(32, 64) : LINEAR_TC(32, 32);
#undef LINEAR_TC
}

}  // namespace tensor_core

// ---- Dk > 128 (xLSTM's 1024-wide heads) -----------------------------------
namespace wide {

constexpr int DKW = 1024;     // the widest key dim

// -- f32: two passes on the CUDA cores --------------------------------------
constexpr int THREADS = 256;
constexpr int DKT = 64;       // key dims per streamed tile of Q and K
constexpr int DVT = 32;       // Dv columns per block of the state pass

// Pass 1, one block per (chunk, head): the chunk's decayed causal scores
// A_ij = (q_i . k_j) exp(cum_i - cum_j) for i >= j (else 0), Q and K
// streamed through in tiles of DKT key dims, into A (BH, chunks, C, C).
__global__ void __launch_bounds__(THREADS)
scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ log_decay, float* __restrict__ A,
              int seq, int Dk) {
  __shared__ float qs[C][DKT + 1];
  __shared__ float ks[C][DKT + 1];
  __shared__ double cum[C];
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, bh = blockIdx.y, t0 = chunk * C;
  const long long row0 = (long long)bh * seq;
  const float* qh = q + row0 * Dk;
  const float* kh = k + row0 * Dk;
  if (tid < 32)
    scan_chunk(log_decay + row0, t0, seq, cum, nullptr, nullptr, nullptr);

  const int ti = tid >> 4, tj = tid & 15;
  float s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
  for (int d0 = 0; d0 < Dk; d0 += DKT) {
    __syncthreads();                   // the last tile is consumed
    for (int i = tid; i < C * DKT; i += THREADS) {
      const int r = i / DKT, d = i % DKT, t = t0 + r, dd = d0 + d;
      const bool in = t < seq && dd < Dk;
      const long long g = (long long)t * Dk + dd;
      qs[r][d] = in ? qh[g] : 0.0f;
      ks[r][d] = in ? kh[g] : 0.0f;
    }
    __syncthreads();
    for (int e0 = 0; e0 < DKT; e0 += DSUM) {
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[r][c] = 0.0f;
#pragma unroll 4
      for (int d = e0; d < e0 + DSUM; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[ti * 4 + r][d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ks[tj + 16 * c][d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = fmaf(a[r], b[c], p[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += p[r][c];
    }
  }
  float* Ah = A + ((long long)bh * gridDim.x + chunk) * C * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      Ah[i * C + j] =
          i >= j ? s[r][c] * expf((float)(cum[i] - cum[j])) : 0.0f;
    }
  }
}

// Pass 2, one block per (Dv tile of DVT columns, head), walking the chunks
// in order with the (Dk, DVT) f32 state S in shared memory. Per chunk:
// o_i = sum_j A_ij v_j + exp(cum_i) (q_i . S), then S <- exp(total) S +
// sum_j (k_j w_j)^T v_j; Q and K stream through in tiles of DKT key dims,
// and each tile's rows of S are read for the outputs before they are
// updated. Thread (tr, tc) owns rows tr and tr + 32 (of the chunk, and of
// each tile of S) and the 4 adjacent columns 4 tc .. 4 tc + 3.
__global__ void __launch_bounds__(THREADS)
state_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ log_decay,
             const float* __restrict__ A, float* __restrict__ out, int seq,
             int Dk, int Dv) {
  extern __shared__ __align__(16) float smem_w[];
  constexpr int LDA = C + 1, LDT = DKT + 1;
  float* S = smem_w;                   // [Dk][DVT]
  float* vs = S + Dk * DVT;            // [C][DVT]
  float* As = vs + C * DVT;            // [C][LDA]
  float* qs = As + C * LDA;            // [C][LDT]
  float* kw = qs + C * LDT;            // [C][LDT]: k_j w_j
  double* cum = reinterpret_cast<double*>(kw + C * LDT);  // [C], f64
  float* ecum = reinterpret_cast<float*>(cum + C);        // [C]
  float* w = ecum + C;                 // [C]
  float* etotal = w + C;               // [1]

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int bh = blockIdx.y, dv0 = blockIdx.x * DVT;
  const int chunks = (seq + C - 1) / C;
  const long long row0 = (long long)bh * seq;
  const float* qh = q + row0 * Dk;
  const float* kh = k + row0 * Dk;
  const float* vh = v + row0 * Dv;
  const float* ldh = log_decay + row0;
  float* oh = out + row0 * Dv;

  for (int i = tid; i < Dk * DVT; i += THREADS) S[i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * C;
    __syncthreads();                   // the last chunk is done with all
    const float* Ac = A + ((long long)bh * chunks + c) * C * C;
    for (int i = tid; i < C * C; i += THREADS)
      As[(i / C) * LDA + i % C] = Ac[i];
    for (int i = tid; i < C * DVT; i += THREADS) {
      const int r = i / DVT, col = dv0 + i % DVT, t = t0 + r;
      vs[i] = (t < seq && col < Dv) ? vh[(long long)t * Dv + col] : 0.0f;
    }
    if (tid < 32) scan_chunk(ldh, t0, seq, cum, ecum, w, etotal);
    __syncthreads();

    float o[2][4], inter[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] = inter[r][e] = 0.0f;
    // intra-chunk: A V (A is 0 above the diagonal)
    for (int j = 0; j < C; ++j) {
      const float a0 = As[tr * LDA + j], a1 = As[(tr + 32) * LDA + j];
      const float4 b = *reinterpret_cast<const float4*>(vs + j * DVT + 4 * tc);
      o[0][0] = fmaf(a0, b.x, o[0][0]);
      o[0][1] = fmaf(a0, b.y, o[0][1]);
      o[0][2] = fmaf(a0, b.z, o[0][2]);
      o[0][3] = fmaf(a0, b.w, o[0][3]);
      o[1][0] = fmaf(a1, b.x, o[1][0]);
      o[1][1] = fmaf(a1, b.y, o[1][1]);
      o[1][2] = fmaf(a1, b.z, o[1][2]);
      o[1][3] = fmaf(a1, b.w, o[1][3]);
    }
    const float decay = *etotal;
    for (int d0 = 0; d0 < Dk; d0 += DKT) {
      for (int i = tid; i < C * DKT; i += THREADS) {
        const int r = i / DKT, d = i % DKT, t = t0 + r, dd = d0 + d;
        const bool in = t < seq && dd < Dk;
        const long long g = (long long)t * Dk + dd;
        qs[r * LDT + d] = in ? qh[g] : 0.0f;
        kw[r * LDT + d] = in ? kh[g] * w[r] : 0.0f;
      }
      __syncthreads();                 // the tiles are whole
      // the carried state's part of the outputs, from this tile's rows
      const int dmax = min(DKT, Dk - d0);
      for (int e0 = 0; e0 < dmax; e0 += DSUM) {
        float p[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[r][e] = 0.0f;
        const int dend = min(e0 + DSUM, dmax);
        for (int d = e0; d < dend; ++d) {
          const float a0 = qs[tr * LDT + d], a1 = qs[(tr + 32) * LDT + d];
          const float4 b =
              *reinterpret_cast<const float4*>(S + (d0 + d) * DVT + 4 * tc);
          p[0][0] = fmaf(a0, b.x, p[0][0]);
          p[0][1] = fmaf(a0, b.y, p[0][1]);
          p[0][2] = fmaf(a0, b.z, p[0][2]);
          p[0][3] = fmaf(a0, b.w, p[0][3]);
          p[1][0] = fmaf(a1, b.x, p[1][0]);
          p[1][1] = fmaf(a1, b.y, p[1][1]);
          p[1][2] = fmaf(a1, b.z, p[1][2]);
          p[1][3] = fmaf(a1, b.w, p[1][3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) inter[r][e] += p[r][e];
      }
      // this tile's rows of (K o w)^T V
      float u[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[r][e] = 0.0f;
      for (int j = 0; j < C; ++j) {
        const float a0 = kw[j * LDT + tr], a1 = kw[j * LDT + tr + 32];
        const float4 b = *reinterpret_cast<const float4*>(vs + j * DVT + 4 * tc);
        u[0][0] = fmaf(a0, b.x, u[0][0]);
        u[0][1] = fmaf(a0, b.y, u[0][1]);
        u[0][2] = fmaf(a0, b.z, u[0][2]);
        u[0][3] = fmaf(a0, b.w, u[0][3]);
        u[1][0] = fmaf(a1, b.x, u[1][0]);
        u[1][1] = fmaf(a1, b.y, u[1][1]);
        u[1][2] = fmaf(a1, b.z, u[1][2]);
        u[1][3] = fmaf(a1, b.w, u[1][3]);
      }
      __syncthreads();                 // every read of S's tile rows is done
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = d0 + tr + 32 * r;
        if (d >= Dk) continue;
        float4* sp = reinterpret_cast<float4*>(S + d * DVT + 4 * tc);
        float4 x = *sp;
        x.x = fmaf(decay, x.x, u[r][0]);
        x.y = fmaf(decay, x.y, u[r][1]);
        x.z = fmaf(decay, x.z, u[r][2]);
        x.w = fmaf(decay, x.w, u[r][3]);
        *sp = x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tr + 32 * r, t = t0 + i;
      if (t >= seq) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = dv0 + 4 * tc + e;
        if (col < Dv)
          oh[(long long)t * Dv + col] = o[r][e] + ecum[i] * inter[r][e];
      }
    }
  }
}

constexpr size_t state_bytes(int Dk) {
  return sizeof(float) * ((size_t)Dk * DVT + C * DVT + C * (C + 1) +
                          2 * C * (DKT + 1) + 4 * C + 1);   // cum is f64
}

int launch_f32(const float* q, const float* k, const float* v,
               const float* ld, float* scores, float* out, int BH, int seq,
               int Dk, int Dv, cudaStream_t stream) {
  // once, for the widest key dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)state_bytes(DKW));
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (seq + C - 1) / C;
  scores_kernel<<<dim3(chunks, BH), THREADS, 0, stream>>>(q, k, ld, scores,
                                                           seq, Dk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  state_kernel<<<dim3((Dv + DVT - 1) / DVT, BH), THREADS, state_bytes(Dk),
                 stream>>>(q, k, v, ld, scores, out, seq, Dk, Dv);
  return (int)cudaGetLastError();
}

// -- bf16: the tensor cores, the state split over a cluster -----------------
using namespace ::tc;
constexpr int WARPS = 4;
constexpr int TCT = 32 * WARPS;
constexpr int ST = 64;        // key dims per streamed tile of the scores pass
constexpr int KS = 128;       // key dims of a state block (its cluster rank)
constexpr int VT = 16 * WARPS;  // value columns of a state block, 16 a warp
constexpr int RANKS = DKW / KS;   // the most key slices, a cluster's blocks

// (a, b) as a bf16 hi + lo pair of bf16x2 words
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// Rows [r0, r0 + C) x columns [c0, c0 + W) of a (T, cols) bf16 matrix into
// a tile of row stride ld, zero past T and past cols: 16-byte `cp.async`
// (vec: cols a multiple of 8, the base 16-byte aligned) or element by
// element.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int cols, int r0, int c0, int T,
                                          bool vec) {
  if (vec) {
    constexpr int CH = W / 8;
    for (int i = threadIdx.x; i < C * CH; i += TCT) {
      const int r = i / CH, c = 8 * (i % CH);
      const bool ok = r0 + r < T && c0 + c < cols;
      cp_async16(dst + r * ld + c,
                 ok ? src + (long long)(r0 + r) * cols + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {             // 32 loads a thread in flight, then their stores
    constexpr int N = 32;
    static_assert(C * W % (N * TCT) == 0, "whole rounds of loads");
    for (int i0 = threadIdx.x; i0 < C * W; i0 += N * TCT) {
      bf16 x[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int i = i0 + u * TCT, r = i / W, c = i % W;
        x[u] = r0 + r < T && c0 + c < cols
                   ? src[(long long)(r0 + r) * cols + c0 + c]
                   : __float2bfloat16(0.0f);
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int i = i0 + u * TCT;
        dst[(i / W) * ld + i % W] = x[u];
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// the float2 at `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float2 ld_rank(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(saddr(p)), "r"(rank));
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y) : "r"(a) : "memory");
  return x;
}

// Pass 1 (bf16), one block of 4 warps per (chunk, head): S_ij = q_i . k_j
// on the tensor cores, Q and K streamed through in tiles of ST key dims (a
// 2-stage `cp.async` ring); each warp owns 16 query rows and skips the key
// tiles past them. Writes A_ij = S_ij exp(cum_i - cum_j) for i >= j, else
// 0, to A (BH, chunks, C, C) in f32.
__global__ void __launch_bounds__(TCT)
scores_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const float* __restrict__ log_decay, float* __restrict__ A,
                 int T, int Dk, int vec) {
  constexpr int LDS = ST + 8;
  __shared__ __align__(16) bf16 Qs[2][C][LDS];
  __shared__ __align__(16) bf16 Ks[2][C][LDS];
  __shared__ float cum[WARPS][C];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int chunk = blockIdx.x, bh = blockIdx.y, t0 = chunk * C;
  const long long row0 = (long long)bh * T;
  const bf16* qh = q + row0 * Dk;
  const bf16* kh = k + row0 * Dk;
  const int tiles = (Dk + ST - 1) / ST;

  load_tile<ST>(&Qs[0][0][0], LDS, qh, Dk, t0, 0, T, vec);
  load_tile<ST>(&Ks[0][0][0], LDS, kh, Dk, t0, 0, T, vec);
  cp_async_commit();
  float s[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < tiles) {
      const int c0 = (kt + 1) * ST;
      load_tile<ST>(&Qs[buf ^ 1][0][0], LDS, qh, Dk, t0, c0, T, vec);
      load_tile<ST>(&Ks[buf ^ 1][0][0], LDS, kh, Dk, t0, c0, T, vec);
      cp_async_commit();
      cp_async_wait<1>();              // tile kt has landed, kt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < ST / 16; ++kc) {
      uint32_t qf[4];
      ldsm_x4(qf, &Qs[buf][warp * 16 + lane % 16][kc * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        if (n2 > warp) continue;
        uint32_t r[4];
        ldsm_x4(r, &Ks[buf][n2 * 16 + lane % 8 + 8 * (lane / 16)]
                      [kc * 16 + 8 * ((lane / 8) % 2)]);
        mma(s[2 * n2], qf, r[0], r[1]);
        mma(s[2 * n2 + 1], qf, r[2], r[3]);
      }
    }
    __syncthreads();                   // tile kt is consumed before refill
  }

  const float* ldh = log_decay + row0;
  const int ta = t0 + 2 * lane;
  scan_pair(ta < T ? ldh[ta] : 0.0f, ta + 1 < T ? ldh[ta + 1] : 0.0f, lane,
            cum[warp]);
  __syncwarp();
  const int ra = warp * 16 + g, rb = ra + 8;
  const float ca = cum[warp][ra], cb = cum[warp][rb];
  float* Ah = A + ((long long)bh * gridDim.x + chunk) * C * C;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    const int j = n * 8 + 2 * t4;
    const float c0 = cum[warp][j], c1 = cum[warp][j + 1];
    *reinterpret_cast<float2*>(Ah + ra * C + j) = make_float2(
        j <= ra ? s[n][0] * __expf(ca - c0) : 0.0f,
        j + 1 <= ra ? s[n][1] * __expf(ca - c1) : 0.0f);
    *reinterpret_cast<float2*>(Ah + rb * C + j) = make_float2(
        j <= rb ? s[n][2] * __expf(cb - c0) : 0.0f,
        j + 1 <= rb ? s[n][3] * __expf(cb - c1) : 0.0f);
  }
}

// Pass 2 (bf16), one block of 4 warps per (key slice of KS dims, value tile
// of VT columns, head); the ceil(Dk / KS) key slices of a (value tile,
// head) form one thread-block cluster, the block's rank its slice. Warp w
// owns the value columns 16 w .. 16 w + 15 of the tile and keeps its share
// of the state transposed, S^T (16 columns x KS keys, f32), in accumulator
// fragments across all chunks. Per chunk:
//   P = S^T Q^T, the slice's partial of (Q S)^T, with S^T entering as a
//     bf16 hi + lo pair straight from the accumulators (their layout is
//     the A operand's), Q by `ldmatrix`;
//   S^T <- exp(total) S^T + (V o w)^T K, V by `ldmatrix.trans` scaled by
//     w_j = exp(total - cum_j) and split into hi + lo, K by
//     `ldmatrix.trans` as it is;
//   the cluster sums P over the slices through distributed shared memory:
//     rank r takes the 8-step output tiles n = r, r + ranks, ..., forms
//     their A V (A from pass 1 as hi + lo, V as it is) while the other
//     ranks finish, then adds the ranks' partials in rank order, scales
//     by exp(cum_i), adds A V and writes bf16.
// One cluster barrier a chunk, split into its arrive (once this rank's P
// is written) and its wait (before the partials are read), with the update
// and A V between. P is double-buffered: a rank rewrites a buffer two
// chunks on, after its wait of the chunk between, which every rank reaches
// only once it has read that buffer. Warps whose columns all lie past Dv
// skip their products but keep the barriers. K (and V when Dv is a
// multiple of 8) arrive by 16-byte `cp.async` into a 2-stage ring, chunk
// c + 1 in flight while c computes; Q has one stage, refilled for c + 1
// once every warp has read it (after P), so that two P buffers fit beside
// the tiles at 2 blocks an SM. Otherwise V is loaded 2 bytes an element
// into the free stage after the update.
__global__ void __launch_bounds__(TCT, 2)
state_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v,
                const float* __restrict__ log_decay,
                const float* __restrict__ A, bf16* __restrict__ out, int T,
                int Dk, int Dv, int vec_qk, int vec_v) {
  constexpr int LDK = KS + 8, LDV = VT + 8, LDP = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // [C][LDK]
  bf16* Ks = Qs + C * LDK;                         // [2][C][LDK]
  bf16* Vs = Ks + 2 * C * LDK;                     // [2][C][LDV]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * C * LDV);  // [2][VT][LDP]
  float* cum = Ps + 2 * VT * LDP;                  // [WARPS][C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int k0 = rank * KS, dv0 = blockIdx.y * VT, bh = blockIdx.z;
  const bool active = dv0 + 16 * warp < Dv;
  const int chunks = (T + C - 1) / C;
  const long long row0 = (long long)bh * T;
  const bf16* qh = q + row0 * Dk;
  const bf16* kh = k + row0 * Dk;
  const bf16* vh = v + row0 * Dv;
  const float* ldh = log_decay + row0;
  const float* Ab = A + (long long)bh * chunks * C * C;  // this head's
  bf16* oh = out + row0 * Dv;
  float* wcum = cum + warp * C;

  load_tile<KS>(Qs, LDK, qh, Dk, 0, k0, T, vec_qk);
  load_tile<KS>(Ks, LDK, kh, Dk, 0, k0, T, vec_qk);
  load_tile<VT>(Vs, LDV, vh, Dv, 0, dv0, T, vec_v);
  cp_async_commit();

  float sf[KS / 8][4];                  // S^T: columns g (+ 8), keys 8 n + 2 t4
#pragma unroll
  for (int n = 0; n < KS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sf[n][e] = 0.0f;
  float la = 2 * lane < T ? ldh[2 * lane] : 0.0f;
  float lb = 2 * lane + 1 < T ? ldh[2 * lane + 1] : 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, t0 = c * C;
    const float ld_a = la, ld_b = lb;
    const int tn = t0 + C + 2 * lane;
    la = tn < T ? ldh[tn] : 0.0f;
    lb = tn + 1 < T ? ldh[tn + 1] : 0.0f;
    const bool more = c + 1 < chunks;
    if (more) {                         // K and V of c + 1 (Q follows P)
      const int nxt = buf ^ 1, r1 = t0 + C;
      load_tile<KS>(Ks + nxt * C * LDK, LDK, kh, Dk, r1, k0, T, vec_qk);
      if (vec_v)
        load_tile<VT>(Vs + nxt * C * LDV, LDV, vh, Dv, r1, dv0, T, true);
      cp_async_commit();
      cp_async_wait<1>();               // chunk c has landed, c + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // chunk c's tiles are whole

    const float total = scan_pair(ld_a, ld_b, lane, wcum);
    __syncwarp();
    const bf16* Kt = Ks + buf * C * LDK;
    const bf16* Vt = Vs + buf * C * LDV;
    // this lane's rows of V^T as an A fragment, 16-step chunk kc
    auto v_frag = [&](uint32_t (&a)[4], int kc) {
      ldsm_x4_t(a, Vt + (kc * 16 + lane % 8 + 8 * (lane / 16)) * LDV +
                       16 * warp + 8 * ((lane / 8) % 2));
    };

    // P = (S^T_hi + S^T_lo) Q^T: columns g (+ 8), steps 8 n + 2 t4 (+ 1)
    float p[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = 0.0f;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t ah[4], al[4];
        split2(sf[2 * kk][0], sf[2 * kk][1], ah[0], al[0]);
        split2(sf[2 * kk][2], sf[2 * kk][3], ah[1], al[1]);
        split2(sf[2 * kk + 1][0], sf[2 * kk + 1][1], ah[2], al[2]);
        split2(sf[2 * kk + 1][2], sf[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int n2 = 0; n2 < C / 16; ++n2) {
          uint32_t r[4];
          ldsm_x4(r, Qs + (n2 * 16 + lane % 8 + 8 * (lane / 16)) * LDK +
                         kk * 16 + 8 * ((lane / 8) % 2));
          mma(p[2 * n2], ah, r[0], r[1]);
          mma(p[2 * n2], al, r[0], r[1]);
          mma(p[2 * n2 + 1], ah, r[2], r[3]);
          mma(p[2 * n2 + 1], al, r[2], r[3]);
        }
      }
    }
    float* Pc = Ps + buf * VT * LDP;    // free: every rank read it before
    if (active) {                       // chunk c - 1's arrive
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              Pc + (16 * warp + g + 8 * h) * LDP + 8 * n + 2 * t4) =
              make_float2(p[n][2 * h], p[n][2 * h + 1]);
    }
    cluster_arrive();
    __syncthreads();                    // every warp has read Q
    if (more) {
      load_tile<KS>(Qs, LDK, qh, Dk, t0 + C, k0, T, vec_qk);
      cp_async_commit();
    }

    // S^T <- exp(total) S^T + (V o w)^T K
    if (active) {
      const float et = __expf(total);
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sf[n][e] *= et;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        const int j = kc * 16 + 2 * t4;
        const float w0 = __expf(total - wcum[j]);
        const float w1 = __expf(total - wcum[j + 1]);
        const float w8 = __expf(total - wcum[j + 8]);
        const float w9 = __expf(total - wcum[j + 9]);
        uint32_t a[4], hi[4], lo[4];
        v_frag(a, kc);
        tensor_core::scaled(a[0], w0, w1, hi[0], lo[0]);
        tensor_core::scaled(a[1], w0, w1, hi[1], lo[1]);
        tensor_core::scaled(a[2], w8, w9, hi[2], lo[2]);
        tensor_core::scaled(a[3], w8, w9, hi[3], lo[3]);
#pragma unroll
        for (int n2 = 0; n2 < KS / 16; ++n2) {
          uint32_t r[4];
          ldsm_x4_t(r, Kt + (kc * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDK +
                           n2 * 16 + 8 * (lane / 16));
          mma(sf[2 * n2], hi, r[0], r[1]);
          mma(sf[2 * n2], lo, r[0], r[1]);
          mma(sf[2 * n2 + 1], hi, r[2], r[3]);
          mma(sf[2 * n2 + 1], lo, r[2], r[3]);
        }
      }
    }
    // A V for this rank's output tiles n = rank, rank + ranks, ... (at most
    // 4: ranks >= 2), A from pass 1 as hi + lo, while other ranks finish
    // their partials
    float av[C / 16][4];
#pragma unroll
    for (int m = 0; m < C / 16; ++m) {
      const int n = rank + m * ranks;
#pragma unroll
      for (int e = 0; e < 4; ++e) av[m][e] = 0.0f;
      if (!active || n >= C / 8 || t0 + 8 * n >= T) continue;
      const float* arow = Ab + ((long long)c * C + 8 * n + g) * C + 2 * t4;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        if (kc * 16 > 8 * n + 7) continue;     // A is 0 past the diagonal
        const float2 x = *reinterpret_cast<const float2*>(arow + 16 * kc);
        const float2 y = *reinterpret_cast<const float2*>(arow + 16 * kc + 8);
        uint32_t a[4], bh0, bl0, bh1, bl1;
        split2(x.x, x.y, bh0, bl0);
        split2(y.x, y.y, bh1, bl1);
        v_frag(a, kc);
        mma(av[m], a, bh0, bh1);
        mma(av[m], a, bl0, bl1);
      }
    }
    // V past a row's 16-byte reach (Dv not a multiple of 8: 1025), 2 bytes
    // an element, into the free stage for chunk c + 1
    if (!vec_v && more)
      load_tile<VT>(Vs + (buf ^ 1) * C * LDV, LDV, vh, Dv, t0 + C, dv0, T,
                    false);
    cluster_wait();                     // every rank's P of chunk c is whole

    // this rank's output tiles: the ranks' partials in rank order, times
    // exp(cum_i), plus A V
#pragma unroll
    for (int m = 0; m < C / 16; ++m) {
      const int n = rank + m * ranks;
      if (!active || n >= C / 8 || t0 + 8 * n >= T) continue;
      const float* pa = Pc + (16 * warp + g) * LDP + 8 * n + 2 * t4;
      float2 px[RANKS], py[RANKS];
#pragma unroll
      for (int r = 0; r < RANKS; ++r) {         // every load, then the sums
        if (r >= ranks) continue;
        px[r] = ld_rank(pa, r);
        py[r] = ld_rank(pa + 8 * LDP, r);
      }
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < RANKS; ++r) {
        if (r >= ranks) continue;
        o[0] += px[r].x;
        o[1] += px[r].y;
        o[2] += py[r].x;
        o[3] += py[r].y;
      }
      const int i = 8 * n + 2 * t4;
      const float e0 = __expf(wcum[i]), e1 = __expf(wcum[i + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = dv0 + 16 * warp + g + 8 * h;
        const float y0 = o[2 * h] * e0 + av[m][2 * h];
        const float y1 = o[2 * h + 1] * e1 + av[m][2 * h + 1];
        if (col >= Dv) continue;
        if (t0 + i < T)
          oh[(long long)(t0 + i) * Dv + col] = __float2bfloat16(y0);
        if (t0 + i + 1 < T)
          oh[(long long)(t0 + i + 1) * Dv + col] = __float2bfloat16(y1);
      }
    }
    __syncthreads();                    // chunk c's K and V stage is free
  }
  cluster_arrive();                     // no block leaves while its P is read
  cluster_wait();
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* ld,
                float* scores, bf16* out, int BH, int T, int Dk, int Dv,
                cudaStream_t stream) {
  constexpr int bytes =
      (int)sizeof(bf16) * C * (3 * (KS + 8) + 2 * (VT + 8)) +
      (int)sizeof(float) * (2 * VT * (C + 8) + WARPS * C);
  static const cudaError_t attr = cudaFuncSetAttribute(
      state_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  const int vec_qk = Dk % 8 == 0 && (((uintptr_t)q | (uintptr_t)k) & 15) == 0;
  const int vec_v = Dv % 8 == 0 && ((uintptr_t)v & 15) == 0;
  const int chunks = (T + C - 1) / C;
  scores_tc_kernel<<<dim3(chunks, BH), TCT, 0, stream>>>(q, k, ld, scores, T,
                                                          Dk, vec_qk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Dk + KS - 1) / KS, (Dv + VT - 1) / VT, BH);
  cfg.blockDim = dim3(TCT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cfg.gridDim.x;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, state_tc_kernel, q, k, v, ld, (const float*)scores, out, T, Dk,
      Dv, vec_qk, vec_v);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace wide

}  // namespace

// `state`: null, or a (BH, Dk, Dv) f32 output for each head's final S.
extern "C" int linear_attention_f32(const void* q, const void* k,
                                    const void* v, const void* log_decay,
                                    void* out, void* state, int BH, int seq,
                                    int Dk, int Dv, void* stream) {
  return launch_f32(q, k, v, log_decay, out, state, BH, seq, Dk, Dv, stream);
}

extern "C" int linear_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* log_decay,
                                     void* out, void* state, int BH, int seq,
                                     int Dk, int Dv, int dv_tile,
                                     void* stream) {
  return tensor_core::dispatch(q, k, v, log_decay, out, state, BH, seq, Dk,
                               Dv, dv_tile, stream);
}

// Dk in (128, 1024], f32 or bf16 (`bf16` != 0), with `scores` a (BH,
// ceil(seq / 64), 64, 64) f32 scratch for the chunks' decayed scores.
extern "C" int linear_attention_wide(const void* q, const void* k,
                                     const void* v, const void* log_decay,
                                     void* scores, void* out, int BH,
                                     int seq, int Dk, int Dv, int bf16,
                                     void* stream) {
  if (BH <= 0 || seq <= 0 || Dv <= 0) return 0;
  if (Dk <= DKMAX || Dk > wide::DKW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ld = (const float*)log_decay;
  if (bf16)
    return wide::launch_bf16(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, ld, (float*)scores, (__nv_bfloat16*)out, BH,
        seq, Dk, Dv, s);
  return wide::launch_f32((const float*)q, (const float*)k, (const float*)v,
                          ld, (float*)scores, (float*)out, BH, seq, Dk, Dv,
                          s);
}
