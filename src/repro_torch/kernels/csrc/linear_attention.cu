// Chunked gated linear attention (the Mamba-2 SSD recurrence), with the
// (Dk, Dv) state carried on chip across the chunks of one head.
//
// Replaces the Pallas kernel repro/kernels/linear_attention.py
// `linear_attention` (body `_gla_kernel`). Per head: S_t = exp(ld_t) S_{t-1}
// + k_t^T v_t and o_t = q_t S_t, for q, k (BH, T, Dk), v (BH, T, Dv) (all f32
// or all bf16), log-decays ld (BH, T) f32 (entries <= 0); out (BH, T, Dv) in
// q's type. Dk <= 128, any Dv. The TPU kernel carries S in scratch across a
// sequential grid axis; blocks here run in no order, so one block owns a
// (head, Dv tile) and walks the chunks itself with S on chip. Per chunk of
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
// rows a warp reads fall in distinct banks.
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

__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ log_decay,
                        float* __restrict__ out, int seq, int Dk, int Dv) {
  extern __shared__ float smem[];
  const int ldk = Dk | 1;
  const int lda = C + 1;
  float* qs = smem;                    // [C][ldk]
  float* ks = qs + C * ldk;            // [C][ldk]
  float* vs = ks + C * ldk;            // [C][DVT]
  float* As = vs + C * DVT;            // [C][lda]
  float* S = As + C * lda;             // [Dk][DVT]
  float* cum = S + Dk * DVT;           // [C]
  float* ecum = cum + C;               // [C] exp(cum_i)
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
    if (tid < 32) {                    // inclusive scan of the log-decays
      const int t = t0 + 2 * tid;
      const float a = t < seq ? ldh[t] : 0.0f;
      const float b = t + 1 < seq ? ldh[t + 1] : 0.0f;
      float s = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += up;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) prev = 0.0f;
      cum[2 * tid] = prev + a;
      cum[2 * tid + 1] = s;
      __syncwarp();
      const float total = __shfl_sync(0xffffffffu, s, 31);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * tid + e;
        ecum[j] = expf(cum[j]);
        w[j] = expf(total - cum[j]);
      }
      if (tid == 0) *etotal = expf(total);
    }
    __syncthreads();

    // -- decayed causal scores A (a 4 x 4 micro-tile per thread) -----------
    {
      const int ti = tid >> 4, tj = tid & 15;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
      for (int d = 0; d < Dk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[(ti * 4 + r) * ldk + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ks[(tj + 16 * c) * ldk + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          As[i * lda + j] = i >= j ? s[r][c] * expf(cum[i] - cum[j]) : 0.0f;
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
      for (int d = 0; d < Dk; ++d) {
        float a[2], b[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = qs[(tr + 32 * r) * ldk + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = S[d * DVT + tc + 8 * c];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(a[r], b[c], inter[r][c]);
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
}

int launch_f32(const void* q, const void* k, const void* v,
               const void* log_decay, void* out, int BH, int seq, int Dk,
               int Dv, void* stream) {
  if (BH <= 0 || seq <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > DKMAX) return (int)cudaErrorInvalidValue;
  const int ldk = Dk | 1;
  const size_t bytes = sizeof(float) * (size_t)(2 * C * ldk + C * DVT +
                                                C * (C + 1) + Dk * DVT +
                                                3 * C + 1);
  // once, for the largest key dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      linear_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * (2 * C * (DKMAX | 1) + C * DVT + C * (C + 1) +
                             DKMAX * DVT + 3 * C + 1)));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Dv + DVT - 1) / DVT, BH);
  linear_attention_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)log_decay, (float*)out, seq, Dk, Dv);
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
                 int T, int Dk, int Dv, int vec) {
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
    float total;
    {
      float s = ld_a + ld_b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += up;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) prev = 0.0f;
      wcum[2 * lane] = prev + ld_a;
      wcum[2 * lane + 1] = s;
      total = __shfl_sync(0xffffffffu, s, 31);
      __syncwarp();
    }
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
}

template <int DKP, int DVT>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* ld,
           bf16* out, int BH, int T, int Dk, int Dv, cudaStream_t stream) {
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
      q, k, v, ld, out, T, Dk, Dv, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v,
             const void* log_decay, void* out, int BH, int T, int Dk, int Dv,
             int dv_tile, void* stream) {
  if (BH <= 0 || T <= 0 || Dv <= 0) return 0;
  if (Dk < 1 || Dk > DKMAX || (dv_tile != 32 && dv_tile != 64) ||
      (Dk > 64 && dv_tile != 32))
    return (int)cudaErrorInvalidValue;
  const bf16 *Q = (const bf16*)q, *K = (const bf16*)k, *V = (const bf16*)v;
  const float* L = (const float*)log_decay;
  bf16* O = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define LINEAR_TC(DKP, DVT) launch<DKP, DVT>(Q, K, V, L, O, BH, T, Dk, Dv, s)
  if (Dk > 64) return LINEAR_TC(128, 32);
  if (Dk > 32) return dv_tile == 64 ? LINEAR_TC(64, 64) : LINEAR_TC(64, 32);
  return dv_tile == 64 ? LINEAR_TC(32, 64) : LINEAR_TC(32, 32);
#undef LINEAR_TC
}

}  // namespace tensor_core

}  // namespace

extern "C" int linear_attention_f32(const void* q, const void* k,
                                    const void* v, const void* log_decay,
                                    void* out, int BH, int seq, int Dk,
                                    int Dv, void* stream) {
  return launch_f32(q, k, v, log_decay, out, BH, seq, Dk, Dv, stream);
}

extern "C" int linear_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* log_decay,
                                     void* out, int BH, int seq, int Dk,
                                     int Dv, int dv_tile, void* stream) {
  return tensor_core::dispatch(q, k, v, log_decay, out, BH, seq, Dk, Dv,
                               dv_tile, stream);
}
