// Building blocks of the bf16 tensor-core kernels (`mma.sync.m16n8k16`,
// bf16 in, f32 accumulate): 16-byte `cp.async` copies, `ldmatrix` loads and
// the MMA itself, with the fragment layouts they give. Included by
// flash_attention.cu and linear_attention.cu; the build hashes it with the
// sources and compiles only the *.cu files.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (16 or 0) of global memory into 16 bytes of shared memory,
// zero-filling what is not copied.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane l receives row l / 4, columns 2 (l % 4) and + 1 of each
// (with .trans: column l / 4, rows 2 (l % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col). Lane l
// holds c at rows l / 4 and l / 4 + 8, columns 2 (l % 4) and + 1; a0..a3
// hold a at (row l / 4, cols 2 (l % 4) + {0, 1}), (row + 8, same cols),
// (row, cols + 8), (row + 8, cols + 8); b0, b1 hold b at rows
// 2 (l % 4) + {0, 1} and + 8, column l / 4. Not volatile: it reads and
// writes registers only, so the compiler may move it (the ldmatrix reads
// of shared memory stay volatile).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows [row0, row0 + ROWS) of a bf16 matrix of row stride src_ld, columns
// [0, cols), into a tile of row stride ld; rows at or past T zero-filled,
// columns at or past cols left as they are. `vec`: 16-byte copies (cols
// and src_ld multiples of 8, the base 16-byte aligned), else element by
// element.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long src_ld, int row0, int T,
                                          int cols, bool vec) {
  if (vec) {
    // (row, 16-byte chunk) of copy i = threadIdx.x + n THREADS, stepped
    // without a division per copy
    const int chunks = cols / 8, dr = THREADS / chunks;
    const int dc = THREADS - dr * chunks;
    int r = threadIdx.x / chunks, c = threadIdx.x - r * chunks;
    for (int i = threadIdx.x; i < ROWS * chunks; i += THREADS) {
      const bool ok = row0 + r < T;
      cp_async16(dst + r * ld + 8 * c,
                 ok ? src + (long long)(row0 + r) * src_ld + 8 * c : src,
                 ok ? 16 : 0);
      r += dr;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = row0 + r < T
                            ? src[(long long)(row0 + r) * src_ld + c]
                            : __float2bfloat16(0.0f);
    }
  }
}

}  // namespace tc
