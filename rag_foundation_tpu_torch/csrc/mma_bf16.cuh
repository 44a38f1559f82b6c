// bf16 mma.sync helpers shared by the flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A regs: (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B regs: (rows 2t..2t+1, col g), (rows 2t+8.., col g)
//   C:      c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at (row g+8, same cols)
// So the accumulators of two neighbouring 16x8 tiles (columns 16kk..16kk+7
// and 16kk+8..16kk+15) are, packed to bf16, the A operand of depth step kk
// of the next product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b, a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand of depth step kk from the f32 accumulators of tiles 2kk, 2kk+1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A fragments of 16 rows (r0 and r0 + 8 are this thread's) of a row-major
// [S, D] bf16 matrix, D/16 depth steps; rows at or past S are zero
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16* m, int r0,
                                            int S, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < S ? ld32(m + (size_t)r0 * D + c) : 0u;
    a[kk][1] = r1 < S ? ld32(m + (size_t)r1 * D + c) : 0u;
    a[kk][2] = r0 < S ? ld32(m + (size_t)r0 * D + c + 8) : 0u;
    a[kk][3] = r1 < S ? ld32(m + (size_t)r1 * D + c + 8) : 0u;
  }
}

// ldmatrix .x4 of four 8x8 b16 tiles at a shared-memory address: lanes
// 8j..8j+7 give the addresses of tile j's eight rows (16 bytes each), and
// thread i receives elements (i / 4, 2 (i % 4)) and (i / 4, 2 (i % 4) + 1)
// of each tile: on a row-major [n][k] tile the B fragment of
// mma.m16n8k16 (rows 2t, 2t + 1 of column g). With .trans it receives
// elements (2 (i % 4), i / 4) and (2 (i % 4) + 1, i / 4): on a row-major
// [k][n] tile the same fragment, so a product over the rows of a staged
// tile needs no transposed copy of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit, denormal results flushed to 0 (an
// attention weight below 2^-126 is 0 to every sum it enters)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flash
