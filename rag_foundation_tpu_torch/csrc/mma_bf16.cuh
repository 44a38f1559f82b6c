// bf16 mma.sync helpers shared by the flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), and their cp.async ring of
// row-major tiles.
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
#include <limits.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int RING = 2;          // bf16 kernels: stages of the cp.async ring
constexpr unsigned FULL = 0xffffffffu;

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

// One stage of the bf16 kernels' ring: CT rows of two row-major [S, D]
// bf16 matrices (Q and dO, or K and V) at a stride of D + 8 elements, so
// that the eight rows of an ldmatrix tile fall in distinct banks, and the
// CT columns' lse, di (dK/dV only) and segment ids.
template <int D, int CT>
struct alignas(16) Stage {
  __nv_bfloat16 a[CT * (D + 8)];
  __nv_bfloat16 b[CT * (D + 8)];
  float lse[CT];
  float di[CT];
  int seg[CT];
};

// Issue the copies of rows [r0, r0 + CT) of a, b, seg and, when lse is not
// null, of lse and di into `st`; rows at or past S are zero-filled and read
// nothing.
template <int D, int CT, int THREADS>
__device__ __forceinline__ void stage_tile(Stage<D, CT>& st,
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b,
                                           const int* seg, const float* lse,
                                           const float* di, int r0, int S) {
  constexpr int LD = D + 8, CHUNKS = D / 8;   // 16-byte pieces a row
  for (int c = threadIdx.x; c < CT * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8, r = r0 + row;
    const size_t off = (size_t)(r < S ? r : 0) * D + col;
    s8::cp_async16(st.a + row * LD + col, a + off, r < S ? 16 : 0);
    s8::cp_async16(st.b + row * LD + col, b + off, r < S ? 16 : 0);
  }
  for (int row = threadIdx.x; row < CT; row += THREADS) {
    const int r = r0 + row, src = r < S ? r : 0, n = r < S ? 4 : 0;
    s8::cp_async4(st.seg + row, seg + src, n);
    if (lse != nullptr) {
      s8::cp_async4(st.lse + row, lse + src, n);
      s8::cp_async4(st.di + row, di + src, n);
    }
  }
}

// A compile-time flag for a generic lambda's argument
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// min and max of the ids of rows row0 .. row0 + rows - 1 before S
__device__ __forceinline__ void row_ids(const int* seg, int row0, int rows,
                                        int S, int lane, int& lo, int& hi) {
  const int r = row0 + lane;
  const bool live = lane < rows && r < S;
  lo = __reduce_min_sync(FULL, live ? seg[r] : INT_MAX);
  hi = __reduce_max_sync(FULL, live ? seg[r] : INT_MIN);
}

// min and max of the ids of a staged tile's first `live` rows (of CT);
// INT_MAX, INT_MIN when it has none
template <int CT>
__device__ __forceinline__ void tile_ids(const int* seg, int live, int lane,
                                         int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int r = lane; r < CT; r += 32)
    if (r < live) {
      lo = min(lo, seg[r]);
      hi = max(hi, seg[r]);
    }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
}

}  // namespace flash
