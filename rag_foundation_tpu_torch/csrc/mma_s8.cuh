// Shared device helpers of the int8 list scans (ivf_list_scan.cu,
// pq_list_scan.cu): the int8 tensor-core product `mma.sync` m16n8k32 with
// int32 accumulation, `ldmatrix` for its fragments, and `cp.async` copies
// into shared memory (which the attention backward's ring uses too).
//
// Fragments of mma.m16n8k32 with 8-bit inputs (PTX ISA, "Matrix Fragments
// for mma.m16n8k32"), for lane = 4 * g + tig (g = groupID, tig =
// threadID_in_group):
//   A (16 x 32, row-major), four 32-bit registers of four bytes each:
//     a[0]: row g,     bytes k = 4*tig .. 4*tig+3
//     a[1]: row g + 8, the same k
//     a[2]: row g,     k = 16 + 4*tig .. 16 + 4*tig + 3
//     a[3]: row g + 8, the same k
//   B (32 x 8, "col": stored as 8 columns of 32 bytes), two registers:
//     b[0]: column g, k = 4*tig .. +3;  b[1]: column g, k = 16 + 4*tig .. +3
//   C/D (16 x 8 int32): c[0], c[1]: row g, columns 2*tig, 2*tig + 1;
//                       c[2], c[3]: row g + 8, the same columns.
// `ldmatrix.x4` of four 8 x 16-byte tiles gives exactly a[0..3] when lanes
// 8j..8j+7 address rows (j & 1) * 8 + 0..7 at byte column (j >> 1) * 16;
// on a [column][k] tile it gives b[0], b[1] of two k-steps or two column
// tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8 {

// d += a (16x32 s8) * b (32x8 s8)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 u8) * b (32x8 s8)
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace s8
