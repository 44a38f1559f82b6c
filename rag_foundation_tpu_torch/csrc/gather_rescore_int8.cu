// Scattered-row gather + int8 rescore for Hopper (sm_90a): the core of the
// IVF-PQ refine stage.
//
// Replaces the Pallas TPU kernel `_gather_score_kernel` behind
// `gather_rescore_int8` (rag_foundation_tpu/ops/pallas_gather.py:38 and
// :66). Same contract as that function's arithmetic (its XLA path, :98):
//
//   out[q, c] = float( sum_i table8[clip(rows[q, c], 0, N-1), i]
//                            * q_int8[q, i] )          (exact int32 sum)
//
// Negative (padding) ids are clipped to row 0 like any other id; the
// caller masks those scores. The gathered rows never exist in device
// memory: only the [Q, C] scores are written.
//
// What the TPU kernel carried and this does not: it fetched the aligned
// 8-row group around each candidate (a Mosaic alignment rule), read an
// int32 word table and chose the row with a one-hot. A GPU reads any
// 16-byte-aligned row directly, so N need not be a multiple of 8.
//
// Bound on an H100: Q*C rows of d bytes read once (plus the queries, the
// ids and the scores), against 2*Q*C*d integer operations: at 2 operations
// a byte it is bound by memory bandwidth, and by DRAM row locality at
// that, since every candidate is a separate d-byte read.
//
// Design: one warp per candidate row, eight warps a block, grid (Q, C/8).
// The query row is staged once per block in shared memory. Lanes stride
// over the row in 16-byte chunks (one coalesced request per 512 bytes),
// four __dp4a per chunk, then a shuffle reduction; lane 0 writes the sum.
// Rows whose width is not a multiple of 16 bytes take a byte loop. Left on
// the table: several candidates per warp for narrow rows, and prefetching
// the ids to overlap the dependent row reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
gather_rescore_kernel(const signed char* __restrict__ table,
                      const int* __restrict__ rows,
                      const signed char* __restrict__ queries,
                      float* __restrict__ out, long long n, int c, int d) {
  extern __shared__ __align__(16) signed char q_s[];
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int cand = blockIdx.y * WARPS + (t >> 5);
  const signed char* q_g = queries + (size_t)q * d;
  const bool vec = (d & 15) == 0;

  if (vec) {
    for (int i = t; i < d / 16; i += WARPS * 32)
      reinterpret_cast<int4*>(q_s)[i] = reinterpret_cast<const int4*>(q_g)[i];
  } else {
    for (int i = t; i < d; i += WARPS * 32) q_s[i] = q_g[i];
  }
  __syncthreads();
  if (cand >= c) return;

  long long row = rows[(size_t)q * c + cand];
  row = row < 0 ? 0 : (row > n - 1 ? n - 1 : row);
  const signed char* r_g = table + (size_t)row * d;
  int acc = 0;
  if (vec) {
    for (int i = lane; i < d / 16; i += 32) {
      const int4 r = __ldg(reinterpret_cast<const int4*>(r_g) + i);
      const int4 v = reinterpret_cast<const int4*>(q_s)[i];
      acc = __dp4a(r.x, v.x, acc);
      acc = __dp4a(r.y, v.y, acc);
      acc = __dp4a(r.z, v.z, acc);
      acc = __dp4a(r.w, v.w, acc);
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += (int)r_g[i] * (int)q_s[i];
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) out[(size_t)q * c + cand] = __int2float_rn(acc);
}

}  // namespace

// C entry point (loaded with ctypes). table8 [n, d] int8, rows [q_n, c]
// int32, q_int8 [q_n, d] int8, out [q_n, c] float32; all contiguous on one
// device. Returns a cudaError_t (0 on success).
extern "C" int gather_rescore_int8_launch(const void* table8, const int* rows,
                                          const void* q_int8, float* out,
                                          long long n, int q_n, int c, int d,
                                          void* stream) {
  if (n <= 0 || q_n <= 0 || c <= 0 || d <= 0 || d > 48 * 1024 ||
      (c + WARPS - 1) / WARPS > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(q_n, (c + WARPS - 1) / WARPS);
  const size_t smem = ((size_t)d + 15) / 16 * 16;
  gather_rescore_kernel<<<grid, WARPS * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(table8), rows,
      static_cast<const signed char*>(q_int8), out, n, c, d);
  return (int)cudaGetLastError();
}
