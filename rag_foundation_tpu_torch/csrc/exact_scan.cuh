// Shared device code of the exact flat-scan kernels (block_topk.cu,
// fused_topk.cu): scores[Q, N] = queries[Q, d] . corpus[N, d]^T computed
// tile by tile inside the kernel, each tile folded into a sorted list of
// the best K rows of every query, so the score matrix never leaves the SM.
//
// The corpus is cut into SEGMENTS of seg_len rows. One block owns one
// (128-query tile, segment) pair: it walks the segment in 128-row tiles,
// computes the 128 x 128 scores of a tile into shared memory, and one warp
// a query row offers the tile's scores, in row order, to that query's list
// (subblock_topp.cuh: strictly greater enters, so the lower row wins a
// tie). At the end it writes out[q, segment, 0..K). Both kernels are this
// one with another meaning of "segment":
//   block_topk: segment = one block_n-row corpus block, K = p;
//   fused_topk: segment = one of n_splits ranges of rows, K = k, and a
//               second kernel merges the ranges.
//
// Rows at or past min(valid_count, N) score -inf and are not read; query
// rows past Q are not written. Nothing is padded.
//
// The product: bf16 on the tensor cores (nvcuda::wmma 16x16x16, f32
// accumulators, 8 warps of 32 x 64 scores each, the operands brought to
// shared memory in 32-deep chunks by cp.async, a ring of four chunks in
// flight, which the score tile overwrites once it is drained); f32 as
// plain FMA (8 x 8 scores a thread, 16-deep chunks staged depth-major,
// the next chunk's global loads started before the current chunk's
// products), never TF32. A score's sum runs over d in the same order
// wherever its tile lies, so the result does not depend on the segment
// length.
//
// Blocks are numbered query tile fastest: the query tiles of one segment
// run side by side and the L2 serves all but the first read of its rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "subblock_topp.cuh"

namespace exact_scan {

constexpr int TQ = 128;          // query rows of a tile
constexpr int TN = 128;          // corpus rows of a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SC_LD = TN + 4;    // stride of the f32 score tile
constexpr int SCORE_BYTES = TQ * SC_LD * 4;
constexpr int BK16 = 32;         // bf16: depth of a staged chunk
constexpr int LD16 = BK16 + 8;   //   padded stride (80 bytes)
constexpr int STAGES = 4;        //   chunks in flight (cp.async ring)
constexpr int STAGE_ELEMS = 2 * TQ * LD16;   //   queries, then rows
constexpr int BK32 = 16;         // f32: depth of a staged chunk
constexpr int LD32 = TQ + 4;     //   padded stride of a depth-major chunk
constexpr int F32_STAGE_BYTES = 2 * BK32 * LD32 * 4;
// One region holds the score tile and the staged operands. bf16: the ring
// and the score tile share its start (the ring is drained before the
// scores are stored); f32: the one staged chunk lies behind the scores.
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int REGION_BYTES = RING_BYTES > SCORE_BYTES + F32_STAGE_BYTES
                                 ? RING_BYTES
                                 : SCORE_BYTES + F32_STAGE_BYTES;

inline size_t smem_bytes(int K) { return (size_t)REGION_BYTES + (size_t)TQ * K * 8; }

// 16 bytes global -> shared without passing through registers; `ok` false
// stores zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// scores of queries [q0, q0+TQ) x rows [n0, n0+TN) into score_s; rows at
// or past row_end and queries at or past q_n are taken as zeros. `ring`
// and `score_s` may overlap.
__device__ __forceinline__ void score_tile_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
    int q0, int n0, int q_n, int row_end, int d, float* score_s,
    __nv_bfloat16* ring) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wq = (warp & 3) * 32, wn = (warp >> 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // chunk kc of both operands into ring slot kc % STAGES
  auto fetch = [&](int kc) {
    __nv_bfloat16* a_s = ring + (kc % STAGES) * STAGE_ELEMS;
    __nv_bfloat16* b_s = a_s + TQ * LD16;
#pragma unroll
    for (int i = 0; i < TQ * (BK16 / 8) / THREADS; ++i) {
      const int id = tid + i * THREADS;
      const int row = id / (BK16 / 8), c8 = (id % (BK16 / 8)) * 8;
      const int k = kc * BK16 + c8;
      const bool oka = k < d && q0 + row < q_n;
      const bool okb = k < d && n0 + row < row_end;
      cp_async16(a_s + row * LD16 + c8, oka ? q + (size_t)(q0 + row) * d + k : q, oka);
      cp_async16(b_s + row * LD16 + c8, okb ? c + (size_t)(n0 + row) * d + k : c, okb);
    }
  };

  const int nchunks = (d + BK16 - 1) / BK16;
  __syncthreads();   // the last tile's scores, which the ring overlaps, are consumed
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<STAGES - 2>();   // this thread's part of chunk kc has landed
    __syncthreads();   // everyone's has, and chunk kc-1's slot is consumed
    if (kc + STAGES - 1 < nchunks) fetch(kc + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* a_s = ring + (kc % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* b_s = a_s + TQ * LD16;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wq + i * 16) * LD16 + kk, LD16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], b_s + (wn + j * 16) * LD16 + kk, LD16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is consumed: the scores may overwrite it
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(score_s + (wq + i * 16) * SC_LD + wn + j * 16,
                              acc[i][j], SC_LD, wmma::mem_row_major);
}

__device__ __forceinline__ void score_tile_f32(
    const float* __restrict__ q, const float* __restrict__ c, int q0, int n0,
    int q_n, int row_end, int d, float* score_s, unsigned char* stage) {
  float* a_s = reinterpret_cast<float*>(stage);   // [BK32][LD32], depth-major
  float* b_s = a_s + BK32 * LD32;
  const int tid = threadIdx.x;
  const int ty = (tid >> 4) * 4, tx = (tid & 15) * 4;   // rows ty.., 64+ty..

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra[2], rb[2];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * THREADS;
      const int row = id >> 2, k = k0 + (id & 3) * 4;
      ra[i] = rb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < d) {
        if (q0 + row < q_n)
          ra[i] = *reinterpret_cast<const float4*>(q + (size_t)(q0 + row) * d + k);
        if (n0 + row < row_end)
          rb[i] = *reinterpret_cast<const float4*>(c + (size_t)(n0 + row) * d + k);
      }
    }
  };

  gload(0);
  for (int k0 = 0; k0 < d; k0 += BK32) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * THREADS;
      const int row = id >> 2, kk = (id & 3) * 4;
      a_s[(kk + 0) * LD32 + row] = ra[i].x;
      a_s[(kk + 1) * LD32 + row] = ra[i].y;
      a_s[(kk + 2) * LD32 + row] = ra[i].z;
      a_s[(kk + 3) * LD32 + row] = ra[i].w;
      b_s[(kk + 0) * LD32 + row] = rb[i].x;
      b_s[(kk + 1) * LD32 + row] = rb[i].y;
      b_s[(kk + 2) * LD32 + row] = rb[i].z;
      b_s[(kk + 3) * LD32 + row] = rb[i].w;
    }
    __syncthreads();
    if (k0 + BK32 < d) gload(k0 + BK32);
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * LD32 + ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * LD32 + 64 + ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * LD32 + tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * LD32 + 64 + tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? ty + i : 64 + ty + i - 4);
    *reinterpret_cast<float4*>(score_s + r * SC_LD + tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(score_s + r * SC_LD + 64 + tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// out_v/out_i [q_n, nseg, K]: per query and segment, the best K rows of
// the segment by (score descending, row ascending); (-inf, -1) where the
// segment has fewer live rows. count_ptr, when not null, points at the
// valid count on the device (no host copy of it is needed).
// Two blocks an SM (128 registers a thread; the shared memory of two fits
// while K <= 30): one block's loads and selection overlap the other's
// products, which was worth a quarter of the time on an H100.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
segment_topk_kernel(const void* __restrict__ q, const void* __restrict__ c,
                    const int* __restrict__ count_ptr, int count,
                    float* __restrict__ out_v, int* __restrict__ out_i, int q_n,
                    int n, int d, int seg_len, int nseg, int n_qtiles, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* score_s = reinterpret_cast<float*>(smem);     // [TQ][SC_LD]
  float* list_v = reinterpret_cast<float*>(smem + REGION_BYTES);   // [TQ][K]
  int* list_i = reinterpret_cast<int*>(list_v + TQ * K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const int seg = (int)(blockIdx.x / n_qtiles);
  const int limit = max(0, min(n, count_ptr != nullptr ? *count_ptr : count));
  const long long lo64 = (long long)seg * seg_len;
  const int lo = (int)min(lo64, (long long)limit);
  const int hi = (int)min(lo64 + seg_len, (long long)limit);

  for (int r = warp; r < TQ; r += WARPS)
    scan::list_clear(list_v + r * K, list_i + r * K, K, lane);

  for (int n0 = lo; n0 < hi; n0 += TN) {
    if constexpr (BF16) {
      score_tile_bf16(static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(c), q0, n0, q_n, hi, d,
                      score_s, reinterpret_cast<__nv_bfloat16*>(smem));
    } else {
      score_tile_f32(static_cast<const float*>(q), static_cast<const float*>(c),
                     q0, n0, q_n, hi, d, score_s, smem + SCORE_BYTES);
    }
    __syncthreads();
    for (int r = warp; r < TQ; r += WARPS) {
      if (q0 + r >= q_n) break;
      float* lv = list_v + r * K;
      int* li = list_i + r * K;
      float thresh = lv[K - 1];
#pragma unroll
      for (int c0 = 0; c0 < TN; c0 += 32) {
        const int row = n0 + c0 + lane;
        const float s = row < hi ? score_s[r * SC_LD + c0 + lane] : -INFINITY;
        scan::list_offer(lv, li, K, lane, s, row, thresh);
      }
    }
  }

  for (int r = warp; r < TQ; r += WARPS) {
    if (q0 + r >= q_n) break;
    const size_t o = ((size_t)(q0 + r) * nseg + seg) * K;
    for (int j = lane; j < K; j += 32) {
      out_v[o + j] = list_v[r * K + j];
      out_i[o + j] = list_i[r * K + j];
    }
  }
}

// Launch over every (query tile, segment). dtype: 1 float32, 2 bfloat16.
inline cudaError_t launch_segment_topk(int dtype, const void* q, const void* c,
                                       const int* count_ptr, int count,
                                       float* out_v, int* out_i, int q_n, int n,
                                       int d, int seg_len, int nseg, int K,
                                       cudaStream_t stream) {
  const long long n_qtiles = (q_n + TQ - 1) / TQ;
  const long long blocks = n_qtiles * nseg;
  if (blocks <= 0 || blocks > 0x7fffffffLL || K < 1 || K > scan::LIST_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  auto kernel = dtype == 2 ? segment_topk_kernel<true> : segment_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, c, count_ptr, count, out_v, out_i, q_n, n, d, seg_len, nseg,
      (int)n_qtiles, K);
  return cudaGetLastError();
}

}  // namespace exact_scan
