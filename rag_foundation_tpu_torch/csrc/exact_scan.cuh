// Shared device code of the exact flat-scan kernels (block_topk.cu,
// fused_topk.cu): scores[Q, N] = queries[Q, d] . corpus[N, d]^T computed
// tile by tile inside the kernel, each tile folded into a sorted list of
// the best K rows of every query, so the score matrix never leaves the SM.
//
// The corpus is cut into SEGMENTS of seg_len rows. One block owns one
// (query tile, segment) pair: it walks the segment in 128-row tiles and
// folds the scores of each tile into each query's list of its best K rows,
// by (score descending, row ascending), so the lower row wins a tie. At
// the end it writes out[q, segment, 0..K). Both kernels are this one with
// another meaning of "segment":
//   block_topk: segment = one block_n-row corpus block, K = p;
//   fused_topk: segment = one of n_splits ranges of rows, K = k, and a
//               second kernel merges the ranges.
//
// Rows at or past min(valid_count, N) score -inf (the bf16 path reads the
// rest of the 128-row tile that holds the count; the f32 path reads none);
// query rows past Q are not written. Nothing is padded.
//
// The product: bf16 on the tensor cores (wgmma m64n128k16, f32
// accumulators, a warpgroup 64 x 128 scores), f32 as plain FMA
// (8 x 8 scores a thread, 16-deep chunks staged depth-major, the next
// chunk's global loads started before the current chunk's products), never
// TF32. A score's sum runs over d in the same order wherever its tile lies,
// so the result does not depend on the segment length.
//
// bf16 design (segment_topk_bf16):
// - the operands come to shared memory in 32-deep chunks of the block's
//   queries and 128 rows by TMA (cp.async.bulk.tensor, 2D tensor maps, the 64-byte
//   swizzle), in ONE ring of mbarrier-tracked stages that runs over all the
//   tiles of the block's segment: thread 0 refills a stage as soon as every
//   warp has released it, and a warp waits only for the chunk it needs (no
//   block-wide barrier in the loop). The next tile's first chunks are in
//   flight while this tile's scores are selected;
// - each warpgroup multiplies its 64 queries by the chunk's 128 rows with
//   wgmma, both operands read by the tensor cores from the swizzled chunks
//   through K-major descriptors (no ldmatrix, no register staging). A
//   warpgroup waits for its chunk's products before it releases the stage
//   (keeping the previous chunk's in flight instead lost its A/B: the
//   compiler then serialises the products around the refill's branch);
//   the other warpgroup and the SM's other block fill the tensor cores
//   meanwhile;
// - the scores never leave the registers. Warp w holds queries
//   16 w .. 16 w + 15 against all 128 rows of each tile, and each query
//   has a sorted list in shared memory that only that warp writes. A
//   thread keeps the last entry of its two queries' lists in registers; a
//   tile costs it one maximum of its 32 scores a query and a compare, and
//   only where a score reaches that entry do the query's four lanes insert
//   their candidates, one lane after another, each insertion a walk from
//   the list's end (the WarpSelect idea of faiss, Johnson et al.,
//   "Billion-scale similarity search with GPUs": a register threshold in
//   front of a sorted list). No barrier and no score tile: once the lists
//   are warm a tile's selection is a few instructions a query. For K <= 2
//   (block_topk's p=2) each thread keeps its own best two of each query in
//   registers instead, merged over the query's four lanes by shuffles at
//   the segment's end;
// - the order is (score descending, row ascending) everywhere, so no
//   insertion depends on the order in which candidates arrive;
// - tiles: for the register lists two warpgroups (128 queries) a block,
//   a six-stage ring, two blocks an SM; for lists in shared memory four
//   warpgroups (256 queries), four stages, one block an SM, which halves
//   the L2's reads of the rows (each won its A/B).
// The f32 path keeps the older design: a score tile in shared memory, the
// operands staged depth-major and drained into its region at the end of
// every tile, and one warp a query offering every score to its list.
//
// Blocks are numbered query tile fastest: the query tiles of one segment
// run side by side and the L2 serves all but the first read of its rows.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "subblock_topp.cuh"

namespace exact_scan {

constexpr int TQ = 128;          // query rows of a tile
constexpr int TN = 128;          // corpus rows of a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SC_LD = TN + 4;    // stride of the f32 score tile
constexpr int SCORE_BYTES = TQ * SC_LD * 4;
constexpr int BK16 = 32;         // bf16: depth of a staged chunk
constexpr int BK32 = 16;         // f32: depth of a staged chunk
constexpr int LD32 = TQ + 4;     //   padded stride of a depth-major chunk
constexpr int F32_STAGE_BYTES = 2 * BK32 * LD32 * 4;
// f32: the score tile, then the one staged chunk
constexpr int F32_REGION_BYTES = SCORE_BYTES + F32_STAGE_BYTES;

inline size_t smem_bytes_f32(int K) {
  return (size_t)F32_REGION_BYTES + (size_t)TQ * K * 8;
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

// Both kernels: out_v/out_i [q_n, nseg, K]: per query and segment, the
// best K rows of the segment by (score descending, row ascending); (-inf,
// -1) where the segment has fewer live rows. count_ptr, when not null,
// points at the valid count on the device (no host copy of it is needed).

// The rows [lo, hi) of the block's segment and its query tile q0
struct Span {
  int q0, seg, lo, hi;
};

__device__ __forceinline__ Span block_span(const int* count_ptr, int count,
                                           int n, int seg_len, int n_qtiles,
                                           int tq) {
  Span s;
  s.q0 = (int)(blockIdx.x % n_qtiles) * tq;
  s.seg = (int)(blockIdx.x / n_qtiles);
  const int limit = max(0, min(n, count_ptr != nullptr ? *count_ptr : count));
  const long long lo64 = (long long)s.seg * seg_len;
  s.lo = (int)min(lo64, (long long)limit);
  s.hi = (int)min(lo64 + seg_len, (long long)limit);
  return s;
}

// f32: the score tile of each 128-row tile, then one warp a query offers
// all its scores. Two blocks an SM (128 registers a thread; the shared
// memory of two fits while K <= 30).
__global__ void __launch_bounds__(THREADS, 2)
segment_topk_f32(const float* __restrict__ q, const float* __restrict__ c,
                 const int* __restrict__ count_ptr, int count,
                 float* __restrict__ out_v, int* __restrict__ out_i, int q_n,
                 int n, int d, int seg_len, int nseg, int n_qtiles, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* score_s = reinterpret_cast<float*>(smem);     // [TQ][SC_LD]
  float* list_v = reinterpret_cast<float*>(smem + F32_REGION_BYTES);   // [TQ][K]
  int* list_i = reinterpret_cast<int*>(list_v + TQ * K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Span sp = block_span(count_ptr, count, n, seg_len, n_qtiles, TQ);
  const int q0 = sp.q0, hi = sp.hi;

  for (int r = warp; r < TQ; r += WARPS)
    scan::list_clear(list_v + r * K, list_i + r * K, K, lane);

  for (int n0 = sp.lo; n0 < hi; n0 += TN) {
    score_tile_f32(q, c, q0, n0, q_n, hi, d, score_s, smem + SCORE_BYTES);
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
    const size_t o = ((size_t)(q0 + r) * nseg + sp.seg) * K;
    for (int j = lane; j < K; j += 32) {
      out_v[o + j] = list_v[r * K + j];
      out_i[o + j] = list_i[r * K + j];
    }
  }
}

// (v, i) before (w, j) in the lists' order: score descending, row
// ascending
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (v, i), which beats the last entry, into a sorted list of K in
// shared memory: one thread walks it from the end.
__device__ __forceinline__ void list_insert_seq(float* lv, int* li, int K,
                                                float v, int i) {
  int j = K - 1;
  while (j > 0 && beats(v, i, lv[j - 1], li[j - 1])) {
    lv[j] = lv[j - 1];
    li[j] = li[j - 1];
    --j;
  }
  lv[j] = v;
  li[j] = i;
}

// ---- bf16: a TMA ring ------------------------------------------------------
// A chunk of 32 bf16 (64 bytes) of each of 128 rows, as TMA writes it with
// the 64-byte swizzle (the 16-byte piece j of row r lands at piece
// j ^ ((r >> 1) & 3) of the row), the layout wgmma's descriptors read.
constexpr int CHUNK_BYTES = TN * BK16 * 2;   // 8 KB: 128 rows x 64 bytes

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   flash::smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          flash::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   flash::smem_u32(bar))
               : "memory");
}
// whether the barrier's phase of this parity has completed (the hardware
// may suspend the thread a while before it answers no)
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(flash::smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for that phase; a wait of millions of tries is a fault (a chunk
// that never lands), which traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0; !mbar_try_wait(bar, parity);)
    if (++tries == (1u << 24)) __trap();
}
// the box of `map` at (x = depth, y = row) into shared memory, counted on
// `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(flash::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(flash::smem_u32(bar))
      : "memory");
}

// wgmma helpers: a shared-memory matrix descriptor of a K-major operand in
// the 64-byte swizzle (8-row groups 512 bytes apart), and the product
// d[64 x 128] += a[64 x 16] . b[128 x 16]^T of one warpgroup, both operands
// read from shared memory by the tensor cores
__device__ __forceinline__ uint64_t kmajor_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators are written by the tensor cores behind the compiler's
// back: pin them around the waits
__device__ __forceinline__ void pin(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void wgmma_64x128(float (&d)[16][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// bf16 (the design in the header): WG warpgroups, each 64 queries x TN rows
// of a tile through wgmma; warp w holds queries 16 w .. 16 w + 15 (rows g,
// g + 8 of its slice) against all TN rows. REG: lists of at most two
// entries, kept in registers.
template <int WG, int STAGES, int MINB, bool REG>
__global__ void __launch_bounds__(128 * WG, MINB)
segment_topk_bf16(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const int* __restrict__ count_ptr, int count,
                  float* __restrict__ out_v, int* __restrict__ out_i, int q_n,
                  int n, int d, int seg_len, int nseg, int n_qtiles, int K) {
  constexpr int TQB = 64 * WG, NWARPS = 4 * WG;   // queries, warps
  constexpr int A_BYTES = TQB * BK16 * 2;          // a stage: the queries'
  constexpr int STAGE_BYTES = A_BYTES + CHUNK_BYTES;   // chunk, the rows'
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the ring at a 1 KB boundary (the swizzle's period is 512 bytes): each
  // stage holds the queries' chunk, then the rows'
  unsigned char* smem = smem_raw + ((1024 - (flash::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* list_v = reinterpret_cast<float*>(empty + STAGES);   // [TQB][K]
  int* list_i = reinterpret_cast<int*>(list_v + TQB * K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;   // warpgroup: queries 64 wg ..
  const Span sp = block_span(count_ptr, count, n, seg_len, n_qtiles, TQB);
  const int q0 = sp.q0, lo = sp.lo, hi = sp.hi;

  const int nchunks = (d + BK16 - 1) / BK16;
  const int ntiles = (hi - lo + TN - 1) / TN;   // 0 for an empty segment
  const int total = ntiles * nchunks;
  auto fetch = [&](int gc) {
    const int tile = gc / nchunks, kc = gc - tile * nchunks;
    const int stage = gc % STAGES;
    unsigned char* st = ring + stage * STAGE_BYTES;
    mbar_expect_tx(full + stage, STAGE_BYTES);
    tma_load(st, &qmap, kc * BK16, q0, full + stage);
    tma_load(st + A_BYTES, &cmap, kc * BK16, lo + tile * TN, full + stage);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < total; ++s) fetch(s);
  }
  if constexpr (!REG)
    for (int r = warp; r < TQB; r += NWARPS)
      scan::list_clear(list_v + r * K, list_i + r * K, K, lane);
  __syncthreads();   // the barriers are initialised

  // per query 16 warp + 8 h + g: REG, this thread's best two (sorted);
  // else the last entry of its list
  float tv[2][2];
  int ti[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tv[h][x] = -INFINITY;
      ti[h][x] = -1;
    }
  const int row0 = 16 * warp + g;   // this thread's first query of the tile

  int gc = 0;   // the chunk in use
  float acc[16][4];
  for (int tile = 0; tile < ntiles; ++tile) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kc = 0; kc < nchunks; ++kc, ++gc) {
      const int stage = gc % STAGES;
      mbar_wait(full + stage, (unsigned)(gc / STAGES) & 1u);
      const uint32_t a_s = flash::smem_u32(ring + stage * STAGE_BYTES) +
                           wg * 64 * 64;
      const uint32_t b_s = flash::smem_u32(ring + stage * STAGE_BYTES) +
                           A_BYTES;
      wgmma_fence();
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < BK16 / 16; ++kk)
        wgmma_64x128(acc, kmajor_sw64(a_s + 32 * kk),
                     kmajor_sw64(b_s + 32 * kk));
      wgmma_commit();
      // the chunk's products are done: its stage goes back, and thread 0
      // refills it with chunk gc + STAGES once every warp has released it
      wgmma_wait<0>();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (tid == 0 && gc + STAGES < total) {
        mbar_wait(empty + stage, (unsigned)(gc / STAGES) & 1u);
        fetch(gc + STAGES);
      }
    }

    // the tile's scores against the lists: this thread's columns of the
    // tile are 8 j + 2 t + e (ascending in j, e), rows n0 + those
    const int n0 = lo + tile * TN;
    if (n0 + TN > hi) {   // the segment's last tile: rows past hi never enter
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + j * 8 + 2 * t + e >= hi) {
            acc[j][e] = -INFINITY;
            acc[j][2 + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(acc[j][2 * h], acc[j][2 * h + 1]));
      float(&v2)[2] = tv[h];
      int(&i2)[2] = ti[h];
      if constexpr (REG) {
        // rows arrive ascending, so a tie never enters: strictly greater
        if (mx > v2[1]) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = acc[j][2 * h + e];
              const int row = n0 + j * 8 + 2 * t + e;
              if (v > v2[1]) {
                const bool first = v > v2[0];
                v2[1] = first ? v2[0] : v;
                i2[1] = first ? i2[0] : row;
                v2[0] = first ? v : v2[0];
                i2[0] = first ? row : i2[0];
              }
            }
        }
      } else {
        // a score equal to the last entry may still win on its row
        const bool mine = mx >= v2[0] && mx > -INFINITY;
        if (!__any_sync(0xffffffffu, mine)) continue;
        float* lv = list_v + (row0 + 8 * h) * K;
        int* li = list_i + (row0 + 8 * h) * K;
        // this lane's candidates: bit 2 j + e
        unsigned bits = 0u;
        if (mine) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = acc[j][2 * h + e];
              bits |= v >= v2[0] && v > -INFINITY ? 1u << (2 * j + e) : 0u;
            }
        }
        // the query's four lanes in turn (they share its list)
        for (int tt = 0; tt < 4; ++tt) {
          if (bits != 0u && t == tt) {
            float lastv = lv[K - 1];
            int lasti = li[K - 1];
            do {
              const int x = __ffs(bits) - 1;
              bits &= bits - 1;
              float v = acc[0][2 * h];
#pragma unroll
              for (int y = 1; y < 32; ++y)
                v = x == y ? acc[y >> 1][2 * h + (y & 1)] : v;
              const int row = n0 + (x >> 1) * 8 + 2 * t + (x & 1);
              if (beats(v, row, lastv, lasti)) {
                list_insert_seq(lv, li, K, v, row);
                lastv = lv[K - 1];
                lasti = li[K - 1];
              }
            } while (bits != 0u);
          }
          __syncwarp();
        }
        v2[0] = lv[K - 1];
        i2[0] = li[K - 1];
      }
    }
  }

  if constexpr (REG) {
    // the best two of each query's four lanes, straight to the output
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float(&v2)[2] = tv[h];
      int(&i2)[2] = ti[h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float w0 = __shfl_xor_sync(0xffffffffu, v2[0], off);
        const float w1 = __shfl_xor_sync(0xffffffffu, v2[1], off);
        const int j0 = __shfl_xor_sync(0xffffffffu, i2[0], off);
        const int j1 = __shfl_xor_sync(0xffffffffu, i2[1], off);
        // the two sorted pairs merged: the best two of the four
        if (beats(w0, j0, v2[0], i2[0])) {
          const bool mine1 = beats(v2[0], i2[0], w1, j1);
          v2[1] = mine1 ? v2[0] : w1;
          i2[1] = mine1 ? i2[0] : j1;
          v2[0] = w0;
          i2[0] = j0;
        } else if (beats(w0, j0, v2[1], i2[1])) {
          v2[1] = w0;
          i2[1] = j0;
        }
      }
      const int q = q0 + row0 + 8 * h;
      if (t == 0 && q < q_n) {
        const size_t o = ((size_t)q * nseg + sp.seg) * K;
        out_v[o] = v2[0];
        out_i[o] = i2[0];
        if (K > 1) {
          out_v[o + 1] = v2[1];
          out_i[o + 1] = i2[1];
        }
      }
    }
  } else {
    __syncwarp();   // the warp's lists are final
    for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
      if (q0 + r >= q_n) break;
      const size_t o = ((size_t)(q0 + r) * nseg + sp.seg) * K;
      for (int j = lane; j < K; j += 32) {
        out_v[o + j] = list_v[r * K + j];
        out_i[o + j] = list_i[r * K + j];
      }
    }
  }
}

// A 2D tensor map of rows x d bf16 at `base`, boxes of BK16 x `box_rows`
// with the 64-byte swizzle; rows and depth past the tensor read as zeros.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows,
                              int d, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000,
        cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK16, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16 with wg warpgroups: the ring of stages of 64 wg queries' and TN
// rows' chunks, its barriers, the lists of every query, and 1 KB to align
// the ring
inline size_t smem_bytes_bf16(int wg, int stages, int K) {
  return (size_t)stages * (64 * wg * BK16 * 2 + CHUNK_BYTES) +
         (size_t)stages * 16 + (size_t)64 * wg * K * 8 + 1024;
}

template <int WG, int STAGES, int MINB, bool REG>
cudaError_t launch_bf16(const void* q, const void* c, const int* count_ptr,
                        int count, float* out_v, int* out_i, int q_n, int n,
                        int d, int seg_len, int nseg, int K,
                        cudaStream_t stream) {
  const long long n_qtiles = (q_n + 64 * WG - 1) / (64 * WG);
  const long long blocks = n_qtiles * nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap qmap, cmap;
  cudaError_t err = tensor_map(&qmap, q, q_n, d, 64 * WG);
  if (err == cudaSuccess) err = tensor_map(&cmap, c, n, d, TN);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes_bf16(WG, STAGES, K);
  auto kernel = segment_topk_bf16<WG, STAGES, MINB, REG>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 128 * WG, smem, stream>>>(
      qmap, cmap, count_ptr, count, out_v, out_i, q_n, n, d, seg_len, nseg,
      (int)n_qtiles, K);
  return cudaGetLastError();
}

// Launch over every (query tile, segment). dtype: 1 float32, 2 bfloat16.
inline cudaError_t launch_segment_topk(int dtype, const void* q, const void* c,
                                       const int* count_ptr, int count,
                                       float* out_v, int* out_i, int q_n, int n,
                                       int d, int seg_len, int nseg, int K,
                                       cudaStream_t stream) {
  if (q_n <= 0 || nseg <= 0 || K < 1 || K > scan::LIST_MAX)
    return cudaErrorInvalidValue;
  if (dtype == 2) {
    // register lists: 128 queries a block, six stages, two blocks an SM;
    // lists in shared memory: 256 queries a block, four stages, one block
    // an SM (the L2 then serves each row four times a batch, not eight)
    if (K <= 2)
      return launch_bf16<2, 6, 2, true>(q, c, count_ptr, count, out_v, out_i,
                                        q_n, n, d, seg_len, nseg, K, stream);
    return launch_bf16<4, 4, 1, false>(q, c, count_ptr, count, out_v, out_i,
                                       q_n, n, d, seg_len, nseg, K, stream);
  }
  const long long n_qtiles = (q_n + TQ - 1) / TQ;
  const long long blocks = n_qtiles * nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_f32(K);
  cudaError_t err = cudaFuncSetAttribute(
      segment_topk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  segment_topk_f32<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), count_ptr,
      count, out_v, out_i, q_n, n, d, seg_len, nseg, (int)n_qtiles, K);
  return cudaGetLastError();
}

}  // namespace exact_scan
