// Exact fused scan for Hopper (sm_90a): scores = queries . corpus^T folded
// into the best k rows of every query, the [Q, N] scores never stored.
//
// Replaces the Pallas TPU kernel `_fused_topk_kernel` behind `fused_topk`
// (rag_foundation_tpu/ops/pallas_topk.py:34 and :91). Same contract:
//
//   vals[q, j], idx[q, j] = j-th best of queries[q] . corpus[r] over the
//     rows r < min(valid_count, N), the lowest row winning ties; (-inf, -1)
//     where fewer than k rows are live.
//   bf16 / f32 operands, f32 sums (their order differs from a BLAS).
//
// On the TPU the corpus dimension of the grid runs in order and a [Q, k]
// carry lives in VMEM across its steps. Here blocks run in no order, and
// Q = 1024 gives 8 query tiles for 132 SMs, so the rows are SPLIT: one
// block a (128-query tile, range of rows) keeps its own running top-k
// (exact_scan.cuh) and writes part[q, split, 0..k); a second kernel, one
// warp a query, merges the splits in split order into the same kind of
// list. A lower split holds lower rows and each part is sorted with ties
// in row order, so offering the parts in storage order keeps the tie rule,
// and the result does not depend on the number of splits. The TPU's k
// argmax passes over [carry | block] are not copied: a score enters a list
// only if it is strictly greater than the list's last value.
//
// Bound on an H100 at the exact scan's shapes (Q=1024, N=1M, d=768, bf16):
// operations, 1.59 ms, as for block_topk.cu; the parts add
// Q*n_splits*k*8 bytes written and read once, which is under a percent of
// the corpus bytes.

#include "exact_scan.cuh"

namespace {

constexpr int MERGE_WARPS = 4;

__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_parts_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                   float* __restrict__ out_v, int* __restrict__ out_i, int q_n,
                   int width, int K) {
  extern __shared__ float lists[];   // [MERGE_WARPS][K] values, then indices
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= q_n) return;   // the whole warp; no block-wide barrier below
  float* lv = lists + warp * K;
  int* li = reinterpret_cast<int*>(lists + MERGE_WARPS * K) + warp * K;
  scan::list_clear(lv, li, K, lane);
  float thresh = -INFINITY;
  const size_t base = (size_t)q * width;
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const float s = c < width ? part_v[base + c] : -INFINITY;
    const int id = c < width ? part_i[base + c] : -1;
    scan::list_offer(lv, li, K, lane, s, id, thresh);
  }
  for (int j = lane; j < K; j += 32) {
    out_v[(size_t)q * K + j] = lv[j];
    out_i[(size_t)q * K + j] = li[j];
  }
}

}  // namespace

// C entry point (loaded with ctypes). dtype: 1 float32, 2 bfloat16.
// queries [q_n, d], corpus [n, d] contiguous on one device; count_ptr null
// (use `count`) or a device int32; rows are split into ceil(n/seg_len)
// ranges; part_v/part_i [q_n, ceil(n/seg_len), k] scratch; vals/idx
// [q_n, k]. Returns a cudaError_t (0 on success).
extern "C" int fused_topk_launch(int dtype, const void* queries,
                                 const void* corpus, const int* count_ptr,
                                 int count, float* part_v, int* part_i,
                                 float* vals, int* idx, int q_n, int n, int d,
                                 int seg_len, int k, void* stream) {
  if ((dtype != 1 && dtype != 2) || q_n <= 0 || n <= 0 || d <= 0 ||
      seg_len <= 0 || ((long long)d * (dtype == 1 ? 4 : 2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nseg = (int)(((long long)n + seg_len - 1) / seg_len);
  if ((long long)nseg * k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = exact_scan::launch_segment_topk(
      dtype, queries, corpus, count_ptr, count, part_v, part_i, q_n, n, d,
      seg_len, nseg, k, s);
  if (err != cudaSuccess) return (int)err;
  merge_parts_kernel<<<(q_n + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
                       (size_t)MERGE_WARPS * k * 8, s>>>(
      part_v, part_i, vals, idx, q_n, nseg * k, k);
  return (int)cudaGetLastError();
}
