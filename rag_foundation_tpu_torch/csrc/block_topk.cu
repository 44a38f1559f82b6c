// Two-stage exact scan, stage 1, for Hopper (sm_90a): the best p rows of
// every (query, block_n-row corpus block).
//
// Replaces the Pallas TPU kernel `_block_topp_kernel` behind `block_topk`
// (rag_foundation_tpu/ops/pallas_block_topk.py:34 and :68). Same contract,
// but for the layout of the candidates, which is the one stage 2 wants:
//
//   vals[q, b, j], idx[q, b, j]
//     = j-th best of queries[q] . corpus[b*block_n + r] over r in
//       [0, block_n), rows at or past min(valid_count, N) scoring -inf, the
//       lowest row winning ties; idx = b*block_n + r, or -1 for a -inf value.
//   bf16 / f32 operands, f32 sums (their order differs from a BLAS).
//
// Stage 2 (a stable top-k over the [Q, num_blocks*p] candidates) is outside
// the TPU kernel too and stays plain PyTorch in the wrapper.
//
// Design: exact_scan.cuh, one block a (128-query tile, corpus block). The
// TPU's p argmax passes over block_n scores become one pass over a sorted
// list of p entries (subblock_topp.cuh), which gives the same rows.
//
// Bound on an H100 at the exact scan's shapes (Q=1024, N=1M, d=768, bf16):
// 2*Q*N*d = 1.57e12 operations at 989 TFLOP/s is 1.59 ms, the 1.54 GB of
// corpus at 3.35 TB/s 0.46 ms: operations. The bf16 design (wgmma fed by a
// TMA ring that stays in flight across the tiles of a block's corpus
// block) is in exact_scan.cuh; the 128 x 128 tiles read the queries and
// rows from the L2 eight and one times over, 24.6 GB a batch.

#include "exact_scan.cuh"

// C entry point (loaded with ctypes). dtype: 1 float32, 2 bfloat16.
// queries [q_n, d], corpus [n, d] contiguous on one device; count_ptr null
// (use `count`) or a device int32; vals/idx [q_n, ceil(n/block_n), p].
// Returns a cudaError_t (0 on success).
extern "C" int block_topk_launch(int dtype, const void* queries,
                                 const void* corpus, const int* count_ptr,
                                 int count, float* vals, int* idx, int q_n,
                                 int n, int d, int block_n, int p,
                                 void* stream) {
  if ((dtype != 1 && dtype != 2) || q_n <= 0 || n <= 0 || d <= 0 ||
      block_n <= 0 || ((long long)d * (dtype == 1 ? 4 : 2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nseg = (int)(((long long)n + block_n - 1) / block_n);
  return (int)exact_scan::launch_segment_topk(
      dtype, queries, corpus, count_ptr, count, vals, idx, q_n, n, d, block_n,
      nseg, p, static_cast<cudaStream_t>(stream));
}
