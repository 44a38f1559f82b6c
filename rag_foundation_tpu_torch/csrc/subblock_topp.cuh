// Shared device code of the kernels' selections: for the list-scan kernels
// (ivf_list_scan.cu, pq_list_scan.cu) the per-sub-block top-p and the
// (-inf, -1) fill of slots that are not computed; for the exact-scan
// kernels (block_topk.cu, fused_topk.cu, through exact_scan.cuh) the same
// selection over any width, as a running sorted list (further down).
//
// It is `extract_subblock_topp` of rag_foundation_tpu/ops/pallas_ivf.py:45
// for one 128-row sub-block: p passes of an argmax over the 128 scores
// (value descending, the lowest row winning ties), the winner masked to
// -inf before the next pass. Outputs are laid out pass-major:
//   out[slot, pass*nsub + sb].
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace scan {

constexpr int SUB = 128;   // rows per sub-block = threads per block

// Order-preserving map of a float (no NaN) to an unsigned key, and back:
// a warp-wide maximum is then ONE `redux.sync` instead of a five-step
// shuffle butterfly. -0.0 is folded into +0.0 first, so equal floats have
// equal keys.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The warp-wide winner of (value descending, column ascending) among each
// lane's candidate (mine, col). Two ways with the same result, chosen per
// kernel at build time because each wins in one of them on an H100 at the
// engine's shapes: REDUX (a warp maximum of the value keys, then a warp
// minimum of the columns that hold it) is the faster in the ADC scan, which
// is short of ALU issue slots; the shuffle butterfly is the faster in the
// flat scan, which waits on memory and has them to spare.
template <bool REDUX>
__device__ __forceinline__ void warp_best(float& mine, int& col) {
  if constexpr (REDUX) {
    const unsigned key = order_key(mine);
    const unsigned kbest = __reduce_max_sync(0xffffffffu, key);
    col = (int)__reduce_min_sync(0xffffffffu,
                                 key == kbest ? (unsigned)col : 0xffu);
    mine = key_value(kbest);
  } else {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, mine, s);
      const int oc = __shfl_xor_sync(0xffffffffu, col, s);
      if (ob > mine || (ob == mine && oc < col)) { mine = ob; col = oc; }
    }
  }
}

// One warp selects the top-p of `score[0..128)` (shared memory) and lane 0
// writes (value, row0 + column) at out_*[pass*nsub + sb]; a -inf value
// gets index -1. `out_vals`/`out_idx` point at the slot's output row.
template <bool REDUX>
__device__ __forceinline__ void warp_topp(const float* score, int lane, int p,
                                          int nsub, int sb, int row0,
                                          float* out_vals, int* out_idx) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = score[lane + 32 * i];
  for (int pass = 0; pass < p; ++pass) {
    // the lane's best of its four columns, the lowest column on a tie
    float best = v[0];
    int col = lane;
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (v[i] > best) { best = v[i]; col = lane + 32 * i; }
    warp_best<REDUX>(best, col);
    // every lane now holds the same (best, col)
    if ((col & 31) == lane) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i == (col >> 5)) v[i] = -INFINITY;
    }
    if (lane == 0) {
      out_vals[(size_t)pass * nsub + sb] = best;
      out_idx[(size_t)pass * nsub + sb] = best == -INFINITY ? -1 : row0 + col;
    }
  }
}

// ---- selection over a width that is not one 128-row sub-block -----------
// (block_topk.cu: top-p of a block_n-row corpus block; fused_topk.cu: the
// running top-k of a whole range of rows and the merge of the ranges.)
//
// p first-max passes over W scores give the W scores' best p by (value
// descending, position ascending). The same result comes from ONE pass in
// position order over a list of the best K so far, kept sorted in shared
// memory: a score enters only if it is strictly greater than the list's
// last value (an equal score from a later position loses the tie), and it
// is placed behind every entry that is >= it. The work is one compare a
// score plus one insertion for each score that enters, which for scores in
// no particular order is about K*ln(W/K) of the W.

constexpr int LIST_MAX = 64;   // longest list: two entries a lane

// Fill a warp's list with (-inf, -1).
__device__ __forceinline__ void list_clear(float* lv, int* li, int K, int lane) {
  for (int j = lane; j < K; j += 32) { lv[j] = -INFINITY; li[j] = -1; }
  __syncwarp();
}

// Insert (s, idx), s > lv[K-1], into the warp's sorted list lv/li[0..K),
// K <= LIST_MAX; every lane passes the same (s, idx). Returns the list's
// new last value.
__device__ __forceinline__ float list_insert(float* lv, int* li, int K, int lane,
                                             float s, int idx) {
  const int j0 = lane, j1 = lane + 32;
  const bool ahead0 = j0 < K && lv[j0] >= s;
  const bool ahead1 = j1 < K && lv[j1] >= s;
  const int pos = __popc(__ballot_sync(0xffffffffu, ahead0)) +
                  __popc(__ballot_sync(0xffffffffu, ahead1));
  float v0 = s, v1 = s;
  int i0 = idx, i1 = idx;
  if (j0 < K && j0 > pos) { v0 = lv[j0 - 1]; i0 = li[j0 - 1]; }
  if (j1 < K && j1 > pos) { v1 = lv[j1 - 1]; i1 = li[j1 - 1]; }
  __syncwarp();
  if (j0 < K && j0 >= pos) { lv[j0] = v0; li[j0] = i0; }
  if (j1 < K && j1 >= pos) { lv[j1] = v1; li[j1] = i1; }
  __syncwarp();
  return lv[K - 1];
}

// One warp offers its list the 32 scores its lanes hold, lane order being
// position order; `idx` is each lane's own index. `thresh` is the list's
// last value, kept by the caller across calls.
__device__ __forceinline__ void list_offer(float* lv, int* li, int K, int lane,
                                           float s, int idx, float& thresh) {
  unsigned m = __ballot_sync(0xffffffffu, s > thresh);
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const float sb = __shfl_sync(0xffffffffu, s, b);
    const int ib = __shfl_sync(0xffffffffu, idx, b);
    if (sb > thresh) thresh = list_insert(lv, li, K, lane, sb, ib);
  }
}

// (-inf, -1) for slots [j0, j1) of list l at sub-block sb, all p passes.
__device__ __forceinline__ void fill_dead(float* out_vals, int* out_idx, int l,
                                          int qcap, int width, int nsub, int sb,
                                          int p, int j0, int j1, int t) {
  for (int i = t; i < (j1 - j0) * p; i += SUB) {
    const int j = j0 + i / p, pass = i % p;
    const size_t o = ((size_t)l * qcap + j) * width + (size_t)pass * nsub + sb;
    out_vals[o] = -INFINITY;
    out_idx[o] = -1;
  }
}

}  // namespace scan
