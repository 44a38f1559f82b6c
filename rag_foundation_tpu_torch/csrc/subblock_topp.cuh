// Shared device code of the list-scan kernels (ivf_list_scan.cu,
// pq_list_scan.cu): the per-sub-block top-p selection and the (-inf, -1)
// fill of slots that are not computed.
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
