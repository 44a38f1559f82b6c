// Per-sub-block top-p of the int8 list scans (pq_list_scan.cu for int8
// LUTs, ivf_list_scan.cu for int8 rows): scan::warp_topp's selection
// (value descending, the lowest row winning ties, p passes over one
// 128-row sub-block) with several slots' passes interleaved, each lane's
// four candidates sorted once (a pass pops the winning lane's head), and
// lane j keeping pass j's winner so that lanes below p write once at the
// end. Outputs at out_*[pass * nsub + sb] as subblock_topp.cuh lays them
// out, (-inf, -1) for a dead row.
//
// Over scores that are exact integers, |score| < 2^24 (the ADC sums), a
// score and its row's position pack into one order-preserving key,
//   key = (score + 2^24) << 7 | (127 - position),   0 for a dead row,
// whose maximum is the best score and, among equal scores, the lowest
// position: one warp maximum a pass instead of two.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "subblock_topp.cuh"

namespace keys {

__device__ __forceinline__ unsigned score_key(int score, int pos) {
  return ((unsigned)(score + (1 << 24)) << 7) | (unsigned)(127 - pos);
}

__device__ __forceinline__ void sort2_desc(unsigned& a, unsigned& b) {
  const unsigned hi = max(a, b), lo = min(a, b);
  a = hi;
  b = lo;
}

// S slots' selections interleaved: the scores of slot q at
// scores[q * sstride] (128 of type T, `dead` for a dead row), its outputs
// at out_*[q * ostride]. p <= 32.
template <int S, typename T>
__device__ __forceinline__ void warp_topp(const T* scores, T dead, int sstride,
                                          int lane, int p, int nsub, int sb,
                                          int row0, float scale,
                                          float* out_vals, int* out_idx,
                                          int ostride) {
  unsigned k[S][4];
#pragma unroll
  for (int q = 0; q < S; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = lane + 32 * i;
      const T v = scores[q * sstride + pos];
      k[q][i] = v == dead ? 0u : score_key((int)v, pos);
    }
    sort2_desc(k[q][0], k[q][1]);
    sort2_desc(k[q][2], k[q][3]);
    sort2_desc(k[q][0], k[q][2]);
    sort2_desc(k[q][1], k[q][3]);
    sort2_desc(k[q][1], k[q][2]);
  }
  unsigned won[S] = {};   // lane j keeps pass j's winner
  for (int pass = 0; pass < p; ++pass) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const unsigned kb = __reduce_max_sync(0xffffffffu, k[q][0]);
      const bool pop = k[q][0] == kb;   // keys > 0 are unique
      k[q][0] = pop ? k[q][1] : k[q][0];
      k[q][1] = pop ? k[q][2] : k[q][1];
      k[q][2] = pop ? k[q][3] : k[q][2];
      k[q][3] = pop ? 0u : k[q][3];
      won[q] = lane == pass ? kb : won[q];
    }
  }
  if (lane < p) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const size_t o = (size_t)q * ostride + (size_t)lane * nsub + sb;
      out_vals[o] =
          won[q] ? __int2float_rn((int)(won[q] >> 7) - (1 << 24)) * scale
                 : -INFINITY;
      out_idx[o] = won[q] ? row0 + 127 - (int)(won[q] & 127u) : -1;
    }
  }
}

// The same selection over f32 scores (the flat scan's float(int32 dot) *
// scale: distinct dots may round to one float, which is then a tie), in
// scan::warp_topp's order: a warp maximum of the order-preserving value
// keys, then a warp minimum of the positions that hold it. Each lane sorts
// its four (value, position) pairs once and pops its head when it wins.
template <int S>
__device__ __forceinline__ void warp_topp(const float* scores, float,
                                          int sstride, int lane, int p,
                                          int nsub, int sb, int row0, float,
                                          float* out_vals, int* out_idx,
                                          int ostride) {
  unsigned k[S][4];
  int c[S][4];
  auto cas = [](unsigned& ka, int& ca, unsigned& kb, int& cb) {
    if (kb > ka || (kb == ka && cb < ca)) {
      const unsigned tk = ka; ka = kb; kb = tk;
      const int tc = ca; ca = cb; cb = tc;
    }
  };
#pragma unroll
  for (int q = 0; q < S; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[q][i] = lane + 32 * i;
      k[q][i] = scan::order_key(scores[q * sstride + c[q][i]]);
    }
    cas(k[q][0], c[q][0], k[q][1], c[q][1]);
    cas(k[q][2], c[q][2], k[q][3], c[q][3]);
    cas(k[q][0], c[q][0], k[q][2], c[q][2]);
    cas(k[q][1], c[q][1], k[q][3], c[q][3]);
    cas(k[q][1], c[q][1], k[q][2], c[q][2]);
  }
  unsigned wk[S] = {};   // lane j keeps pass j's winner
  int wc[S] = {};
  for (int pass = 0; pass < p; ++pass) {
    unsigned kb[S];
#pragma unroll
    for (int q = 0; q < S; ++q) kb[q] = __reduce_max_sync(0xffffffffu, k[q][0]);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int cb = (int)__reduce_min_sync(
          0xffffffffu, k[q][0] == kb[q] ? (unsigned)c[q][0] : 0xffu);
      const bool pop = c[q][0] == cb;
      k[q][0] = pop ? k[q][1] : k[q][0];  c[q][0] = pop ? c[q][1] : c[q][0];
      k[q][1] = pop ? k[q][2] : k[q][1];  c[q][1] = pop ? c[q][2] : c[q][1];
      k[q][2] = pop ? k[q][3] : k[q][2];  c[q][2] = pop ? c[q][3] : c[q][2];
      k[q][3] = pop ? 0u : k[q][3];       c[q][3] = pop ? 0xff : c[q][3];
      wk[q] = lane == pass ? kb[q] : wk[q];
      wc[q] = lane == pass ? cb : wc[q];
    }
  }
  if (lane < p) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const size_t o = (size_t)q * ostride + (size_t)lane * nsub + sb;
      const float best = scan::key_value(wk[q]);
      out_vals[o] = best;
      out_idx[o] = best == -INFINITY ? -1 : row0 + wc[q];
    }
  }
}

// Slots [j0, j1), step `step` (the scores of slot j at scores[j * SUB]
// for step 1, ...), in groups of 4, 2 and 1.
template <typename T>
__device__ __forceinline__ void warp_topp_slots(const T* scores, T dead,
                                                int j0, int j1, int step,
                                                int lane, int p, int nsub,
                                                int sb, int row0, float scale,
                                                float* out_vals, int* out_idx,
                                                int width) {
  constexpr int SUB = 128;
  int j = j0;
  for (; j + 3 * step < j1; j += 4 * step)
    warp_topp<4>(scores + j * SUB, dead, step * SUB, lane, p, nsub, sb, row0,
                 scale, out_vals + (size_t)j * width,
                 out_idx + (size_t)j * width, step * width);
  if (j + step < j1) {
    warp_topp<2>(scores + j * SUB, dead, step * SUB, lane, p, nsub, sb, row0,
                 scale, out_vals + (size_t)j * width,
                 out_idx + (size_t)j * width, step * width);
    j += 2 * step;
  }
  if (j < j1)
    warp_topp<1>(scores + j * SUB, dead, step * SUB, lane, p, nsub, sb, row0,
                 scale, out_vals + (size_t)j * width,
                 out_idx + (size_t)j * width, step * width);
}

}  // namespace keys
