// IVF list scan for Hopper (sm_90a): per posting list, score the queries
// dispatched to it against every row of the list and keep the top-p rows
// of each 128-row sub-block.
//
// Replaces the Pallas TPU kernel `_ivf_scan_kernel` behind
// `ivf_list_scan` (rag_foundation_tpu/ops/pallas_ivf.py:74 and :101, with
// its selection `extract_subblock_topp` at :45). Same contract:
//
//   vals[l, s, j*nsub + b], idx[l, s, j*nsub + b]
//     = j-th best of qdisp[l, s] . lists[l, b*128 + r] over r in [0, 128),
//       dead rows (row_ids < 0) scoring -inf, the first (lowest) row
//       winning ties; idx = l*cap_len + b*128 + r, or -1 for a -inf value.
//   int8:  score = float(int32 dot) * scale   (bit-identical to the plain
//          PyTorch version: the int32 dot is exact, one f32 multiply)
//   f32 / bf16: score = f32 sum of products (order differs from a BLAS).
//   Query slots s >= live_n[l] (the dead tail of a list's dispatch, when
//   the caller passes live_n) are not computed: their outputs are
//   (-inf, -1) and a list with no live slot is never read. Other dead
//   slots are computed unmasked, as on the TPU (the caller never reads
//   them). Dead rows are never read either: their score is -inf from
//   row_ids alone, so only the ids of a dead row cross the bus.
//
// int8 lists (the engine's ivf_flat_int8 tier) take `ivf_scan_s8`, a
// design for Hopper:
//
//   Bound on an H100 (3.35 TB/s HBM, 1,979 int8 TOP/s): per batch the
//   kernel must read the live rows of every list that has a query once,
//   every row id of those lists, the live query slots, and write the
//   outputs; its products are 2 * live slots * d a row byte, far below the
//   card's int8 ridge (about 590 operations a byte), so bytes bound it.
//   Design: a block of four warps owns a list (or every gridDim.x-th of its
//   sub-blocks at small nlist) and walks its sub-blocks. It stages the
//   list's query tile (16 slots) ONCE, then streams (sub-block, 128-byte
//   K chunk) tiles of 128 rows through a ring of four shared-memory stages
//   filled by 16-byte `cp.async`, three tiles in flight while it computes
//   the fourth (about 48 KB in flight a block, two blocks an SM). Dead rows
//   are zero-filled by `cp.async` with a source size of 0: their bytes are
//   never read, which a TMA box could not skip (a box reads the about 13%
//   dead rows the store interleaves through every sub-block). The scores
//   are int8 tensor-core products (`mma.sync` m16n8k32, rows as A through
//   `ldmatrix`, the query tile as B) into int32 accumulators in registers,
//   each warp 32 rows x 16 slots; only the n-tiles of 8 slots that hold a
//   live slot are computed, so a list with at most 8 live slots does half
//   the products. Row ids are loaded a sub-block ahead. After the last
//   chunk of a sub-block the scores (float(int32 dot) * scale, -inf for
//   dead rows) go to shared memory and each warp runs the top-p of its
//   slots, four interleaved (topp_keys.cuh), while the next sub-block's
//   tiles are already in flight.
//
// bf16 lists (BASELINE config 3: 1M x 768, nlist 4096) take
// `ivf_scan_bf16`, the same design in bf16:
//
//   Bound: the live bf16 rows of every list with a query read once (2
//   bytes an element), 2 * live slots * d operations a row, under the
//   bf16 ridge (about 295 operations a byte) at any qcap here, so
//   bytes bound it. The products are `mma.sync` m16n8k16 bf16 with f32
//   accumulation (the TPU kernel's bf16 MXU product with f32
//   accumulation); a bf16 k-step is 32 bytes, as an int8 one, so the
//   ldmatrix addressing is ivf_scan_s8's. Differences:
//   * One pass streams a list's rows once for up to QT = 16 or 32 live
//     slots (by qcap: nprobe 32 gives qcap 16; nprobe 64 and 128 give 32
//     and 64, the latter in passes of 32), each warp 32 rows x QT slots in
//     registers, only the n-tiles of 8 slots that hold a live slot
//     computed. Both keep two blocks an SM (4 and 3 ring stages); a 64-slot
//     pass (a 99 KB query tile, one block an SM, 6 stages) took 2.43-2.74
//     ms on an H100 against 1.64-1.65 for two 32-slot passes at config 3's
//     nprobe 128 shape class (Poisson(32) live slots a list;
//     tools/time_kernels.py --only flat --other-flat). There, streaming
//     the rows alone (both passes, no products, scores or selection)
//     takes 0.90 ms of the route's 1.66 against a 0.53 ms bound.
//   * Fold. The index interleaves a list's rows over its sub-blocks, so
//     the live rows of a sub-block are its first ceil(m / nsub): at
//     config 3 about 41 of 128. The block reads each owned sub-block's
//     row ids once up front (as bits in shared memory) and takes the live
//     extent E of each: a sub-block of no live row is skipped (nothing
//     read, (-inf, -1) written), and one with E <= 32 (or 64) lays FOUR
//     (or two) K chunks ("folds") of its first 32 (64) rows side by side
//     in one 128-row stage, so that a stage carries four (two) times the
//     live bytes, each row's chunks are read 512 (256) contiguous bytes at
//     a time, and the ring keeps that many more bytes in flight. Each warp
//     computes 32 stage rows, a share of K of their sums; at the end of
//     the sub-block the folds' shares are added in fold order
//     (deterministic) before the top-p. On an H100 this beat stages
//     shared by the first rows of two sub-blocks at one K chunk (each
//     row's K in one warp, no adding of shares, 128 bytes of a row at a
//     time).
//   * Scores go to shared memory 16 slots a round, the top-p after each.
//
// f32 lists (the engine's ivf_flat mode) take `ivf_scan_f32`, the same
// ring with exact f32 FMA:
//
//   Bound: the live f32 rows read once (4 bytes an element); 2 * live
//   slots * d operations a row at the f32 FMA peak (67 TFLOP/s) stay under
//   the bytes line at config 3's nprobe 32 (about a fifth of it) and near
//   it at nprobe 128, so no tensor core is needed for speed, and TF32
//   (about three decimal digits) is not allowed for the results: every
//   product is an `fmaf` into an f32 sum, in K order within each part of
//   K and the parts added in part order, so a run is deterministic.
//   Differences from ivf_scan_bf16:
//   * An f32 query tile does not fit shared memory (64 slots x 3,072
//     bytes), so each stage carries the pass's live slots at its own K
//     chunk beside the rows' (a 16 KB row tile and an 8 KB query tile,
//     swizzled by 16-byte unit, three stages, two blocks an SM), and one
//     pass streams the rows once for up to 64 live slots.
//   * Groups, not folds. A sub-block's live rows are its first E (about
//     41 of 128 at config 3), so the block packs the live extents of
//     consecutive sub-blocks side by side into one 128-row stage (three
//     at config 3: 123 rows of 128 computed where folds of 64 rows would
//     compute 82 for 41) and walks each group's K chunks; every stage
//     reads one K chunk of the queries, shared by all its rows.
//   * Shared memory, not the FMA pipe, is the first limit of FMA products
//     from a tile: a 16-byte load costs four wavefronts whatever lanes
//     share it (on an H100, 128 bytes a clock an SM against 128 FMAs), so
//     a loaded value has to feed four FMAs. Each lane therefore holds 8
//     rows x 4-12 slots: the 32 floats of a stage's K are split over the
//     warps (a quarter each up to 3 live groups of 8 slots, a half a pair
//     up to 6, whole past that), each part's sums added in part order at
//     the group's end. Only live groups are computed: each group count has
//     its own instantiation of the pass, registers and all.
//   * At a group's end its scores go to shared memory (every slot of the
//     pass at once); each warp then takes (sub-block, 4 slots) turns of
//     the top-p, masked by the sub-block's extent and live bits.
//
// int8 and bf16 rows too wide for their query tiles, and any type at
// p > 32 (a lane keeps each pass's winner), take `ivf_scan_kernel`
// (one 128-thread block per (list, sub-block), thread t owns row t, FMA
// with the query chunk broadcast from shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_s8.cuh"
#include "subblock_topp.cuh"
#include "topp_keys.cuh"

namespace {

constexpr int SUB = scan::SUB;           // rows per sub-block = threads
constexpr int CHUNK = 128;               // bytes of each row per stage
constexpr int ROW_STRIDE = CHUNK + 16;   // padded: conflict-free 16 B reads
constexpr int WARPS = SUB / 32;

__device__ __forceinline__ void dot16(const int4 r, const int4 q, int& acc) {
  acc = __dp4a(r.x, q.x, acc);
  acc = __dp4a(r.y, q.y, acc);
  acc = __dp4a(r.z, q.z, acc);
  acc = __dp4a(r.w, q.w, acc);
}

__device__ __forceinline__ void dot16(const int4 r, const int4 q, float& acc) {
  acc = fmaf(__int_as_float(r.x), __int_as_float(q.x), acc);
  acc = fmaf(__int_as_float(r.y), __int_as_float(q.y), acc);
  acc = fmaf(__int_as_float(r.z), __int_as_float(q.z), acc);
  acc = fmaf(__int_as_float(r.w), __int_as_float(q.w), acc);
}

// bf16 -> f32 is the top 16 bits of the f32 pattern
__device__ __forceinline__ float bf_lo(int w) { return __int_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(int w) {
  return __int_as_float(w & (int)0xffff0000u);
}

__device__ __forceinline__ void dot16_bf16(const int4 r, const int4 q, float& acc) {
  acc = fmaf(bf_lo(r.x), bf_lo(q.x), acc);
  acc = fmaf(bf_hi(r.x), bf_hi(q.x), acc);
  acc = fmaf(bf_lo(r.y), bf_lo(q.y), acc);
  acc = fmaf(bf_hi(r.y), bf_hi(q.y), acc);
  acc = fmaf(bf_lo(r.z), bf_lo(q.z), acc);
  acc = fmaf(bf_hi(r.z), bf_hi(q.z), acc);
  acc = fmaf(bf_lo(r.w), bf_lo(q.w), acc);
  acc = fmaf(bf_hi(r.w), bf_hi(q.w), acc);
}

// KIND: 0 int8, 1 f32, 2 bf16 (element type only shows through the byte
// width of a row; all loads are 16-byte vectors)
template <int KIND> struct Acc { using type = float; };
template <> struct Acc<0> { using type = int; };

template <int KIND, int QT>
__global__ void __launch_bounds__(SUB)
ivf_scan_kernel(const unsigned char* __restrict__ qdisp,
                const unsigned char* __restrict__ lists,
                const int* __restrict__ row_ids,
                const int* __restrict__ live_n,
                float* __restrict__ out_vals, int* __restrict__ out_idx,
                int qcap, int cap_len, int row_bytes, int p, float scale) {
  using AccT = typename Acc<KIND>::type;
  __shared__ __align__(16) unsigned char rows_s[SUB * ROW_STRIDE];
  __shared__ __align__(16) unsigned char q_s[QT * CHUNK];
  __shared__ float score_s[QT][SUB];
  __shared__ unsigned char live_s[SUB];

  const int sb = blockIdx.x;              // sub-block within the list
  const int l = blockIdx.y;               // list
  const int nsub = cap_len / SUB;
  const int width = nsub * p;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const size_t row0 = (size_t)l * cap_len + (size_t)sb * SUB;
  const unsigned char* rows_g = lists + row0 * row_bytes;
  const unsigned char* q_g = qdisp + (size_t)l * qcap * row_bytes;
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);

  // dead tail of the dispatch: (-inf, -1), nothing read
  scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub, sb, p, nlive, qcap, t);
  if (nlive == 0) return;
  const bool live = row_ids[row0 + t] >= 0;
  live_s[t] = live;
  if (__syncthreads_count(live) == 0) {
    // a sub-block of dead rows: (-inf, -1) for every live slot
    scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub, sb, p, 0, nlive, t);
    return;
  }

  for (int q0 = 0; q0 < nlive; q0 += QT) {
    const int nq = min(QT, nlive - q0);
    AccT acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;

    for (int off = 0; off < row_bytes; off += CHUNK) {
      const int n16 = min(CHUNK, row_bytes - off) / 16;
      __syncthreads();  // the previous chunk (or tile's scores) is consumed
      for (int i = t; i < SUB * n16; i += SUB) {
        const int r = i / n16, c = i - r * n16;
        if (!live_s[r]) continue;  // its score is masked; stale bytes stay
        *reinterpret_cast<int4*>(rows_s + r * ROW_STRIDE + c * 16) =
            *reinterpret_cast<const int4*>(rows_g + (size_t)r * row_bytes +
                                           off + c * 16);
      }
      for (int i = t; i < QT * n16; i += SUB) {
        const int j = i / n16, c = i - j * n16;
        int4 v = make_int4(0, 0, 0, 0);
        if (j < nq)
          v = *reinterpret_cast<const int4*>(
              q_g + (size_t)(q0 + j) * row_bytes + off + c * 16);
        *reinterpret_cast<int4*>(q_s + j * CHUNK + c * 16) = v;
      }
      __syncthreads();
      for (int c = 0; c < n16; ++c) {
        const int4 rv =
            *reinterpret_cast<const int4*>(rows_s + t * ROW_STRIDE + c * 16);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const int4 qv = *reinterpret_cast<const int4*>(q_s + j * CHUNK + c * 16);
          if constexpr (KIND == 2) {
            dot16_bf16(rv, qv, acc[j]);
          } else {
            dot16(rv, qv, acc[j]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < QT; ++j) {
      float s;
      if constexpr (KIND == 0) {
        s = __int2float_rn(acc[j]) * scale;
      } else {
        s = acc[j];
      }
      score_s[j][t] = live ? s : -INFINITY;
    }
    __syncthreads();

    for (int j = warp; j < nq; j += WARPS) {
      const size_t out0 = ((size_t)l * qcap + q0 + j) * width;
      scan::warp_topp<false>(score_s[j], lane, p, nsub, sb, (int)row0, out_vals + out0,
                      out_idx + out0);
    }
  }
}

// ---- int8 lists: tensor cores fed by a cp.async ring ------------------------
constexpr int S8_WARPS = 4;
constexpr int S8_THREADS = S8_WARPS * 32;            // 128: 32 rows a warp
constexpr int S8_STAGES = 4;                         // ring depth
constexpr int S8_QT = 16;                            // query slots a pass
constexpr int S8_STAGE_BYTES = SUB * ROW_STRIDE;     // one 128 x 128-byte tile
constexpr int S8_LIVE_BUFS = 4;                      // sub-blocks' row flags
static_assert(S8_THREADS == SUB, "fill_dead strides by SUB threads");

// Shared memory of ivf_scan_s8 for rows of `row_bytes` bytes.
__host__ __device__ inline size_t s8_smem_bytes(int row_bytes) {
  const int qstride = ((row_bytes + 31) & ~31) + 16;
  return (size_t)S8_STAGES * S8_STAGE_BYTES + (size_t)S8_QT * qstride +
         (size_t)S8_QT * SUB * 4 + (size_t)S8_LIVE_BUFS * SUB;
}

__global__ void __launch_bounds__(S8_THREADS, 2)
ivf_scan_s8(const signed char* __restrict__ qdisp,
            const signed char* __restrict__ lists,
            const int* __restrict__ row_ids, const int* __restrict__ live_n,
            float* __restrict__ out_vals, int* __restrict__ out_idx, int qcap,
            int cap_len, int row_bytes, int p, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = (row_bytes + 31) & ~31;        // K in whole mma steps
  const int qstride = kpad + 16;                  // odd 16-byte units: no
  unsigned char* rows_s = smem;                   // ldmatrix conflicts
  unsigned char* q_s = smem + S8_STAGES * S8_STAGE_BYTES;
  float* score_s = reinterpret_cast<float*>(q_s + S8_QT * qstride);
  unsigned char* live_s = reinterpret_cast<unsigned char*>(score_s + S8_QT * SUB);

  const int l = blockIdx.y;
  const int nsub = cap_len / SUB;
  const int width = nsub * p;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = gridDim.x;
  const int nown = (nsub - (int)blockIdx.x + G - 1) / G;   // sub-blocks owned
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);

  // dead tail of the dispatch: (-inf, -1), nothing read
  if (nlive < qcap)
    for (int k = 0; k < nown; ++k)
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub,
                      blockIdx.x + k * G, p, nlive, qcap, t);
  if (nlive == 0 || nown <= 0) return;

  const int nkc = (row_bytes + CHUNK - 1) / CHUNK;   // K chunks a row
  const int units = nown * nkc;                      // (sub-block, chunk)
  const size_t list0 = (size_t)l * cap_len;
  const signed char* q_g = qdisp + (size_t)l * qcap * row_bytes;
  // copy assignment: 16-byte column c16 of rows r0 + 16 i, i < 8
  const int c16 = t & 7, r0 = t >> 3;
  const int lj = lane >> 3, lr = lane & 7;           // ldmatrix addressing

  for (int q0 = 0; q0 < nlive; q0 += S8_QT) {
    const int nq = min(S8_QT, nlive - q0);
    const int nt = (nq + 7) >> 3;                    // live n-tiles: 1 or 2
    __syncthreads();   // the previous pass is done with every buffer
    // the query tile, once a pass: nq slots, zero-filled to 16 x kpad
    for (int i = t; i < S8_QT * (kpad / 16); i += S8_THREADS) {
      const int j = i / (kpad / 16), c = i - j * (kpad / 16);
      const bool ok = j < nq && c * 16 < row_bytes;
      s8::cp_async16(q_s + j * qstride + c * 16,
                     ok ? (const void*)(q_g + (size_t)(q0 + j) * row_bytes +
                                        c * 16)
                        : (const void*)q_g,
                     ok ? 16 : 0);
    }
    s8::cp_async_commit();

    unsigned live_bits = 0;   // this thread's copy rows of the sub-block
    int ids_next[8];          // their ids in the next sub-block, loaded a
    auto load_ids = [&](int k) {   // sub-block ahead
      if (k >= nown) return;
      const size_t row0 = list0 + (size_t)(blockIdx.x + k * G) * SUB;
#pragma unroll
      for (int i = 0; i < 8; ++i) ids_next[i] = row_ids[row0 + r0 + 16 * i];
    };
    load_ids(0);
    auto issue = [&](int u) {
      const int k = u / nkc, kc = u - k * nkc;
      const size_t row0 = list0 + (size_t)(blockIdx.x + k * G) * SUB;
      unsigned char* st = rows_s + (u % S8_STAGES) * S8_STAGE_BYTES;
      if (kc == 0) {
        live_bits = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 16 * i;
          const bool lv = ids_next[i] >= 0;
          live_bits |= (unsigned)lv << i;
          if (c16 == 0) live_s[(k % S8_LIVE_BUFS) * SUB + r] = lv;
        }
        load_ids(k + 1);
      }
      const int col = kc * CHUNK + c16 * 16;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + 16 * i;
        // dead rows and the K padding are zero-filled, never read
        const bool ok = col < row_bytes && ((live_bits >> i) & 1u);
        s8::cp_async16(st + r * ROW_STRIDE + c16 * 16,
                       ok ? (const void*)(lists + (row0 + r) * row_bytes + col)
                          : (const void*)lists,
                       ok ? 16 : 0);
      }
    };

    int acc[2][2][4];   // [row group of 16][n-tile of 8 slots][fragment]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

#pragma unroll
    for (int s = 0; s < S8_STAGES - 1; ++s) {
      if (s < units) issue(s);
      s8::cp_async_commit();
    }
    for (int u = 0; u < units; ++u) {
      s8::cp_async_wait<S8_STAGES - 2>();   // unit u (and the tile) landed
      __syncthreads();                      // ... for every thread; stage
      if (u + S8_STAGES - 1 < units)        // (u-1) % S is free again
        issue(u + S8_STAGES - 1);
      s8::cp_async_commit();

      const int k = u / nkc, kc = u - k * nkc;
      const unsigned char* st = rows_s + (u % S8_STAGES) * S8_STAGE_BYTES;
      const int ksteps = min(CHUNK, kpad - kc * CHUNK) / 32;
      for (int ks = 0; ks < ksteps; ++ks) {
        // B: slots (lj >> 1) * 8 + lr, bytes (lj & 1) * 16 of this k-step
        unsigned b[2][2];
        const unsigned char* qp = q_s + ((lj >> 1) * 8 + lr) * qstride +
                                  kc * CHUNK + ks * 32 + (lj & 1) * 16;
        if (nt == 2) {
          unsigned r[4];
          s8::ldmatrix_x4(r, qp);
          b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
        } else {
          unsigned r[2];
          s8::ldmatrix_x2(r, qp);
          b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = 0u; b[1][1] = 0u;
        }
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          // A: rows warp*32 + grp*16 + (lj & 1) * 8 + lr, bytes (lj >> 1) * 16
          unsigned a[4];
          s8::ldmatrix_x4(a, st + (warp * 32 + grp * 16 + (lj & 1) * 8 + lr) *
                                      ROW_STRIDE + ks * 32 + (lj >> 1) * 16);
          s8::mma_s8(acc[grp][0], a, b[0][0], b[0][1]);
          if (nt == 2) s8::mma_s8(acc[grp][1], a, b[1][0], b[1][1]);
        }
      }

      if (kc == nkc - 1) {   // the sub-block is scored: top-p
        const int sb = blockIdx.x + k * G;
        const unsigned char* lv = live_s + (k % S8_LIVE_BUFS) * SUB;
#pragma unroll
        for (int grp = 0; grp < 2; ++grp)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = warp * 32 + grp * 16 + g + (e >= 2 ? 8 : 0);
              const int slot = n * 8 + tig * 2 + (e & 1);
              if (n < nt && slot < nq)
                score_s[slot * SUB + row] =
                    lv[row] ? __int2float_rn(acc[grp][n][e]) * scale
                            : -INFINITY;
              acc[grp][n][e] = 0;
            }
        __syncthreads();
        const int row0 = (int)(list0 + (size_t)sb * SUB);
        // this warp's slots warp, warp + 4, ... interleaved (topp_keys.cuh)
        keys::warp_topp_slots(score_s, -INFINITY, warp, nq, S8_WARPS, lane,
                              p, nsub, sb, row0, 1.0f,
                              out_vals + ((size_t)l * qcap + q0) * width,
                              out_idx + ((size_t)l * qcap + q0) * width,
                              width);
      }
    }
  }
}

cudaError_t launch_s8(const void* qdisp, const void* lists, const int* row_ids,
                      const int* live_n, float* vals, int* idx, int nlist,
                      int qcap, int cap_len, int row_bytes, int p, float scale,
                      cudaStream_t stream) {
  const size_t smem = s8_smem_bytes(row_bytes);
  auto kernel = ivf_scan_s8;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // blocks a list: one at the engine's nlist; at small nlist enough to
  // give every SM two
  const int nsub = cap_len / SUB;
  int groups = (264 + nlist - 1) / nlist;
  groups = groups > nsub ? nsub : groups;
  const dim3 grid(groups, nlist);
  kernel<<<grid, S8_THREADS, smem, stream>>>(
      static_cast<const signed char*>(qdisp),
      static_cast<const signed char*>(lists), row_ids, live_n, vals, idx,
      qcap, cap_len, row_bytes, p, scale);
  return cudaGetLastError();
}

// ---- bf16 lists: bf16 tensor cores fed by a cp.async ring ------------------
constexpr int BF_ROUND = 16;      // query slots a score round
constexpr int BF_MAX_OWN = 128;   // sub-blocks a block owns at most

// Shared memory of ivf_scan_bf16<QT, STAGES> for rows of `row_bytes`.
__host__ __device__ inline size_t bf_smem_bytes(int qt, int stages,
                                                int row_bytes) {
  const int qstride = ((row_bytes + 31) & ~31) + 16;
  return (size_t)stages * S8_STAGE_BYTES + (size_t)qt * qstride +
         (size_t)BF_ROUND * SUB * 4 + (size_t)BF_MAX_OWN * 4 * 4 +
         BF_MAX_OWN;
}

// A sub-block's fold from its live-row bits (four words of 32 rows): 0
// when no row is live, else log2 of the rows a fold covers minus 4 (1: the
// live rows lie in the first 32, four folds a stage; 2: in the first 64,
// two; 3: one fold of all 128).
__device__ __forceinline__ int fold_of(const unsigned* bits) {
  if (bits[2] | bits[3]) return 3;
  if (bits[1]) return 2;
  return bits[0] ? 1 : 0;
}

template <int QT, int STAGES>
__global__ void __launch_bounds__(S8_THREADS, 2)
ivf_scan_bf16(const unsigned char* __restrict__ qdisp,
              const unsigned char* __restrict__ lists,
              const int* __restrict__ row_ids, const int* __restrict__ live_n,
              float* __restrict__ out_vals, int* __restrict__ out_idx,
              int qcap, int cap_len, int row_bytes, int p) {
  constexpr int NT = QT / 8;                       // n-tiles of 8 slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = (row_bytes + 31) & ~31;        // K in whole mma steps
  const int qstride = kpad + 16;
  unsigned char* rows_s = smem;
  unsigned char* q_s = smem + STAGES * S8_STAGE_BYTES;
  float* score_s = reinterpret_cast<float*>(q_s + QT * qstride);
  unsigned* bits_s = reinterpret_cast<unsigned*>(score_s + BF_ROUND * SUB);
  unsigned char* fold_s =
      reinterpret_cast<unsigned char*>(bits_s + BF_MAX_OWN * 4);

  const int l = blockIdx.y;
  const int nsub = cap_len / SUB;
  const int width = nsub * p;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = gridDim.x;
  const int nown = (nsub - (int)blockIdx.x + G - 1) / G;   // sub-blocks owned
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);

  // dead tail of the dispatch: (-inf, -1), nothing read
  if (nlive < qcap)
    for (int k = 0; k < nown; ++k)
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub,
                      blockIdx.x + k * G, p, nlive, qcap, t);
  if (nlive == 0 || nown <= 0) return;

  const size_t list0 = (size_t)l * cap_len;
  const unsigned char* q_g = qdisp + (size_t)l * qcap * row_bytes;
  const int nkc = (row_bytes + CHUNK - 1) / CHUNK;   // K chunks a row

  // the owned sub-blocks' live rows as bits, their row ids read once
  for (int k0 = 0; k0 < nown; k0 += 8) {
    int v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = k0 + j < nown
                 ? row_ids[list0 + (size_t)(blockIdx.x + (k0 + j) * G) * SUB +
                           t]
                 : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, v[j] >= 0);
      if (lane == 0 && k0 + j < nown) bits_s[(k0 + j) * 4 + warp] = b;
    }
  }
  __syncthreads();
  for (int k = t; k < nown; k += S8_THREADS) fold_s[k] = fold_of(bits_s + 4 * k);
  __syncthreads();
  int first = nown;
  for (int k = nown - 1; k >= 0; --k) {
    if (fold_s[k] != 0) {
      first = k;
    } else {   // no live row: (-inf, -1) for every live slot, nothing read
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub,
                      blockIdx.x + k * G, p, 0, nlive, t);
    }
  }
  if (first == nown) return;

  // a unit is (sub-block k, first K chunk kc) of one stage; the producer
  // and the consumer walk the same units
  auto advance = [&](int& k, int& kc) {
    kc += 8 >> fold_s[k];
    if (kc >= nkc) {
      kc = 0;
      do { ++k; } while (k < nown && fold_s[k] == 0);
    }
  };
  // copy assignment: 16-byte column c16 of stage rows r0 + 16 i, i < 8
  const int c16 = t & 7, r0 = t >> 3;
  const int lj = lane >> 3, lr = lane & 7;           // ldmatrix addressing

  for (int q0 = 0; q0 < nlive; q0 += QT) {
    const int nq = min(QT, nlive - q0);
    const int nt = (nq + 7) >> 3;                    // live n-tiles
    __syncthreads();   // the previous pass is done with every buffer
    // the query tile, once a pass: nq slots, zero-filled to QT x kpad
    for (int i = t; i < QT * (kpad / 16); i += S8_THREADS) {
      const int j = i / (kpad / 16), c = i - j * (kpad / 16);
      const bool ok = j < nq && c * 16 < row_bytes;
      s8::cp_async16(q_s + j * qstride + c * 16,
                     ok ? (const void*)(q_g + (size_t)(q0 + j) * row_bytes +
                                        c * 16)
                        : (const void*)q_g,
                     ok ? 16 : 0);
    }
    s8::cp_async_commit();

    // stage row j holds row (j mod E) of K chunk kc + j / E, E = 16 << fold
    auto issue = [&](int k, int kc, int stage) {
      const int sh = fold_s[k] + 4;
      const size_t row0 = list0 + (size_t)(blockIdx.x + k * G) * SUB;
      const unsigned* bits = bits_s + 4 * k;
      unsigned char* st = rows_s + stage * S8_STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = r0 + 16 * i;
        const int r = j & ((1 << sh) - 1);
        const int col = (kc + (j >> sh)) * CHUNK + c16 * 16;
        // dead rows and K past the row are zero-filled, never read
        const bool ok = col < row_bytes && ((bits[r >> 5] >> (r & 31)) & 1u);
        s8::cp_async16(st + j * ROW_STRIDE + c16 * 16,
                       ok ? (const void*)(lists + (row0 + r) * row_bytes + col)
                          : (const void*)lists,
                       ok ? 16 : 0);
      }
    };

    float acc[2][NT][4];   // [row group of 16][n-tile of 8 slots][fragment]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NT; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

    int pk = first, pkc = 0;    // the next unit to issue
    int ck = first, ckc = 0;    // the unit to compute
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (pk < nown) {
        issue(pk, pkc, s);
        advance(pk, pkc);
      }
      s8::cp_async_commit();
    }
    for (int u = 0; ck < nown; ++u) {
      s8::cp_async_wait<STAGES - 2>();   // unit u (and the tile) landed
      __syncthreads();                   // ... for every thread; stage
      if (pk < nown) {                   // (u-1) % STAGES is free again
        issue(pk, pkc, (u + STAGES - 1) % STAGES);
        advance(pk, pkc);
      }
      s8::cp_async_commit();

      const int sh = fold_s[ck] + 4;
      const int kc = ckc + ((warp * 32) >> sh);      // this warp's K chunk
      const unsigned char* st = rows_s + (u % STAGES) * S8_STAGE_BYTES;
      const int ksteps = kc < nkc ? min(CHUNK, kpad - kc * CHUNK) / 32 : 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        // B: slots pr * 16 + (lj >> 1) * 8 + lr, bytes (lj & 1) * 16
        unsigned b[NT][2];
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
          if (2 * pr < nt) {
            unsigned r[4];
            s8::ldmatrix_x4(r, q_s + (pr * 16 + (lj >> 1) * 8 + lr) * qstride +
                                   kc * CHUNK + ks * 32 + (lj & 1) * 16);
            b[2 * pr][0] = r[0];
            b[2 * pr][1] = r[1];
            b[2 * pr + 1][0] = r[2];
            b[2 * pr + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          // A: rows warp*32 + grp*16 + (lj & 1) * 8 + lr, bytes (lj >> 1) * 16
          unsigned a[4];
          s8::ldmatrix_x4(a, st + (warp * 32 + grp * 16 + (lj & 1) * 8 + lr) *
                                      ROW_STRIDE + ks * 32 + (lj >> 1) * 16);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            if (n < nt) flash::mma_16816(acc[grp][n], a, b[n][0], b[n][1]);
        }
      }

      if (ckc + (8 >> fold_s[ck]) >= nkc) {   // the sub-block is scored
        const int sb = blockIdx.x + ck * G;
        const int rows = 1 << sh;              // rows of a fold
        const unsigned* bits = bits_s + 4 * ck;
        const int row0 = (int)(list0 + (size_t)sb * SUB);
#pragma unroll
        for (int rd = 0; rd < QT / BF_ROUND; ++rd) {
          if (rd * BF_ROUND < nq) {
            const int nr = min(BF_ROUND, nq - rd * BF_ROUND);
            // this warp's share of the round's slots at its stage rows
#pragma unroll
            for (int grp = 0; grp < 2; ++grp)
#pragma unroll
              for (int nn = 0; nn < 2; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = warp * 32 + grp * 16 + g + (e >= 2 ? 8 : 0);
                  const int slot = nn * 8 + tig * 2 + (e & 1);
                  if (slot < nr)
                    score_s[slot * SUB + row] = acc[grp][2 * rd + nn][e];
                }
            __syncthreads();
            // the folds' shares added in fold order; dead rows -inf
            for (int i = t; i < nr * rows; i += S8_THREADS) {
              const int s = i >> sh, r = i & (rows - 1);
              float* sc = score_s + s * SUB;
              float v = sc[r];
              for (int f = 1; f < (SUB >> sh); ++f) {
                v += sc[f * rows + r];
                sc[f * rows + r] = -INFINITY;
              }
              sc[r] = ((bits[r >> 5] >> (r & 31)) & 1u) ? v : -INFINITY;
            }
            __syncthreads();
            const size_t out0 =
                ((size_t)l * qcap + q0 + rd * BF_ROUND) * width;
            // this warp's slots warp, warp + 4, ... interleaved
            keys::warp_topp_slots(score_s, -INFINITY, warp, nr, S8_WARPS,
                                  lane, p, nsub, sb, row0, 1.0f,
                                  out_vals + out0, out_idx + out0, width);
            if ((rd + 1) * BF_ROUND < nq) __syncthreads();
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < NT; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
      }
      advance(ck, ckc);
    }
  }
}

template <int QT, int STAGES>
cudaError_t launch_bf16_as(const void* qdisp, const void* lists,
                           const int* row_ids, const int* live_n, float* vals,
                           int* idx, int nlist, int qcap, int cap_len,
                           int row_bytes, int p, cudaStream_t stream) {
  const size_t smem = bf_smem_bytes(QT, STAGES, row_bytes);
  auto kernel = ivf_scan_bf16<QT, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // blocks a list: one at the engine's nlist; at small nlist enough to fill
  // the SMs; enough that none owns more than BF_MAX_OWN sub-blocks
  const int nsub = cap_len / SUB;
  int groups = (264 + nlist - 1) / nlist;   // two blocks an SM
  groups = groups > nsub ? nsub : groups;
  const int least = (nsub + BF_MAX_OWN - 1) / BF_MAX_OWN;
  groups = groups < least ? least : groups;
  const dim3 grid(groups, nlist);
  kernel<<<grid, S8_THREADS, smem, stream>>>(
      static_cast<const unsigned char*>(qdisp),
      static_cast<const unsigned char*>(lists), row_ids, live_n, vals, idx,
      qcap, cap_len, row_bytes, p);
  return cudaGetLastError();
}

// ---- f32 lists: exact f32 FMA fed by a cp.async ring -----------------------
constexpr int F32_QT = 64;                       // query slots a pass
constexpr int F32_STAGES = 3;                    // ring depth
constexpr int F32_ROWS = SUB * CHUNK;            // row tile: 128 x 128 bytes
constexpr int F32_QTILE = F32_QT * CHUNK;        // query tile: 64 x 128 bytes
constexpr int F32_STAGE_BYTES = F32_ROWS + F32_QTILE;

// Shared memory of ivf_scan_f32, whatever the row width: the ring, the
// pass's scores, the owned sub-blocks' live bits, and per sub-block its
// live extent, its offset in its group and the groups' first sub-blocks
constexpr size_t f32_smem_bytes() {
  return (size_t)F32_STAGES * F32_STAGE_BYTES + (size_t)F32_QT * SUB * 4 +
         (size_t)BF_MAX_OWN * 4 * 4 + (size_t)BF_MAX_OWN * 4;
}
static_assert(2 * (f32_smem_bytes() + 1024) <= 228 * 1024,
              "ivf_scan_f32 keeps two blocks an SM");

// Byte offset of 16-byte unit c of row j of a tile of 128-byte rows: the
// units are swizzled by j mod 8 so that the eight rows a quarter-warp
// reads at one unit lie on distinct banks
__device__ __forceinline__ int swz(int j, int c) {
  return j * CHUNK + ((c ^ (j & 7)) << 4);
}

// The split of a stage's products for NG live groups of 8 slots: the 32
// floats of K go to KS parts (4 warps each a quarter of K up to 3 groups,
// 2 pairs of warps each a half up to 6, the block whole past that); in a
// part, lane rl = tp & 15 holds the 8 stage rows rl + 16 i and slot lane
// sl = tp >> 4 the TN slots sl + SL j, so a 16-byte load (4 K values)
// feeds 4 TN or 32 FMAs, and a lane holds 8 TN <= 96 sums
template <int NG> struct F32Split {
  static constexpr int KS = NG <= 3 ? 4 : NG <= 6 ? 2 : 1;   // parts of K
  static constexpr int SL = 8 / KS;              // slot lanes of a part
  static constexpr int TN = NG * KS;             // slots a lane
  static constexpr int NK = 8 / KS;              // 16-byte K steps a part
};

// One stage's products: rows `rows` (the packed stage tile) against the
// pass's slots `qs`, this thread's part of K, summed into acc[i][j] in K
// order with exact fmaf.
template <int NG>
__device__ __forceinline__ void f32_products(
    const unsigned char* rows, const unsigned char* qs, int t,
    float (&acc)[8][F32Split<NG>::TN]) {
  using P = F32Split<NG>;
  const int part = t / (SUB / P::KS), tp = t % (SUB / P::KS);
  const int rl = tp & 15, sl = tp >> 4;
#pragma unroll 1
  for (int kk = 0; kk < P::NK; ++kk) {
    const int k4 = part * P::NK + kk;
    float4 r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = *reinterpret_cast<const float4*>(rows + swz(rl + 16 * i, k4));
#pragma unroll
    for (int j = 0; j < P::TN; ++j) {
      const float4 q =
          *reinterpret_cast<const float4*>(qs + swz(sl + P::SL * j, k4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = acc[i][j];
        a = fmaf(r[i].x, q.x, a);
        a = fmaf(r[i].y, q.y, a);
        a = fmaf(r[i].z, q.z, a);
        a = fmaf(r[i].w, q.w, a);
        acc[i][j] = a;
      }
    }
  }
}

// A group's scores: the parts' sums added into score_s[slot][stage row]
// in part order (deterministic), a block barrier after each part.
template <int NG>
__device__ __forceinline__ void f32_scores(
    float* score_s, int t, const float (&acc)[8][F32Split<NG>::TN]) {
  using P = F32Split<NG>;
  const int part = t / (SUB / P::KS), tp = t % (SUB / P::KS);
  const int rl = tp & 15, sl = tp >> 4;
#pragma unroll
  for (int pt = 0; pt < P::KS; ++pt) {
    if (part == pt) {
#pragma unroll
      for (int j = 0; j < P::TN; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* d = score_s + (sl + P::SL * j) * SUB + rl + 16 * i;
          *d = pt == 0 ? acc[i][j] : *d + acc[i][j];
        }
      }
    }
    __syncthreads();
  }
}

// The top-p of four slots of one sub-block, interleaved, as keys::warp_topp
// selects (value descending, the lowest row winning ties): the scores of
// slot q at sc[q * SUB + r] for rows r < E (the sub-block's live extent),
// a row dead where its bit is clear; slots q < count written.
__device__ __forceinline__ void f32_topp4(const float* sc, int E,
                                          const unsigned* bits, int lane,
                                          int p, int nsub, int sb, int row0,
                                          int count, float* out_vals,
                                          int* out_idx, int ostride) {
  unsigned k[4][4];
  int c[4][4];
  auto cas = [](unsigned& ka, int& ca, unsigned& kb, int& cb) {
    if (kb > ka || (kb == ka && cb < ca)) {
      const unsigned tk = ka; ka = kb; kb = tk;
      const int tc = ca; ca = cb; cb = tc;
    }
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = lane + 32 * i;
      const bool live = pos < E && ((bits[i] >> lane) & 1u);
      c[q][i] = pos;
      k[q][i] = scan::order_key(live ? sc[q * SUB + min(pos, E - 1)]
                                     : -INFINITY);
    }
    cas(k[q][0], c[q][0], k[q][1], c[q][1]);
    cas(k[q][2], c[q][2], k[q][3], c[q][3]);
    cas(k[q][0], c[q][0], k[q][2], c[q][2]);
    cas(k[q][1], c[q][1], k[q][3], c[q][3]);
    cas(k[q][1], c[q][1], k[q][2], c[q][2]);
  }
  unsigned wk[4] = {};   // lane j keeps pass j's winner
  int wc[4] = {};
  for (int pass = 0; pass < p; ++pass) {
    unsigned kb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      kb[q] = __reduce_max_sync(0xffffffffu, k[q][0]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
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
    for (int q = 0; q < 4; ++q) {
      if (q < count) {
        const size_t o = (size_t)q * ostride + (size_t)lane * nsub + sb;
        const float best = scan::key_value(wk[q]);
        out_vals[o] = best;
        out_idx[o] = best == -INFINITY ? -1 : row0 + wc[q];
      }
    }
  }
}

// What a pass of ivf_scan_f32 reads: the block's list, its owned
// sub-blocks' live bits, extents and groups (shared memory), the ring
struct F32Block {
  const unsigned char* lists;
  const unsigned char* q_g;          // the list's query slots
  float* out_vals;
  int* out_idx;
  unsigned char* ring;
  float* score_s;
  const unsigned* bits_s;
  const unsigned char* ext_s;
  const unsigned char* off_s;
  const unsigned char* gfirst_s;
  size_t list0;
  int l, qcap, width, nsub, p, row_bytes, nkc, ngroups;
};

// One pass of ivf_scan_f32 over slots q0 .. q0 + nq - 1 (NG = ceil(nq / 8)
// live groups): every group's rows streamed once, one K chunk a stage.
template <int NG>
__device__ __forceinline__ void f32_pass(const F32Block& b, int q0, int nq) {
  using P = F32Split<NG>;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = gridDim.x;
  // copy assignment: 16-byte column c16 of stage rows r0 + 16 i, i < 8,
  // each the list row roff[i] of the group being issued (or -1: zeros)
  const int c16 = t & 7, r0 = t >> 3;
  int roff[8];
  auto plan_rows = [&](int g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) roff[i] = -1;
    for (int k = b.gfirst_s[g]; k < b.gfirst_s[g + 1]; ++k) {
      const int e = b.ext_s[k], o = b.off_s[k];
      const unsigned* bits = b.bits_s + 4 * k;
      const int base = (blockIdx.x + k * G) * SUB;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + 16 * i - o;
        if (r >= 0 && r < e && ((bits[r >> 5] >> (r & 31)) & 1u))
          roff[i] = base + r;
      }
    }
  };
  // one stage: the group's rows and the pass's 8 NG slots at K chunk kc
  auto issue = [&](int kc, int stage) {
    unsigned char* st = b.ring + stage * F32_STAGE_BYTES;
    const int col = kc * CHUNK + c16 * 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // dead rows, rows past the group and K past the row are
      // zero-filled, never read
      const bool ok = roff[i] >= 0 && col < b.row_bytes;
      s8::cp_async16(
          st + swz(r0 + 16 * i, c16),
          ok ? (const void*)(b.lists + (b.list0 + roff[i]) * b.row_bytes +
                             col)
             : (const void*)b.lists,
          ok ? 16 : 0);
    }
    unsigned char* qt = st + F32_ROWS;
#pragma unroll
    for (int u0 = 0; u0 < NG * 64; u0 += S8_THREADS) {
      const int u = u0 + t;
      const int s = u >> 3, c = u & 7;
      const int cq = kc * CHUNK + c * 16;
      // the pass's dead slots and K past the row are zero-filled
      const bool ok = s < nq && cq < b.row_bytes;
      if (u < NG * 64)
        s8::cp_async16(qt + swz(s, c),
                       ok ? (const void*)(b.q_g + (size_t)(q0 + s) *
                                                      b.row_bytes + cq)
                          : (const void*)b.q_g,
                       ok ? 16 : 0);
    }
  };

  float acc[8][P::TN];   // [stage row i][slot j] of this thread's part
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < P::TN; ++j) acc[i][j] = 0.f;

  __syncthreads();   // the previous pass is done with every buffer
  // a unit is (group g, K chunk kc) of one stage; the producer and the
  // consumer walk the same units
  int pg = 0, pkc = 0;    // the next unit to issue
  int cg = 0, ckc = 0;    // the unit to compute
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (pg < b.ngroups) {
      if (pkc == 0) plan_rows(pg);
      issue(pkc, s);
      if (++pkc == b.nkc) { pkc = 0; ++pg; }
    }
    s8::cp_async_commit();
  }
  for (int u = 0; cg < b.ngroups; ++u) {
    s8::cp_async_wait<F32_STAGES - 2>();   // unit u landed
    __syncthreads();                       // ... for every thread; stage
    if (pg < b.ngroups) {                  // (u-1) % STAGES is free again
      if (pkc == 0) plan_rows(pg);
      issue(pkc, (u + F32_STAGES - 1) % F32_STAGES);
      if (++pkc == b.nkc) { pkc = 0; ++pg; }
    }
    s8::cp_async_commit();

    const unsigned char* st = b.ring + (u % F32_STAGES) * F32_STAGE_BYTES;
    f32_products<NG>(st, st + F32_ROWS, t, acc);

    if (ckc == b.nkc - 1) {   // the group is scored
      f32_scores<NG>(b.score_s, t, acc);
      // the top-p of every (sub-block, 4 slots) of the group, the warps
      // taking turns
      const int nc = (nq + 3) >> 2;
      int task = 0;
      for (int k = b.gfirst_s[cg]; k < b.gfirst_s[cg + 1]; ++k) {
        const int e = b.ext_s[k];
        if (e == 0) continue;
        const int sb = blockIdx.x + k * G;
        for (int c = 0; c < nc; ++c, ++task) {
          if ((task & (S8_WARPS - 1)) != warp) continue;
          const size_t out0 = ((size_t)b.l * b.qcap + q0 + 4 * c) * b.width;
          f32_topp4(b.score_s + 4 * c * SUB + b.off_s[k], e, b.bits_s + 4 * k,
                    lane, b.p, b.nsub, sb, (int)(b.list0 + (size_t)sb * SUB),
                    min(4, nq - 4 * c), b.out_vals + out0, b.out_idx + out0,
                    b.width);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < P::TN; ++j) acc[i][j] = 0.f;
    }
    if (++ckc == b.nkc) { ckc = 0; ++cg; }
  }
}

__global__ void __launch_bounds__(S8_THREADS, 2)
ivf_scan_f32(const unsigned char* __restrict__ qdisp,
             const unsigned char* __restrict__ lists,
             const int* __restrict__ row_ids, const int* __restrict__ live_n,
             float* __restrict__ out_vals, int* __restrict__ out_idx,
             int qcap, int cap_len, int row_bytes, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* score_s =
      reinterpret_cast<float*>(smem + F32_STAGES * F32_STAGE_BYTES);
  unsigned* bits_s = reinterpret_cast<unsigned*>(score_s + F32_QT * SUB);
  unsigned char* ext_s =
      reinterpret_cast<unsigned char*>(bits_s + BF_MAX_OWN * 4);
  unsigned char* off_s = ext_s + BF_MAX_OWN;      // row offset in its group
  unsigned char* gfirst_s = off_s + BF_MAX_OWN;   // groups' first, + end
  int* ngroups_s = reinterpret_cast<int*>(gfirst_s + BF_MAX_OWN + 4);

  const int l = blockIdx.y;
  const int nsub = cap_len / SUB;
  const int width = nsub * p;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = gridDim.x;
  const int nown = (nsub - (int)blockIdx.x + G - 1) / G;   // sub-blocks owned
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);

  // dead tail of the dispatch: (-inf, -1), nothing read
  if (nlive < qcap)
    for (int k = 0; k < nown; ++k)
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub,
                      blockIdx.x + k * G, p, nlive, qcap, t);
  if (nlive == 0 || nown <= 0) return;

  const size_t list0 = (size_t)l * cap_len;
  const unsigned char* q_g = qdisp + (size_t)l * qcap * row_bytes;
  const int nkc = (row_bytes + CHUNK - 1) / CHUNK;   // K chunks a row

  // the owned sub-blocks' live rows as bits, their row ids read once
  for (int k0 = 0; k0 < nown; k0 += 8) {
    int v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = k0 + j < nown
                 ? row_ids[list0 + (size_t)(blockIdx.x + (k0 + j) * G) * SUB +
                           t]
                 : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, v[j] >= 0);
      if (lane == 0 && k0 + j < nown) bits_s[(k0 + j) * 4 + warp] = b;
    }
  }
  __syncthreads();
  // live extents: one past each sub-block's last live row (the index
  // interleaves a list's rows, so its live rows are the first few)
  for (int k = t; k < nown; k += S8_THREADS) {
    const unsigned* b = bits_s + 4 * k;
    int e = 0;
    for (int w = 3; w >= 0 && e == 0; --w)
      if (b[w]) e = 32 * w + 32 - __clz(b[w]);
    ext_s[k] = e;
  }
  __syncthreads();
  // groups: the live sub-blocks in order, packed while their extents fit
  // one 128-row stage; a stage holds a group's rows at one K chunk
  if (t == 0) {
    int ng = 0, rows = SUB + 1;
    for (int k = 0; k < nown; ++k) {
      const int e = ext_s[k];
      if (e == 0) continue;
      if (rows + e > SUB) {
        gfirst_s[ng++] = k;
        rows = 0;
      }
      off_s[k] = rows;
      rows += e;
    }
    gfirst_s[ng] = nown;
    *ngroups_s = ng;
  }
  for (int k = 0; k < nown; ++k)
    if (ext_s[k] == 0)   // no live row: (-inf, -1) for every live slot
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub,
                      blockIdx.x + k * G, p, 0, nlive, t);
  __syncthreads();
  const int ngroups = *ngroups_s;
  if (ngroups == 0) return;

  const F32Block blk{lists, q_g, out_vals, out_idx, smem, score_s, bits_s,
                     ext_s, off_s, gfirst_s, list0, l, qcap, width, nsub, p,
                     row_bytes, nkc, ngroups};
  for (int q0 = 0; q0 < nlive; q0 += F32_QT) {
    const int nq = min(F32_QT, nlive - q0);
    switch ((nq + 7) >> 3) {   // live groups of 8 slots
      case 1: f32_pass<1>(blk, q0, nq); break;
      case 2: f32_pass<2>(blk, q0, nq); break;
      case 3: f32_pass<3>(blk, q0, nq); break;
      case 4: f32_pass<4>(blk, q0, nq); break;
      case 5: f32_pass<5>(blk, q0, nq); break;
      case 6: f32_pass<6>(blk, q0, nq); break;
      case 7: f32_pass<7>(blk, q0, nq); break;
      default: f32_pass<8>(blk, q0, nq); break;
    }
  }
}

cudaError_t launch_f32(const void* qdisp, const void* lists,
                       const int* row_ids, const int* live_n, float* vals,
                       int* idx, int nlist, int qcap, int cap_len,
                       int row_bytes, int p, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes();
  auto kernel = ivf_scan_f32;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // blocks a list as launch_bf16_as gives them
  const int nsub = cap_len / SUB;
  int groups = (264 + nlist - 1) / nlist;   // two blocks an SM
  groups = groups > nsub ? nsub : groups;
  const int least = (nsub + BF_MAX_OWN - 1) / BF_MAX_OWN;
  groups = groups < least ? least : groups;
  const dim3 grid(groups, nlist);
  kernel<<<grid, S8_THREADS, smem, stream>>>(
      static_cast<const unsigned char*>(qdisp),
      static_cast<const unsigned char*>(lists), row_ids, live_n, vals, idx,
      qcap, cap_len, row_bytes, p);
  return cudaGetLastError();
}

// The kernel a launch takes for these shapes (one place decides it):
// ROUTE_S8 ivf_scan_s8, 16 or 32 ivf_scan_bf16 with that many slots a pass,
// ROUTE_F32 ivf_scan_f32, ROUTE_SCALAR ivf_scan_kernel. The redesigned
// kernels need p <= 32 (a lane keeps each pass's winner) and, for int8
// and bf16, their query tiles to fit shared memory (ivf_scan_f32 streams
// its queries with the rows, so it takes any row width); the bf16 one
// takes 32 slots a pass past qcap 16 where those tiles fit.
constexpr int ROUTE_SCALAR = 0;
constexpr int ROUTE_S8 = 1;
constexpr int ROUTE_F32 = 4;

int route_of(int dtype, int qcap, int row_bytes, int p) {
  constexpr size_t MAX_SMEM = 227 * 1024;
  if (p > 32) return ROUTE_SCALAR;
  if (dtype == 0)
    return s8_smem_bytes(row_bytes) <= MAX_SMEM ? ROUTE_S8 : ROUTE_SCALAR;
  if (dtype == 1) return ROUTE_F32;
  if (qcap > 16 && bf_smem_bytes(32, 3, row_bytes) <= MAX_SMEM) return 32;
  return bf_smem_bytes(16, 4, row_bytes) <= MAX_SMEM ? 16 : ROUTE_SCALAR;
}

cudaError_t launch_bf16(int qt, const void* qdisp, const void* lists,
                        const int* row_ids, const int* live_n, float* vals,
                        int* idx, int nlist, int qcap, int cap_len,
                        int row_bytes, int p, cudaStream_t stream) {
  if (qt == 32)
    return launch_bf16_as<32, 3>(qdisp, lists, row_ids, live_n, vals, idx,
                                 nlist, qcap, cap_len, row_bytes, p, stream);
  return launch_bf16_as<16, 4>(qdisp, lists, row_ids, live_n, vals, idx,
                               nlist, qcap, cap_len, row_bytes, p, stream);
}

template <int KIND>
cudaError_t launch_kind(const void* qdisp, const void* lists, const int* row_ids,
                        const int* live_n, float* vals, int* idx, int nlist,
                        int qcap, int cap_len,
                        int row_bytes, int p, float scale, cudaStream_t stream) {
  const dim3 grid(cap_len / SUB, nlist);
  const auto* q = static_cast<const unsigned char*>(qdisp);
  const auto* r = static_cast<const unsigned char*>(lists);
  if (qcap <= 8) {
    ivf_scan_kernel<KIND, 8><<<grid, SUB, 0, stream>>>(
        q, r, row_ids, live_n, vals, idx, qcap, cap_len, row_bytes, p, scale);
  } else {
    ivf_scan_kernel<KIND, 16><<<grid, SUB, 0, stream>>>(
        q, r, row_ids, live_n, vals, idx, qcap, cap_len, row_bytes, p, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry (loaded with ctypes): the route ivf_list_scan_launch takes for
// these shapes, route_of's codes (0 ivf_scan_kernel, 1 ivf_scan_s8, 4
// ivf_scan_f32, 16 or 32 ivf_scan_bf16), or -1 where the launch would
// refuse them. Reads no device.
extern "C" int ivf_list_scan_route(int dtype, int qcap, int d, int p) {
  static const int elem[3] = {1, 4, 2};
  if (dtype < 0 || dtype > 2 || qcap <= 0 || p <= 0 || d <= 0) return -1;
  const long long row_bytes = (long long)d * elem[dtype];
  if (row_bytes % 16 != 0 || row_bytes > (1 << 30)) return -1;
  return route_of(dtype, qcap, (int)row_bytes, p);
}

// C entry point (loaded with ctypes). dtype: 0 int8, 1 float32, 2 bfloat16.
// Shapes: qdisp [nlist, qcap, d], lists [nlist, cap_len, d], row_ids
// [nlist, cap_len] int32, live_n [nlist] int32 or null (all slots live),
// vals/idx [nlist, qcap, (cap_len/128)*p]; all contiguous on one device.
// Returns a cudaError_t (0 on success).
extern "C" int ivf_list_scan_launch(int dtype, const void* qdisp,
                                    const void* lists, const int* row_ids,
                                    const int* live_n, float* vals, int* idx,
                                    int nlist, int qcap,
                                    int cap_len, int d, int p, float scale,
                                    void* stream) {
  if (cap_len % SUB != 0 || nlist <= 0 || nlist > 65535 ||
      cap_len / SUB > 65535)
    return (int)cudaErrorInvalidValue;
  const int route = ivf_list_scan_route(dtype, qcap, d, p);
  if (route < 0) return (int)cudaErrorInvalidValue;
  static const int elem[3] = {1, 4, 2};
  const int row_bytes = d * elem[dtype];
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == ROUTE_S8)
    err = launch_s8(qdisp, lists, row_ids, live_n, vals, idx, nlist, qcap,
                    cap_len, row_bytes, p, scale, s);
  else if (route == ROUTE_F32)
    err = launch_f32(qdisp, lists, row_ids, live_n, vals, idx, nlist, qcap,
                     cap_len, row_bytes, p, s);
  else if (route != ROUTE_SCALAR)
    err = launch_bf16(route, qdisp, lists, row_ids, live_n, vals, idx, nlist,
                      qcap, cap_len, row_bytes, p, s);
  else if (dtype == 0)
    err = launch_kind<0>(qdisp, lists, row_ids, live_n, vals, idx, nlist,
                         qcap, cap_len, row_bytes, p, scale, s);
  else if (dtype == 1)
    err = launch_kind<1>(qdisp, lists, row_ids, live_n, vals, idx, nlist,
                         qcap, cap_len, row_bytes, p, scale, s);
  else
    err = launch_kind<2>(qdisp, lists, row_ids, live_n, vals, idx, nlist,
                         qcap, cap_len, row_bytes, p, scale, s);
  return (int)err;
}
