// Flash attention backward for Hopper (sm_90a): dK, dV and dQ of the
// segment-masked attention of flash_attention.cu, from the forward's
// log-sum-exp, the scores recomputed on the SM and never stored.
//
// Replaces the two backward kernels of the JAX library's Pallas TPU flash
// attention that the MiniLM encoder's training step reaches
// (rag_foundation_tpu/models/encoder.py:170-201 `contrastive_loss`,
// `make_train_step` -> jax.value_and_grad -> `_attention` :100-132 -> the
// library call :116-120; in JAX 0.9.0
// jax/experimental/pallas/ops/tpu/flash_attention.py):
// - `_flash_attention_bwd_dkv` :941 (pallas_call :1121, body
//   `_flash_attention_dkv_kernel` :796) -> flash_bwd_dkv_* below;
// - `_flash_attention_bwd_dq` :1287 (pallas_call :1456, body
//   `_flash_attention_dq_kernel` :1146) -> flash_bwd_dq_* below.
// The same function, with no causal mask and no bias:
//
//   p[i,j]  = exp(q_i . k_j * sm_scale - lse_i)  if seg_kv[j] == seg_q[i],
//             else 0
//   ds[i,j] = p[i,j] * (dO_i . v_j - di_i) * sm_scale
//   dV_j = sum_i p[i,j] dO_i     dK_j = sum_i ds[i,j] q_i
//   dQ_i = sum_j ds[i,j] k_j
//
// over each (b, h); q, k, v, dO, dQ, dK, dV [B, H, S, D] contiguous (bf16,
// or f32), seg_q, seg_kv [B, S] int32 (any ids, in any order), lse and
// di = sum(o * dO, -1) [B, H, S] f32 (the library computes di outside its
// kernels too, :273). The library keeps the max `m` and sum `l` of a row
// apart; lse = m + log(l) carries the same information. The library's dQ
// kernel can also write dS, the gradient of an attention bias `ab`; the
// encoder passes no bias, so that output is out of this contract and not
// written.
//
// Bound on an H100 SXM at the trainer's shapes, reckoned from the data
// sheet (B=256, H=12, D=32, bf16): dK/dV needs 8*B*H*S^2*D operations
// (the two score products recomputed, P^T.dO and dS^T.Q) and dQ 6*B*H*S^2*D
// (scores, dP, dS.K); at S=128 that is 12.9 and 9.7 GFLOP = 0.013 and
// 0.010 ms at 989 TFLOP/s, below the bytes (q, k, v, dO read, two or one
// outputs written, lse and di read: 154 and 129 MB = 0.046 and 0.039 ms at
// 3.35 TB/s). At S=512 the operations (0.208 and 0.156 ms for all S^2
// pairs, less where the segments cut them) just exceed the bytes (0.184
// and 0.154 ms). Each kernel also takes one exponential a same-segment
// pair; at D=32 the special-function unit (16 a clock an SM: 805M of them
// at S=512 take 0.193 ms) is as tight a floor as the tensor cores.
//
// bf16 design (bf16 mma.sync m16n8k16 with f32 accumulation):
// - dK/dV: one block a (b, h, tile of keys); a warp owns MW keys, their K
//   and V fragments (A operands of S^T = K.Q^T and dP^T = V.dO^T) and their
//   dK, dV accumulators in registers. The query tiles (CT rows of Q and dO,
//   CT values of lse, di and seg_q) go by in a ring of RING shared-memory
//   stages filled by 16- and 4-byte cp.async, rows past S zero-filled: the
//   next tile is in flight while this one is computed, one __syncthreads
//   a tile, and the first one while the keys load. The TPU kernel keeps
//   its kv block in VMEM scratch over a sequential grid of q blocks; the
//   loop inside the block replaces it.
// - dQ: the roles swapped: a warp owns MW queries (Q and dO fragments, lse
//   and di in registers); the key tiles (K, V, seg_kv) go by in the ring.
// - Every B fragment comes from the row-major tiles by ldmatrix .x4: the
//   score products' as stored, those of dV += P^T.dO, dK += dS^T.Q and
//   dQ += dS.K by .trans, so no transposed copy is made. P^T and dS^T (dS)
//   leave the score accumulators, rounded to bf16, as the A operand of the
//   next product, as the library rounds them to the input dtype.
// - The weights: p = 2^(s * scale log2 e - lse log2 e) on the
//   special-function unit (ex2.approx.ftz), selected, never multiplied,
//   to 0 where the segments differ; ds leaves out sm_scale, which dK and
//   dQ take once at the end. dK/dV tests no pair of a tile whose rows and
//   the warp's keys all hold one segment.
// - Tiles: S <= 32 two warps of 16 rows and one 32-row column tile, so at
//   S = 32 no product falls on zero-fill; past that four warps (see the
//   launch table). A 16 x 16 block with no same-segment pair is computed
//   all the same: a branch around it cost more than it saved.
// - No NaN from masks: in dK/dV a query past S is zero-filled (Q, dO, lse,
//   di), so its terms are exactly 0, and a key past S takes key S-1's
//   segment and is not written. In dQ a key past S is masked out in the
//   last tile, because a row with no key of its segment has lse = -inf; a
//   query past S gets lse = +inf, so its p is 2^-inf = 0.
// q, k, v and dO must be 16-byte aligned (cp.async); the entry points
// return cudaErrorMisalignedAddress otherwise.
// f32 inputs take a plain FMA path in the same source (no tensor cores):
// dK/dV one thread a key, its K and V rows in shared memory, query tiles
// of 16 broadcast from shared memory; dQ one thread a query, key tiles of
// 64 in shared memory.
//
// Left for later: wgmma (a version that waited for each product, one
// warpgroup a 64-key tile, was slower than mma.sync here), and one kernel
// for both passes (dQ by atomics would save dQ's exponentials but make its
// sums' order change from run to run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using flash::ex2;
using flash::Flag;
using flash::LOG2E;
using flash::mma_16816;
using flash::pack_a;
using flash::pack_bf16;
using flash::RING;
using flash::row_ids;
using flash::Stage;
using flash::stage_tile;

constexpr int TILE = 64;         // f32 kernels: rows a block owns and stages
constexpr int F32_QTILE = 16;    // f32 dK/dV: queries of a staged tile

// Whether the warp's rows (ids lo..hi among those before S) and a staged
// tile's rows before `live` all hold one segment: then every pair of them
// shares it, and the tile needs no per-pair test of the ids.
template <int CT>
__device__ __forceinline__ bool one_segment(const int* seg, int live, int lo,
                                            int hi, int lane) {
  int tlo, thi;
  flash::tile_ids<CT>(seg, live, lane, tlo, thi);
  return lo == hi && tlo == thi && lo == tlo;
}

// dK/dV's weights of one m-tile x 16-query block, in place: s (S^T) becomes
// P^T, p = 2^(s * scale_log2 - lse2) where the key's segment sk[h] (rows g,
// g + 8) is the query's sq (every pair without SEGS), else 0; dp (dP^T)
// becomes dS^T / sm_scale = p (dp - di). Columns 8n + 2t + e.
template <bool SEGS>
__device__ __forceinline__ void dkv_weights(float (&s)[2][4],
                                            float (&dp)[2][4],
                                            const float2 (&l2)[2],
                                            const float2 (&dI)[2],
                                            const int2 (&sq)[2],
                                            const int (&sk)[2],
                                            float scale_log2) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lse2 = e ? l2[n].y : l2[n].x;
        const float x = fmaf(s[n][2 * h + e], scale_log2, -lse2);
        const bool same = !SEGS || (e ? sq[n].y : sq[n].x) == sk[h];
        const float p = same ? ex2(x) : 0.f;
        s[n][2 * h + e] = p;
        dp[n][2 * h + e] = p * (dp[n][2 * h + e] - (e ? dI[n].y : dI[n].x));
      }
}

// dQ's weights of one m-tile x 16-key block, in place: dp (dP) becomes
// dS / sm_scale = p (dp - di), p = 2^(s * scale_log2 - lse2[h]) where the
// key column 8n + 2t + e is before S (every column without LIVE) and of
// the query's segment sq[h], else 0.
template <bool LIVE>
__device__ __forceinline__ void dq_weights(const float (&s)[2][4],
                                           float (&dp)[2][4],
                                           const float (&l2)[2],
                                           const float (&dI)[2],
                                           const int2 (&sk)[2], int kl0,
                                           int live, const int (&sq)[2],
                                           float scale_log2) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = fmaf(s[n][2 * h + e], scale_log2, -l2[h]);
        const bool in = (!LIVE || kl0 + n * 8 + e < live)
            && (e ? sk[n].y : sk[n].x) == sq[h];
        const float p = in ? ex2(x) : 0.f;
        dp[n][2 * h + e] = p * (dp[n][2 * h + e] - dI[h]);
      }
}

// dK, dV of one (b, h, tile of WARPS * MW keys): a warp owns MW keys
template <int D, int MW, int WARPS, int CT>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ seg_q,
                   const int* __restrict__ seg_kv,
                   const float* __restrict__ lse,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int S, int tiles,
                   float scale, float scale_log2) {
  static_assert(D % 16 == 0 && MW % 16 == 0, "tile shape");
  constexpr int LD = D + 8;
  constexpr int THREADS = WARPS * 32;
  constexpr int MT = MW / 16;       // 16-key m-tiles a warp
  constexpr int KSTEPS = D / 16;    // depth steps of the score products
  constexpr int NT_O = D / 8;       // 8-wide column tiles of dK, dV
  constexpr int GROUPS = CT / 16;   // 16-query groups of a column tile
  __shared__ Stage<D, CT> ring[RING];

  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;   // ldmatrix: tile, row
  // this lane's ldmatrix row addresses, in bytes from a tile's first row:
  // as stored (score products) and transposed (products over the rows)
  const uint32_t ld_row = 2 * (((lj >> 1) * 8 + lr) * LD + (lj & 1) * 8);
  const uint32_t ld_trow = 2 * (((lj & 1) * 8 + lr) * LD + (lj >> 1) * 8);
  const size_t head = (size_t)bh * S * D;
  const int* segq = seg_q + (size_t)b * S;
  const int* segk = seg_kv + (size_t)b * S;

  // the first query tiles are in flight while the keys load
  const float* lse_h = lse + (size_t)bh * S;
  const float* di_h = di + (size_t)bh * S;
  const int n_tiles = (S + CT - 1) / CT;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_tiles)
      stage_tile<D, CT, THREADS>(ring[s], q + head, dout + head, segq,
                                 lse_h, di_h, s * CT, S);
    s8::cp_async_commit();
  }

  // this warp's keys key0 + 16 mt + g (+ 8); a key past S computes on with
  // key S-1's segment and is not written
  const int key0 = (int)tile * (WARPS * MW) + warp * MW;
  uint32_t ka[MT][KSTEPS][4], va[MT][KSTEPS][4];
  int sk[MT][2];
  float dka[MT][NT_O][4], dva[MT][NT_O][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = key0 + mt * 16 + g;
    flash::load_a_rows<D>(ka[mt], k + head, r0, S, t);
    flash::load_a_rows<D>(va[mt], v + head, r0, S, t);
    sk[mt][0] = segk[min(r0, S - 1)];
    sk[mt][1] = segk[min(r0 + 8, S - 1)];
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][n][e] = dva[mt][n][e] = 0.f;
  }
  int klo, khi;
  row_ids(segk, key0, MW, S, lane, klo, khi);

  for (int it = 0; it < n_tiles; ++it) {
    s8::cp_async_wait<RING - 2>();
    __syncthreads();   // tile `it` is in; every warp is done with it - 1
    const int next = it + RING - 1;
    if (next < n_tiles)
      stage_tile<D, CT, THREADS>(ring[next % RING], q + head, dout + head,
                                 segq, lse_h, di_h, next * CT, S);
    s8::cp_async_commit();
    const Stage<D, CT>& st = ring[it % RING];
    const uint32_t qs = flash::smem_u32(st.a), dos = flash::smem_u32(st.b);

    // the tile's 16-query groups, without or with a test of the ids
    auto groups = [&](auto segs) {
      constexpr bool SEGS = decltype(segs)::value;
#pragma unroll
      for (int gq = 0; gq < GROUPS; ++gq) {
        const uint32_t grp = 2 * gq * 16 * LD;   // the group's first row
        // B operands of S^T = K.Q^T and dP^T = V.dO^T: the 16 queries' Q
        // and dO rows as stored (two 8-query column tiles a depth step)
        uint32_t qb[KSTEPS][4], ob[KSTEPS][4];
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          flash::ldmatrix_x4(qb[kk], qs + grp + ld_row + 32 * kk);
          flash::ldmatrix_x4(ob[kk], dos + grp + ld_row + 32 * kk);
        }
        // this thread's columns gq * 16 + 8n + 2t (+ 1)
        float2 l2[2], dI[2];
        int2 sq[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = gq * 16 + n * 8 + 2 * t;
          l2[n] = *reinterpret_cast<const float2*>(st.lse + j);
          l2[n].x *= LOG2E;
          l2[n].y *= LOG2E;
          dI[n] = *reinterpret_cast<const float2*>(st.di + j);
          sq[n] = *reinterpret_cast<const int2*>(st.seg + j);
        }
        uint32_t obt[NT_O / 2][4], qbt[NT_O / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < NT_O / 2; ++n2) {
          flash::ldmatrix_x4_trans(obt[n2], dos + grp + ld_trow + 32 * n2);
          flash::ldmatrix_x4_trans(qbt[n2], qs + grp + ld_trow + 32 * n2);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float s[2][4], dp[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
              mma_16816(s[n], ka[mt][kk], qb[kk][2 * n], qb[kk][2 * n + 1]);
              mma_16816(dp[n], va[mt][kk], ob[kk][2 * n], ob[kk][2 * n + 1]);
            }
          }
          dkv_weights<SEGS>(s, dp, l2, dI, sq, sk[mt], scale_log2);
          // dV += P^T.dO and dK += dS^T.Q over the 16 queries: B operands
          // by ldmatrix .trans of the same rows (two 8-wide d tiles an x4)
          uint32_t pa[4], sa[4];
          pack_a(pa, s[0], s[1]);
          pack_a(sa, dp[0], dp[1]);
#pragma unroll
          for (int n2 = 0; n2 < NT_O / 2; ++n2) {
            mma_16816(dva[mt][2 * n2], pa, obt[n2][0], obt[n2][1]);
            mma_16816(dva[mt][2 * n2 + 1], pa, obt[n2][2], obt[n2][3]);
            mma_16816(dka[mt][2 * n2], sa, qbt[n2][0], qbt[n2][1]);
            mma_16816(dka[mt][2 * n2 + 1], sa, qbt[n2][2], qbt[n2][3]);
          }
        }
      }
    };
    if (one_segment<CT>(st.seg, S - it * CT, klo, khi, lane))
      groups(Flag<false>{});
    else
      groups(Flag<true>{});
  }

  // dS^T left out sm_scale: dK takes it once here
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = key0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < S) {
        *reinterpret_cast<uint32_t*>(dk + head + (size_t)r0 * D + c) =
            pack_bf16(dka[mt][n][0] * scale, dka[mt][n][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + head + (size_t)r0 * D + c) =
            pack_bf16(dva[mt][n][0], dva[mt][n][1]);
      }
      if (r1 < S) {
        *reinterpret_cast<uint32_t*>(dk + head + (size_t)r1 * D + c) =
            pack_bf16(dka[mt][n][2] * scale, dka[mt][n][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + head + (size_t)r1 * D + c) =
            pack_bf16(dva[mt][n][2], dva[mt][n][3]);
      }
    }
  }
}

// dQ of one (b, h, tile of WARPS * MW queries): a warp owns MW queries
template <int D, int MW, int WARPS, int CT>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv,
                  const float* __restrict__ lse,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ di,
                  __nv_bfloat16* __restrict__ dq, int H, int S, int tiles,
                  float scale, float scale_log2) {
  static_assert(D % 16 == 0 && MW % 16 == 0, "tile shape");
  constexpr int LD = D + 8;
  constexpr int THREADS = WARPS * 32;
  constexpr int MT = MW / 16;       // 16-query m-tiles a warp
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;
  constexpr int GROUPS = CT / 16;   // 16-key groups of a column tile
  __shared__ Stage<D, CT> ring[RING];

  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;
  const uint32_t ld_row = 2 * (((lj >> 1) * 8 + lr) * LD + (lj & 1) * 8);
  const uint32_t ld_trow = 2 * (((lj & 1) * 8 + lr) * LD + (lj >> 1) * 8);
  const size_t head = (size_t)bh * S * D;
  const int* segq = seg_q + (size_t)b * S;
  const int* segk = seg_kv + (size_t)b * S;

  // the first key tiles are in flight while the queries load
  const int n_tiles = (S + CT - 1) / CT;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_tiles)
      stage_tile<D, CT, THREADS>(ring[s], k + head, v + head, segk, nullptr,
                                 nullptr, s * CT, S);
    s8::cp_async_commit();
  }

  const int qrow0 = (int)tile * (WARPS * MW) + warp * MW;
  uint32_t qa[MT][KSTEPS][4], da[MT][KSTEPS][4];
  int sq[MT][2];
  float l2[MT][2], dI[MT][2], dqa[MT][NT_O][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = qrow0 + mt * 16 + g;
    flash::load_a_rows<D>(qa[mt], q + head, r0, S, t);
    flash::load_a_rows<D>(da[mt], dout + head, r0, S, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      sq[mt][h] = segq[min(r, S - 1)];
      l2[mt][h] = r < S ? lse[(size_t)bh * S + r] * LOG2E : INFINITY;
      dI[mt][h] = r < S ? di[(size_t)bh * S + r] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[mt][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    s8::cp_async_wait<RING - 2>();
    __syncthreads();
    const int next = it + RING - 1;
    if (next < n_tiles)
      stage_tile<D, CT, THREADS>(ring[next % RING], k + head, v + head, segk,
                                 nullptr, nullptr, next * CT, S);
    s8::cp_async_commit();
    const Stage<D, CT>& st = ring[it % RING];
    const uint32_t ks = flash::smem_u32(st.a), vs = flash::smem_u32(st.b);
    const int live = S - it * CT;   // keys of this tile before S

    // the tile's 16-key groups, with a test of the keys past S in the last
    // tile (a key there must never weigh in: a row whose segment has no key
    // has lse = -inf)
    auto groups = [&](auto ragged) {
      constexpr bool LIVE = decltype(ragged)::value;
#pragma unroll
      for (int gk = 0; gk < GROUPS; ++gk) {
        const uint32_t grp = 2 * gk * 16 * LD;
        // B operands of S = Q.K^T and dP = dO.V^T: K and V rows as stored
        uint32_t kb[KSTEPS][4], vb[KSTEPS][4];
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          flash::ldmatrix_x4(kb[kk], ks + grp + ld_row + 32 * kk);
          flash::ldmatrix_x4(vb[kk], vs + grp + ld_row + 32 * kk);
        }
        const int kl0 = gk * 16 + 2 * t;   // this thread's first column
        int2 skc[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          skc[n] = *reinterpret_cast<const int2*>(st.seg + kl0 + n * 8);
        // dQ += dS.K over the 16 keys: K's B operand by ldmatrix .trans
        uint32_t kbt[NT_O / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < NT_O / 2; ++n2)
          flash::ldmatrix_x4_trans(kbt[n2], ks + grp + ld_trow + 32 * n2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float s[2][4], dp[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
              mma_16816(s[n], qa[mt][kk], kb[kk][2 * n], kb[kk][2 * n + 1]);
              mma_16816(dp[n], da[mt][kk], vb[kk][2 * n], vb[kk][2 * n + 1]);
            }
          }
          dq_weights<LIVE>(s, dp, l2[mt], dI[mt], skc, kl0, live, sq[mt],
                           scale_log2);
          uint32_t sa[4];
          pack_a(sa, dp[0], dp[1]);
#pragma unroll
          for (int n2 = 0; n2 < NT_O / 2; ++n2) {
            mma_16816(dqa[mt][2 * n2], sa, kbt[n2][0], kbt[n2][1]);
            mma_16816(dqa[mt][2 * n2 + 1], sa, kbt[n2][2], kbt[n2][3]);
          }
        }
      }
    };
    if (live >= CT)
      groups(Flag<false>{});
    else
      groups(Flag<true>{});
  }

  // dS left out sm_scale: dQ takes it once here
  __nv_bfloat16* dqh = dq + head;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = qrow0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(dqh + (size_t)r0 * D + c) =
            pack_bf16(dqa[mt][n][0] * scale, dqa[mt][n][1] * scale);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(dqh + (size_t)r1 * D + c) =
            pack_bf16(dqa[mt][n][2] * scale, dqa[mt][n][3] * scale);
    }
  }
}

// f32 dK, dV: one thread a key of a 64-key tile, plain FMA
template <int D>
__global__ void __launch_bounds__(TILE)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv,
                  const float* __restrict__ lse,
                  const float* __restrict__ dout,
                  const float* __restrict__ di, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int S, int tiles,
                  float scale, float scale_log2) {
  // a thread's own K and V rows, stride D + 1: conflict-free column reads
  __shared__ float kr[TILE][D + 1];
  __shared__ float vr[TILE][D + 1];
  __shared__ float qs[F32_QTILE][D];
  __shared__ float dos[F32_QTILE][D];
  __shared__ float lse2[F32_QTILE], dis[F32_QTILE];
  __shared__ int segq[F32_QTILE];
  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const size_t head = (size_t)bh * S * D;
  const int key0 = (int)tile * TILE;
  for (int c = threadIdx.x; c < TILE * D; c += TILE) {
    const int row = c / D, col = c % D, key = key0 + row;
    kr[row][col] = key < S ? k[head + (size_t)key * D + col] : 0.f;
    vr[row][col] = key < S ? v[head + (size_t)key * D + col] : 0.f;
  }
  const int j = key0 + threadIdx.x;
  const int sk = seg_kv[(size_t)b * S + min(j, S - 1)];
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < S; q0 += F32_QTILE) {
    __syncthreads();
    for (int c = threadIdx.x; c < F32_QTILE * D; c += TILE) {
      const int row = c / D, col = c % D, i = q0 + row;
      qs[row][col] = i < S ? q[head + (size_t)i * D + col] : 0.f;
      dos[row][col] = i < S ? dout[head + (size_t)i * D + col] : 0.f;
    }
    for (int r = threadIdx.x; r < F32_QTILE; r += TILE) {
      const int i = q0 + r;
      lse2[r] = i < S ? lse[(size_t)bh * S + i] * LOG2E : INFINITY;
      dis[r] = i < S ? di[(size_t)bh * S + i] : 0.f;
      segq[r] = i < S ? seg_q[(size_t)b * S + i] : 0;
    }
    __syncthreads();
    const int live = min(F32_QTILE, S - q0);
    for (int r = 0; r < live; ++r) {
      if (segq[r] != sk) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[r][d], kr[threadIdx.x][d], s);
        dp = fmaf(dos[r][d], vr[threadIdx.x][d], dp);
      }
      const float p = exp2f(s * scale_log2 - lse2[r]);
      const float ds = p * (dp - dis[r]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(p, dos[r][d], dva[d]);
        dka[d] = fmaf(ds, qs[r][d], dka[d]);
      }
    }
  }
  if (j >= S) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[head + (size_t)j * D + d] = dka[d];
    dv[head + (size_t)j * D + d] = dva[d];
  }
}

// f32 dQ: one thread a query of a 64-query tile, plain FMA
template <int D>
__global__ void __launch_bounds__(TILE)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv,
                 const float* __restrict__ lse,
                 const float* __restrict__ dout,
                 const float* __restrict__ di, float* __restrict__ dq, int H,
                 int S, int tiles, float scale, float scale_log2) {
  __shared__ float ks[TILE][D];
  __shared__ float vs[TILE][D];
  __shared__ int segk[TILE];
  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const size_t head = (size_t)bh * S * D;
  const int i = (int)tile * TILE + threadIdx.x;
  const bool row_live = i < S;
  const int sq = seg_q[(size_t)b * S + min(i, S - 1)];
  const float l2 = row_live ? lse[(size_t)bh * S + i] * LOG2E : INFINITY;
  const float dI = row_live ? di[(size_t)bh * S + i] : 0.f;
  float qr[D], dor[D], dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_live ? q[head + (size_t)i * D + d] : 0.f;
    dor[d] = row_live ? dout[head + (size_t)i * D + d] : 0.f;
    dqa[d] = 0.f;
  }
  for (int kv0 = 0; kv0 < S; kv0 += TILE) {
    __syncthreads();
    for (int c = threadIdx.x; c < TILE * D; c += TILE) {
      const int row = c / D, col = c % D, key = kv0 + row;
      ks[row][col] = key < S ? k[head + (size_t)key * D + col] : 0.f;
      vs[row][col] = key < S ? v[head + (size_t)key * D + col] : 0.f;
    }
    for (int j = threadIdx.x; j < TILE; j += TILE)
      segk[j] = kv0 + j < S ? seg_kv[(size_t)b * S + kv0 + j] : 0;
    __syncthreads();
    const int live = min(TILE, S - kv0);
    for (int j = 0; j < live; ++j) {
      if (segk[j] != sq) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      const float ds = exp2f(s * scale_log2 - l2) * (dp - dI) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, ks[j][d], dqa[d]);
    }
  }
  if (!row_live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) dq[head + (size_t)i * D + d] = dqa[d];
}

struct Args {
  int dtype;
  const void *q, *k, *v;
  const int *seg_q, *seg_kv;
  const float *lse, *di;
  const void* dout;
  void *dk, *dv, *dq;
  int B, H, S;
  float scale, scale_log2;
  cudaStream_t stream;
};

// blocks of `rows`-row tiles over every (b, h), and the tiles a head; 0
// blocks when there are too many
unsigned grid(const Args& a, int rows, int& tiles) {
  tiles = (a.S + rows - 1) / rows;
  const long long blocks = (long long)a.B * a.H * tiles;
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

template <int D, int MW, int WARPS, int CT>
cudaError_t launch_dkv_bf16(const Args& a) {
  int tiles;
  const unsigned blocks = grid(a, WARPS * MW, tiles);
  if (blocks == 0) return cudaErrorInvalidValue;
  flash_bwd_dkv_bf16<D, MW, WARPS, CT><<<blocks, WARPS * 32, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.seg_q, a.seg_kv, a.lse,
      static_cast<const __nv_bfloat16*>(a.dout), a.di,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.H, a.S, tiles, a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int D, int MW, int WARPS, int CT>
cudaError_t launch_dq_bf16(const Args& a) {
  int tiles;
  const unsigned blocks = grid(a, WARPS * MW, tiles);
  if (blocks == 0) return cudaErrorInvalidValue;
  flash_bwd_dq_bf16<D, MW, WARPS, CT><<<blocks, WARPS * 32, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.seg_q, a.seg_kv, a.lse,
      static_cast<const __nv_bfloat16*>(a.dout), a.di,
      static_cast<__nv_bfloat16*>(a.dq), a.H, a.S, tiles, a.scale,
      a.scale_log2);
  return cudaGetLastError();
}

// The bf16 kernels' tiles past S = 32. dK/dV: one 16-row m-tile a warp and
// 64-query column tiles below S = 256, where more resident blocks hide the
// latencies better; from S = 256 on two m-tiles a warp, which share each
// fragment loaded, and 128-query column tiles (D <= 32: registers and
// shared memory). dQ: two m-tiles a warp and 128-key column tiles past
// S = 32 (D <= 32).
constexpr int LONG_S = 256;
template <int D>
constexpr int long_rows() { return D <= 32 ? 32 : 16; }
template <int D>
constexpr int long_cols() { return D <= 32 ? 128 : 64; }

template <int D>
cudaError_t launch_dkv(const Args& a) {
  if (a.dtype == 2)
    return a.S <= 32 ? launch_dkv_bf16<D, 16, 2, 32>(a)
        : a.S < LONG_S ? launch_dkv_bf16<D, 16, 4, 64>(a)
                       : launch_dkv_bf16<D, long_rows<D>(), 4, long_cols<D>()>(a);
  int tiles;
  const unsigned blocks = grid(a, TILE, tiles);
  if (blocks == 0) return cudaErrorInvalidValue;
  flash_bwd_dkv_f32<D><<<blocks, TILE, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.seg_q, a.seg_kv, a.lse,
      static_cast<const float*>(a.dout), a.di, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.S, tiles, a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  if (a.dtype == 2)
    return a.S <= 32 ? launch_dq_bf16<D, 16, 2, 32>(a)
                     : launch_dq_bf16<D, long_rows<D>(), 4, long_cols<D>()>(a);
  int tiles;
  const unsigned blocks = grid(a, TILE, tiles);
  if (blocks == 0) return cudaErrorInvalidValue;
  flash_bwd_dq_f32<D><<<blocks, TILE, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.seg_q, a.seg_kv, a.lse,
      static_cast<const float*>(a.dout), a.di, static_cast<float*>(a.dq),
      a.H, a.S, tiles, a.scale, a.scale_log2);
  return cudaGetLastError();
}

// fills the shared fields; cudaErrorInvalidValue on a bad argument,
// cudaErrorMisalignedAddress for bf16 inputs the ring cannot copy
cudaError_t prepare(Args& a, int dtype, const void* q, const void* k,
                    const void* v, const void* dout, int B, int H, int S,
                    float sm_scale, void* stream) {
  if ((dtype != 1 && dtype != 2) || B <= 0 || H <= 0 || S <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 2 && ((reinterpret_cast<uintptr_t>(q)
                      | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)
                      | reinterpret_cast<uintptr_t>(dout)) & 15u) != 0)
    return cudaErrorMisalignedAddress;
  a.dtype = dtype;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.B = B;
  a.H = H;
  a.S = S;
  a.scale = sm_scale;
  a.scale_log2 = sm_scale * LOG2E;
  a.stream = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace

// C entry points (loaded with ctypes). dtype: 1 float32, 2 bfloat16.
// q, k, v, dout and the outputs [B, H, S, D] contiguous on one device, D in
// {16, 32, 64}; seg_q, seg_kv [B, S] int32; lse, di [B, H, S] f32. Return a
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const int* seg_q,
    const int* seg_kv, const float* lse, const void* dout, const float* di,
    void* dk, void* dv, int B, int H, int S, int D, float sm_scale,
    void* stream) {
  Args a{};
  const cudaError_t err = prepare(a, dtype, q, k, v, dout, B, H, S, sm_scale,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  a.seg_q = seg_q; a.seg_kv = seg_kv; a.lse = lse; a.di = di;
  a.dk = dk; a.dv = dv;
  switch (D) {
    case 16: return (int)launch_dkv<16>(a);
    case 32: return (int)launch_dkv<32>(a);
    case 64: return (int)launch_dkv<64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const int* seg_q,
    const int* seg_kv, const float* lse, const void* dout, const float* di,
    void* dq, int B, int H, int S, int D, float sm_scale, void* stream) {
  Args a{};
  const cudaError_t err = prepare(a, dtype, q, k, v, dout, B, H, S, sm_scale,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  a.seg_q = seg_q; a.seg_kv = seg_kv; a.lse = lse; a.di = di; a.dq = dq;
  switch (D) {
    case 16: return (int)launch_dq<16>(a);
    case 32: return (int)launch_dq<32>(a);
    case 64: return (int)launch_dq<64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
