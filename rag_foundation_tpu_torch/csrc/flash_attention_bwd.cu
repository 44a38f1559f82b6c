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
// or f32), seg_q, seg_kv [B, S] int32, lse and di = sum(o * dO, -1)
// [B, H, S] f32 (the library computes di outside its kernels too, :273).
// The library keeps the max `m` and sum `l` of a row apart; lse = m +
// log(l) carries the same information. The library's dQ kernel can also
// write dS, the gradient of an attention bias `ab`; the encoder passes no
// bias, so that output is out of this contract and not written.
//
// Bound on an H100 SXM at the trainer's shapes, reckoned from the data
// sheet (B=256, H=12, D=32, bf16): dK/dV needs 8*B*H*S^2*D operations
// (the two score products recomputed, P^T.dO and dS^T.Q) and dQ 6*B*H*S^2*D
// (scores, dP, dS.K); at S=128 that is 12.9 and 9.7 GFLOP = 0.013 and
// 0.010 ms at 989 TFLOP/s, below the bytes (q, k, v, dO read, two or one
// outputs written, lse and di read: 154 and 129 MB = 0.046 and 0.039 ms at
// 3.35 TB/s). At S=512 the operations (0.208 and 0.156 ms for all S^2
// pairs, less where the segments cut them) just exceed the bytes (0.184
// and 0.154 ms).
//
// bf16 design (a simple one that is right; four warps a block, each warp
// owning 16 rows, bf16 mma.sync m16n8k16 with f32 accumulation, as the
// forward does):
// - dK/dV: one block a (b, h, tile of 64 keys). The TPU kernel keeps its
//   kv block in VMEM scratch over a sequential grid of q blocks; here the
//   loop over query tiles runs inside the block, the kv tile's K and V
//   fragments and its dK, dV accumulators in registers. Each query tile's
//   Q and dO are staged in shared memory twice: row-major (the B operand
//   of S^T = K.Q^T and dP^T = V.dO^T) and transposed, d-major (the B
//   operand of dV += P^T.dO and dK += dS^T.Q), so that every fragment is
//   one 32-bit load. P^T and dS^T leave the score accumulators as the A
//   operand of the next product, rounded to bf16, as the library rounds
//   them to the input dtype before its dots.
// - dQ: one block a (b, h, tile of 64 queries): Q and dO fragments in
//   registers, the keys going by in tiles of 64 (K and V row-major for the
//   score products, K transposed for dQ += dS.K), dQ accumulated in
//   registers and written once.
// - Masks without NaN: p is 0 where the segments differ (never an exp of
//   -inf minus -inf); keys and queries past S are zero-filled, and a query
//   past S gets lse = +inf, so its p is exp2(-inf) = 0.
// f32 inputs take a plain FMA path in the same source (no tensor cores):
// dK/dV one thread a key, its K and V rows in shared memory, query tiles
// of 16 broadcast from shared memory; dQ one thread a query, key tiles of
// 64 in shared memory.
//
// Left for later: wgmma, a TMA or cp.async ring (one tile is staged, then
// used), skipping tiles that hold no pair of one segment (every tile is
// computed, masked ones included), one kernel for both passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using flash::ld32;
using flash::LOG2E;
using flash::mma_16816;
using flash::pack_a;
using flash::pack_bf16;

constexpr int TILE = 64;        // rows a block owns, rows of a staged tile
constexpr int WARPS = TILE / 16;
constexpr int THREADS = WARPS * 32;
constexpr int F32_QTILE = 16;   // f32 dK/dV: queries of a staged tile

// dK, dV of one (b, h, tile of 64 keys): a warp owns 16 keys
template <int D>
__global__ void __launch_bounds__(THREADS)
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
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;         // row-major tiles: conflict-free B loads
  constexpr int TLD = TILE + 8;     // transposed tiles
  constexpr int KSTEPS = D / 16;    // depth steps of the score products
  constexpr int NT_S = TILE / 8;    // 8-query column tiles of S^T
  constexpr int PSTEPS = TILE / 16; // depth steps over the queries
  constexpr int NT_O = D / 8;       // 8-wide column tiles of dK, dV
  __shared__ __align__(16) __nv_bfloat16 qs[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 qt[D * TLD];
  __shared__ __align__(16) __nv_bfloat16 dts[D * TLD];
  __shared__ float lse2[TILE];      // lse in base 2; +inf past S
  __shared__ float dis[TILE];
  __shared__ int segq[TILE];

  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)bh * S * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* doh = dout + head;

  // this thread's two keys; keys past S compute on and are not written
  const int r0 = (int)tile * TILE + warp * 16 + g, r1 = r0 + 8;
  const int sk0 = seg_kv[(size_t)b * S + min(r0, S - 1)];
  const int sk1 = seg_kv[(size_t)b * S + min(r1, S - 1)];
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  flash::load_a_rows<D>(ka, k + head, r0, S, t);
  flash::load_a_rows<D>(va, v + head, r0, S, t);

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += TILE) {
    __syncthreads();   // every warp is done with the previous tile
    flash::stage_rows<TILE, D, LD, TLD, THREADS>(qh, q0, S, qs, qt);
    flash::stage_rows<TILE, D, LD, TLD, THREADS>(doh, q0, S, dos, dts);
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int i = q0 + j;
      const bool live = i < S;
      lse2[j] = live ? lse[(size_t)bh * S + i] * LOG2E : INFINITY;
      dis[j] = live ? di[(size_t)bh * S + i] : 0.f;
      segq[j] = live ? seg_q[(size_t)b * S + i] : 0;
    }
    __syncthreads();

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 64 queries each
    float st[NT_S][4], dpt[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(st[n], ka[kk], ld32(qs + off), ld32(qs + off + 8));
        mma_16816(dpt[n], va[kk], ld32(dos + off), ld32(dos + off + 8));
      }
    }
    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t + e;
        const float l2 = lse2[j], dI = dis[j];
        const int sq = segq[j];
        const float p0 = sq == sk0 ? exp2f(st[n][e] * scale_log2 - l2) : 0.f;
        const float p1 =
            sq == sk1 ? exp2f(st[n][2 + e] * scale_log2 - l2) : 0.f;
        st[n][e] = p0;
        st[n][2 + e] = p1;
        dpt[n][e] = p0 * (dpt[n][e] - dI) * scale;
        dpt[n][2 + e] = p1 * (dpt[n][2 + e] - dI) * scale;
      }
    }
    // dV += P^T.dO, dK += dS^T.Q over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st[2 * kk], st[2 * kk + 1]);
      pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int off = (n * 8 + g) * TLD + kk * 16 + 2 * t;
        mma_16816(dva[n], pa, ld32(dts + off), ld32(dts + off + 8));
        mma_16816(dka[n], sa, ld32(qt + off), ld32(qt + off + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dk + head + (size_t)r0 * D + c) =
          pack_bf16(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dv + head + (size_t)r0 * D + c) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dk + head + (size_t)r1 * D + c) =
          pack_bf16(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dv + head + (size_t)r1 * D + c) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// dQ of one (b, h, tile of 64 queries): a warp owns 16 queries
template <int D>
__global__ void __launch_bounds__(THREADS)
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
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;
  constexpr int TLD = TILE + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = TILE / 8;    // 8-key column tiles of S
  constexpr int PSTEPS = TILE / 16; // depth steps over the keys
  constexpr int NT_O = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 kt[D * TLD];
  __shared__ int segk[TILE];

  const unsigned tile = blockIdx.x % (unsigned)tiles;
  const unsigned bh = blockIdx.x / (unsigned)tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)bh * S * D;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;

  const int r0 = (int)tile * TILE + warp * 16 + g, r1 = r0 + 8;
  const int sq0 = seg_q[(size_t)b * S + min(r0, S - 1)];
  const int sq1 = seg_q[(size_t)b * S + min(r1, S - 1)];
  const float l20 = r0 < S ? lse[(size_t)bh * S + r0] * LOG2E : INFINITY;
  const float l21 = r1 < S ? lse[(size_t)bh * S + r1] * LOG2E : INFINITY;
  const float di0 = r0 < S ? di[(size_t)bh * S + r0] : 0.f;
  const float di1 = r1 < S ? di[(size_t)bh * S + r1] : 0.f;
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  flash::load_a_rows<D>(qa, q + head, r0, S, t);
  flash::load_a_rows<D>(da, dout + head, r0, S, t);

  float dqa[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += TILE) {
    __syncthreads();
    flash::stage_rows<TILE, D, LD, TLD, THREADS>(kh, kv0, S, ks, kt);
    flash::stage_rows<TILE, D, LD, TLD, THREADS>(vh, kv0, S, vs, nullptr);
    for (int j = threadIdx.x; j < TILE; j += THREADS)
      segk[j] = kv0 + j < S ? seg_kv[(size_t)b * S + kv0 + j] : 0;
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: 16 queries x 64 keys each
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[n], qa[kk], ld32(ks + off), ld32(ks + off + 8));
        mma_16816(dp[n], da[kk], ld32(vs + off), ld32(vs + off + 8));
      }
    }
    // dS in place of dP
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t + e;
        const bool live = kv0 + j < S;
        const int sk = segk[j];
        const float p0 =
            live && sk == sq0 ? exp2f(s[n][e] * scale_log2 - l20) : 0.f;
        const float p1 =
            live && sk == sq1 ? exp2f(s[n][2 + e] * scale_log2 - l21) : 0.f;
        dp[n][e] = p0 * (dp[n][e] - di0) * scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - di1) * scale;
      }
    }
    // dQ += dS.K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      uint32_t sa[4];
      pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int off = (n * 8 + g) * TLD + kk * 16 + 2 * t;
        mma_16816(dqa[n], sa, ld32(kt + off), ld32(kt + off + 8));
      }
    }
  }

  __nv_bfloat16* dqh = dq + head;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqh + (size_t)r0 * D + c) =
          pack_bf16(dqa[n][0], dqa[n][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dqh + (size_t)r1 * D + c) =
          pack_bf16(dqa[n][2], dqa[n][3]);
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
  int H, S;
  unsigned blocks;
  int tiles;
  float scale, scale_log2;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv(const Args& a) {
  if (a.dtype == 2)
    flash_bwd_dkv_bf16<D><<<a.blocks, THREADS, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), a.seg_q, a.seg_kv, a.lse,
        static_cast<const __nv_bfloat16*>(a.dout), a.di,
        static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
        a.H, a.S, a.tiles, a.scale, a.scale_log2);
  else
    flash_bwd_dkv_f32<D><<<a.blocks, TILE, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.seg_q, a.seg_kv, a.lse,
        static_cast<const float*>(a.dout), a.di, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.H, a.S, a.tiles, a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  if (a.dtype == 2)
    flash_bwd_dq_bf16<D><<<a.blocks, THREADS, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), a.seg_q, a.seg_kv, a.lse,
        static_cast<const __nv_bfloat16*>(a.dout), a.di,
        static_cast<__nv_bfloat16*>(a.dq), a.H, a.S, a.tiles, a.scale,
        a.scale_log2);
  else
    flash_bwd_dq_f32<D><<<a.blocks, TILE, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.seg_q, a.seg_kv, a.lse,
        static_cast<const float*>(a.dout), a.di, static_cast<float*>(a.dq),
        a.H, a.S, a.tiles, a.scale, a.scale_log2);
  return cudaGetLastError();
}

// fills the shared fields; cudaErrorInvalidValue on a bad argument
cudaError_t prepare(Args& a, int dtype, int B, int H, int S, float sm_scale,
                    void* stream) {
  if ((dtype != 1 && dtype != 2) || B <= 0 || H <= 0 || S <= 0)
    return cudaErrorInvalidValue;
  a.dtype = dtype;
  a.H = H;
  a.S = S;
  a.tiles = (S + TILE - 1) / TILE;
  const long long blocks = (long long)B * H * a.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.blocks = (unsigned)blocks;
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
  const cudaError_t err = prepare(a, dtype, B, H, S, sm_scale, stream);
  if (err != cudaSuccess) return (int)err;
  a.q = q; a.k = k; a.v = v; a.seg_q = seg_q; a.seg_kv = seg_kv;
  a.lse = lse; a.dout = dout; a.di = di; a.dk = dk; a.dv = dv;
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
  const cudaError_t err = prepare(a, dtype, B, H, S, sm_scale, stream);
  if (err != cudaSuccess) return (int)err;
  a.q = q; a.k = k; a.v = v; a.seg_q = seg_q; a.seg_kv = seg_kv;
  a.lse = lse; a.dout = dout; a.di = di; a.dq = dq;
  switch (D) {
    case 16: return (int)launch_dq<16>(a);
    case 32: return (int)launch_dq<32>(a);
    case 64: return (int)launch_dq<64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
