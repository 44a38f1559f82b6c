// Flash attention forward for Hopper (sm_90a): softmax(Q.K^T * sm_scale)
// . V over the keys of the query's own segment, the [S, S] scores never
// leaving the SM.
//
// Replaces the JAX library's Pallas TPU kernel that the MiniLM encoder
// calls (rag_foundation_tpu/models/encoder.py:100 `_attention`, the call at
// :116-120; jax/experimental/pallas/ops/tpu/flash_attention.py:758,
// `_flash_attention_impl`, in JAX 0.9.0). Same contract as the encoder
// calls it, with no causal mask and no bias:
//
//   out[b,h,i,:] = sum_j softmax_j(q[b,h,i] . k[b,h,j] * sm_scale
//                                  over j with seg_kv[b,j] == seg_q[b,i])
//                  v[b,h,j]
//
//   q, k, v, out [B, H, S, D] contiguous (bf16, or f32); seg_q, seg_kv
//   [B, S] int32. The encoder gives 1 to a token and 0 to a pad, so a pad
//   query attends to pad keys only; a row always has its own key.
//
// For training, the kernel also writes the log-sum-exp of each row when it
// is given a non-null `lse` [B, H, S] f32 (a second instantiation, so the
// code without it is the serve path's as before): the row's running max plus the
// log of its running sum, in natural-log units, over the keys of the row's
// own segment (-inf for a row with none, which the encoder never makes).
// The library's forward saves the max `m` and the sum `l` apart
// (`_flash_attention_fwd`, :234-251) and its backward recomputes
// p = exp(s - m) / l; one lse carries the same information, as
// p = exp(s - lse). With a null pointer nothing else changes.
//
// Bound on an H100 SXM at the encoder's long-chunk shape (B=256, H=12,
// S=512, D=32, bf16), reckoned from the data sheet, not measured: bytes
// 4*B*S*H*D*2 of q, k, v, out = 403 MB, 0.120 ms at 3.35 TB/s; operations
// 4*B*H*S^2*D = 103 GFLOP, 0.104 ms at 989 TFLOP/s dense bf16. Where the
// segments cut the pairs (a chunk of 260 tokens in a 512 bucket needs
// 260^2 + 252^2 of the 512^2 pairs) the operations bound halves. One
// exponential a pair on the special-function unit (16 a clock an SM) sets a
// third floor: 805M of them, 0.193 ms, for every pair at S=512, which the
// kernel issues for every pair of each 16-row x CT-key block it computes
// (utils/roofline.py counts the same-segment pairs).
//
// bf16 design (bf16 mma.sync m16n8k16 with f32 accumulation):
// - one block a (b, h, tile of WARPS * MW queries); a warp owns MW query
//   rows and keeps their Q fragments in registers, read once;
// - the keys go by in tiles of CT rows of K, V and seg_kv, row-major, in a
//   two-stage cp.async ring (flash::Stage, shared with the backward
//   kernels): the next tile is in flight while this one is computed, one
//   __syncthreads a tile. Rows past S are zero-filled and masked;
// - every B fragment by ldmatrix .x4: K's for Q.K^T as stored, V's for
//   P.V by .trans of the same row-major tile, so no transposed copy;
// - an online softmax in f32 registers, in base 2: a running max and sum
//   a row, the tile's scores scaled by sm_scale * log2 e inside the
//   exponent (one FFMA), the weights by ex2.approx.ftz on the
//   special-function unit. A row whose keys so far are all masked keeps
//   max -inf and subtracts 0 instead, so no NaN is made;
// - one test a tile and warp of the segment ids: a tile that holds no key
//   of an id among the warp's rows is skipped (its weights are all 0: at
//   S=512 a real row's warp skips the pad keys' tiles, a pad row's warp the
//   real ones); a full tile whose keys and the warp's rows all hold one id
//   is computed with no test a pair; the others test each pair;
// - P.V as bf16 mma.sync into f32: the score accumulators are laid out as
//   the A operand of the next product, so P goes from registers to the
//   tensor core rounded to bf16 (relative 2^-9 a weight; the JAX einsum
//   path rounds its weights to bf16 too). The row sums are taken from the
//   unrounded f32 weights;
// - tiles fit to S: S <= 32 two warps of 16 rows and 32-key tiles (no
//   product on zero-fill at S = 32); past that four warps of 32 rows, two
//   m-tiles sharing each K and V fragment loaded, and 64-key tiles, held to
//   170 registers so that three blocks fit an SM (16 rows a warp at D = 64);
// - one bf16 output written a row, in the encoder's working dtype.
// q, k and v must be 16-byte aligned (cp.async); the entry point returns
// cudaErrorMisalignedAddress otherwise.
// f32 inputs take a plain f32 FMA path in the same source: one thread a
// query row, K and V tiles of 64 keys in shared memory, the same online
// softmax; no tensor cores (no TF32).
//
// Left for later: wgmma, and reading q, k, v straight from the
// [B, S, 3*hidden] projection instead of three transposed copies (a
// layout the backward kernels share).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using flash::ex2;
using flash::Flag;
using flash::LN2;
using flash::LOG2E;
using flash::mma_16816;
using flash::pack_a;
using flash::RING;
using flash::Stage;

constexpr int BQ = 64;          // f32: query rows of a block
constexpr int BKV = 64;         // f32: keys of a staged tile

__device__ __forceinline__ float group_max(float x) {   // over a quad
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// natural-log log-sum-exp of a row from its base-2 running max and sum; a
// row with no key of its segment (max -inf, sum 0) gets -inf
__device__ __forceinline__ float row_lse(float m2, float l) {
  return m2 == -INFINITY ? -INFINITY : (m2 + log2f(l)) * LN2;
}

// out (and lse) of one (b, h, tile of WARPS * MW queries): a warp owns MW
// query rows; the keys go by in CT-row tiles (fragment layouts of
// mma.m16n8k16: mma_bf16.cuh)
template <int D, int MW, int WARPS, int CT, bool LSE>
__global__ void __launch_bounds__(WARPS * 32, MW == 32 ? 3 : 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
               int S, int q_tiles, float scale_log2) {
  static_assert(D % 16 == 0 && MW % 16 == 0 && CT % 16 == 0, "tile shape");
  constexpr int LD = D + 8;
  constexpr int THREADS = WARPS * 32;
  constexpr int MT = MW / 16;       // 16-row m-tiles a warp
  constexpr int KSTEPS = D / 16;    // depth steps of Q.K^T
  constexpr int NT_S = CT / 8;      // 8-key column tiles of the scores
  constexpr int NT_O = D / 8;       // 8-wide column tiles of the output
  __shared__ Stage<D, CT> ring[RING];

  const unsigned tile = blockIdx.x % (unsigned)q_tiles;
  const unsigned bh = blockIdx.x / (unsigned)q_tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, lr = lane & 7;   // ldmatrix: tile, row
  // this lane's ldmatrix row addresses, in bytes from a tile's first row:
  // as stored (K for Q.K^T) and transposed (V for P.V)
  const uint32_t ld_row = 2 * (((lj >> 1) * 8 + lr) * LD + (lj & 1) * 8);
  const uint32_t ld_trow = 2 * (((lj & 1) * 8 + lr) * LD + (lj >> 1) * 8);
  const size_t head = (size_t)bh * S * D;
  const int* segq = seg_q + (size_t)b * S;
  const int* segk = seg_kv + (size_t)b * S;

  // the first key tile is in flight while the queries load
  const int n_tiles = (S + CT - 1) / CT;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_tiles)
      flash::stage_tile<D, CT, THREADS>(ring[s], k + head, v + head, segk,
                                        nullptr, nullptr, s * CT, S);
    s8::cp_async_commit();
  }

  // this warp's rows qrow0 + 16 mt + g (+ 8); a row past S computes on
  // with row S-1's segment and is not written
  const int qrow0 = (int)tile * (WARPS * MW) + warp * MW;
  uint32_t qa[MT][KSTEPS][4];
  int sq[MT][2];
  float m[MT][2], l[MT][2], acc[MT][NT_O][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = qrow0 + mt * 16 + g;
    flash::load_a_rows<D>(qa[mt], q + head, r0, S, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sq[mt][h] = segq[min(r0 + 8 * h, S - 1)];
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  int qlo, qhi;   // the ids of the warp's rows before S
  flash::row_ids(segq, qrow0, MW, S, lane, qlo, qhi);

  for (int it = 0; it < n_tiles; ++it) {
    s8::cp_async_wait<RING - 2>();
    __syncthreads();   // tile `it` is in; every warp is done with it - 1
    const int next = it + RING - 1;
    if (next < n_tiles)
      flash::stage_tile<D, CT, THREADS>(ring[next % RING], k + head,
                                        v + head, segk, nullptr, nullptr,
                                        next * CT, S);
    s8::cp_async_commit();
    const Stage<D, CT>& st = ring[it % RING];
    const uint32_t ks = flash::smem_u32(st.a), vs = flash::smem_u32(st.b);
    const int live = S - it * CT;   // keys of this tile before S
    int tlo, thi;
    flash::tile_ids<CT>(st.seg, live, lane, tlo, thi);
    if (thi < qlo || tlo > qhi) continue;   // no pair of one segment

    // the tile with a test of each pair (SEGS) or none
    auto tile_body = [&](auto segs) {
      constexpr bool SEGS = decltype(segs)::value;
      float s[MT][NT_S][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT_S; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
      // S = Q.K^T: K's B operands as stored, 16 keys an ldmatrix group
#pragma unroll
      for (int gk = 0; gk < CT / 16; ++gk) {
        uint32_t kb[KSTEPS][4];
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          flash::ldmatrix_x4(kb[kk], ks + 2 * gk * 16 * LD + ld_row + 32 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk)
              mma_16816(s[mt][2 * gk + n], qa[mt][kk], kb[kk][2 * n],
                        kb[kk][2 * n + 1]);
      }
      if constexpr (SEGS) {   // masked pairs score -inf
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          const int j = n * 8 + 2 * t;
          const int2 sk = *reinterpret_cast<const int2*>(st.seg + j);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (j >= live || sk.x != sq[mt][h]) s[mt][n][2 * h] = -INFINITY;
              if (j + 1 >= live || sk.y != sq[mt][h])
                s[mt][n][2 * h + 1] = -INFINITY;
            }
        }
      }
      // the rows' new maxima (scores are scaled inside the exponent:
      // sm_scale > 0 keeps their order), and the old sums rescaled
      float base[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT_S; ++n)
            mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
          const float mn = fmaxf(m[mt][h], group_max(mx) * scale_log2);
          // a row with no live key yet keeps max -inf: subtract 0 instead
          base[mt][h] = mn == -INFINITY ? 0.f : mn;
          const float alpha = ex2(m[mt][h] - base[mt][h]);
          m[mt][h] = mn;
          l[mt][h] *= alpha;
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            acc[mt][n][2 * h] *= alpha;
            acc[mt][n][2 * h + 1] *= alpha;
          }
        }
      // P.V over 16-key steps: P from the score accumulators (tiles 2kk,
      // 2kk + 1 are the A operand of step kk), V's B operands by
      // ldmatrix .trans of the row-major tile (two 8-wide d tiles an x4)
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
        uint32_t vb[NT_O / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < NT_O / 2; ++n2)
          flash::ldmatrix_x4_trans(vb[n2],
                                   vs + 2 * kk * 16 * LD + ld_trow + 32 * n2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float p[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[n][e] = ex2(fmaf(s[mt][2 * kk + n][e], scale_log2,
                                 -base[mt][e >> 1]));
          l[mt][0] += (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
          l[mt][1] += (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
          uint32_t pa[4];
          pack_a(pa, p[0], p[1]);
#pragma unroll
          for (int n2 = 0; n2 < NT_O / 2; ++n2) {
            mma_16816(acc[mt][2 * n2], pa, vb[n2][0], vb[n2][1]);
            mma_16816(acc[mt][2 * n2 + 1], pa, vb[n2][2], vb[n2][3]);
          }
        }
      }
    };
    if (live >= CT && qlo == qhi && tlo == thi && qlo == tlo)
      tile_body(Flag<false>{});
    else
      tile_body(Flag<true>{});
  }

  __nv_bfloat16* oh = o + head;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qrow0 + mt * 16 + 8 * h + g;
      const float sum = group_sum(l[mt][h]);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      if (r >= S) continue;
      if (LSE && t == 0) lse[(size_t)bh * S + r] = row_lse(m[mt][h], sum);
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        *reinterpret_cast<uint32_t*>(oh + (size_t)r * D + n * 8 + 2 * t) =
            flash::pack_bf16(acc[mt][n][2 * h] * inv,
                             acc[mt][n][2 * h + 1] * inv);
    }
}

// f32: one thread a query row, plain FMA, the same online softmax.
template <int D, bool LSE>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_kv, float* __restrict__ o,
              float* __restrict__ lse, int H, int S, int q_tiles,
              float scale_log2) {
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];
  __shared__ int segk[BKV];
  const unsigned tile = blockIdx.x % (unsigned)q_tiles;
  const unsigned bh = blockIdx.x / (unsigned)q_tiles;
  const unsigned b = bh / (unsigned)H;
  const size_t head = (size_t)bh * S * D;
  const int r = (int)tile * BQ + threadIdx.x;
  const int sq = seg_q[(size_t)b * S + min(r, S - 1)];
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = r < S ? q[head + (size_t)r * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();
    for (int c = threadIdx.x; c < BKV * D; c += BQ) {
      const int row = c / D, col = c % D, key = kv0 + row;
      ks[row][col] = key < S ? k[head + (size_t)key * D + col] : 0.f;
      vs[row][col] = key < S ? v[head + (size_t)key * D + col] : 0.f;
    }
    for (int j = threadIdx.x; j < BKV; j += BQ)
      segk[j] = kv0 + j < S ? seg_kv[(size_t)b * S + kv0 + j] : 0;
    __syncthreads();
    const int live = min(BKV, S - kv0);
    for (int j = 0; j < live; ++j) {
      if (segk[j] != sq) continue;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      s *= scale_log2;
      if (s > m) {   // m = -inf: alpha = 0, and acc, l are still 0
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }
  if (r >= S) return;
  if (LSE) lse[bh * (size_t)S + r] = row_lse(m, l);
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) o[head + (size_t)r * D + d] = acc[d] * inv;
}

// The bf16 tiles (MW rows a warp, WARPS warps, CT-key tiles): S <= 32 one
// 32-row tile of two warps; past that four warps of 32 rows (16 for D = 64:
// registers) and 64-key tiles.

template <int D, int MW, int WARPS, int CT, bool LSE>
void launch_bf16(const void* q, const void* k, const void* v,
                 const int* seg_q, const int* seg_kv, void* o, float* lse,
                 int B, int H, int S, float scale_log2, cudaStream_t s) {
  const int q_tiles = (S + WARPS * MW - 1) / (WARPS * MW);
  flash_fwd_bf16<D, MW, WARPS, CT, LSE>
      <<<(unsigned)((long long)B * H * q_tiles), WARPS * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv,
          static_cast<__nv_bfloat16*>(o), lse, H, S, q_tiles, scale_log2);
}

// LSE is a template flag: without it the kernels compile with no lse
// output at all (the serve path's code)
template <int D, bool LSE>
void launch_as(int dtype, const void* q, const void* k, const void* v,
               const int* seg_q, const int* seg_kv, void* o, float* lse,
               int B, int H, int S, float scale_log2, cudaStream_t s) {
  if (dtype == 2) {
    if (S <= 32) {
      launch_bf16<D, 16, 2, 32, LSE>(q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                                     scale_log2, s);
      return;
    }
    if constexpr (D <= 32)
      launch_bf16<D, 32, 4, 64, LSE>(q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                                     scale_log2, s);
    else
      launch_bf16<D, 16, 4, 64, LSE>(q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                                     scale_log2, s);
    return;
  }
  const int q_tiles = (S + BQ - 1) / BQ;
  flash_fwd_f32<D, LSE><<<(unsigned)((long long)B * H * q_tiles), BQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_kv, static_cast<float*>(o),
      lse, H, S, q_tiles, scale_log2);
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_kv, void* o, float* lse,
                   int B, int H, int S, float scale_log2, cudaStream_t s) {
  if (lse != nullptr)
    launch_as<D, true>(dtype, q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                       scale_log2, s);
  else
    launch_as<D, false>(dtype, q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                        scale_log2, s);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). dtype: 1 float32, 2 bfloat16.
// q, k, v, o [B, H, S, D] contiguous on one device, D in {16, 32, 64};
// seg_q, seg_kv [B, S] int32; lse [B, H, S] f32 or null (then nothing
// else changes); sm_scale > 0. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const int* seg_q,
                                      const int* seg_kv, void* o, float* lse,
                                      int B, int H, int S, int D,
                                      float sm_scale, void* stream) {
  // sm_scale > 0: the bf16 kernel takes a tile's row maximum before the
  // scale, which then keeps the scores' order
  if ((dtype != 1 && dtype != 2) || B <= 0 || H <= 0 || S <= 0 ||
      !(sm_scale > 0.f))
    return (int)cudaErrorInvalidValue;
  // the most blocks of any tile shape: 32-row tiles
  if ((long long)B * H * ((S + 31) / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2 && ((reinterpret_cast<uintptr_t>(q)
                      | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float scale_log2 = sm_scale * LOG2E;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return (int)launch<16>(dtype, q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                             scale_log2, s);
    case 32:
      return (int)launch<32>(dtype, q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                             scale_log2, s);
    case 64:
      return (int)launch<64>(dtype, q, k, v, seg_q, seg_kv, o, lse, B, H, S,
                             scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
