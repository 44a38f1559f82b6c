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
// 260^2 + 252^2 of the 512^2 pairs) the operations bound halves, and the
// bytes bound the kernel.
//
// bf16 design (a simple one that is right; four warps a block):
// - one block a (b, h, tile of 64 queries); a warp owns 16 query rows and
//   keeps their Q fragments in registers, read once from device memory;
// - the keys go by in tiles of 64: K rows and seg_kv staged in shared
//   memory, V staged TRANSPOSED (d-major) so that a P.V operand fragment
//   is one 32-bit load; rows past S are zero-filled and masked;
// - Q.K^T as bf16 mma.sync m16n8k16 with f32 accumulation (bf16 products
//   are exact in f32; only the order of the sum differs from a BLAS);
// - an online softmax in f32 registers, in base 2 (scores scaled by
//   sm_scale * log2 e): a running max and sum a row. A row whose keys so
//   far are all masked keeps max -inf and subtracts 0 instead, so
//   exp2(-inf - -inf) never makes a NaN;
// - P.V as bf16 mma.sync into f32: the score accumulators are laid out as
//   the A operand of the next product, so P goes from registers to the
//   tensor core rounded to bf16 (relative 2^-9 a weight; the JAX einsum
//   path rounds its weights to bf16 too). The row sums are taken from the
//   unrounded f32 weights;
// - one bf16 output written a row, in the encoder's working dtype.
// f32 inputs take a plain f32 FMA path in the same source: one thread a
// query row, K and V tiles of 64 keys in shared memory, the same online
// softmax; no tensor cores (no TF32).
//
// Left for later: wgmma, a TMA ring (here one tile is staged, then used),
// skipping key tiles that hold no key of a real row's segment (every tile
// is computed, masked ones included), and reading q, k, v straight from the
// [B, S, 3*hidden] projection instead of three transposed copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using flash::ld32;
using flash::LN2;
using flash::LOG2E;
using flash::mma_16816;
using flash::pack_bf16;

constexpr int BQ = 64;          // query rows of a block
constexpr int BKV = 64;         // keys of a staged tile
constexpr int WARPS = BQ / 16;  // bf16: a warp owns 16 query rows
constexpr int THREADS = WARPS * 32;

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

// (fragment layouts of mma.m16n8k16: mma_bf16.cuh)
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
               int S, int q_tiles, float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KLD = D + 8;       // K tile stride (bf16): conflict-free B loads
  constexpr int VLD = BKV + 8;     // transposed V tile stride
  constexpr int KSTEPS = D / 16;   // depth steps of Q.K^T
  constexpr int NT_S = BKV / 8;    // 8-key column tiles of the scores
  constexpr int PSTEPS = BKV / 16; // depth steps of P.V
  constexpr int NT_O = D / 8;      // 8-wide column tiles of the output
  constexpr int CHUNKS = BKV * D / 8;   // 16-byte pieces of a K (or V) tile
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * KLD];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VLD];
  __shared__ int segk[BKV];

  const unsigned tile = blockIdx.x % (unsigned)q_tiles;
  const unsigned bh = blockIdx.x / (unsigned)q_tiles;
  const unsigned b = bh / (unsigned)H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)bh * S * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  const int* skv = seg_kv + (size_t)b * S;

  // this thread's two query rows; rows past S compute on and are not written
  const int r0 = (int)tile * BQ + warp * 16 + g, r1 = r0 + 8;
  const int sq0 = seg_q[(size_t)b * S + min(r0, S - 1)];
  const int sq1 = seg_q[(size_t)b * S + min(r1, S - 1)];
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < S ? ld32(qh + (size_t)r0 * D + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(qh + (size_t)r1 * D + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(qh + (size_t)r0 * D + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(qh + (size_t)r1 * D + c + 8) : 0u;
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();   // every warp is done with the previous tile
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = kv0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < S) {
        kx = *reinterpret_cast<const uint4*>(kh + (size_t)key * D + col);
        vx = *reinterpret_cast<const uint4*>(vh + (size_t)key * D + col);
      }
      *reinterpret_cast<uint4*>(ks + row * KLD + col) = kx;
      const uint32_t vw[4] = {vx.x, vx.y, vx.z, vx.w};
      unsigned short* vt16 = reinterpret_cast<unsigned short*>(vt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // element 2i in the low half
        vt16[(col + 2 * i) * VLD + row] = (unsigned short)(vw[i] & 0xffffu);
        vt16[(col + 2 * i + 1) * VLD + row] = (unsigned short)(vw[i] >> 16);
      }
    }
    for (int j = threadIdx.x; j < BKV; j += THREADS)
      segk[j] = kv0 + j < S ? skv[kv0 + j] : 0;
    __syncthreads();

    // scores of 16 rows x 64 keys, this thread's 2 x 16 of them
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * KLD + kk * 16 + 2 * t;
        mma_16816(s[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t + e;
        const bool live = kv0 + j < S;
        const int sk = segk[j];
        s[n][e] = live && sk == sq0 ? s[n][e] * scale_log2 : -INFINITY;
        s[n][2 + e] = live && sk == sq1 ? s[n][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, group_max(mx0));
    const float mn1 = fmaxf(m1, group_max(mx1));
    // a row with no live key yet keeps max -inf: subtract 0 instead
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    // P: score tiles 2kk and 2kk+1 are the A operand of depth step kk
    uint32_t pa[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      const int lo = 2 * kk, hi = 2 * kk + 1;
      const float p0 = exp2f(s[lo][0] - base0), p1 = exp2f(s[lo][1] - base0);
      const float p2 = exp2f(s[lo][2] - base1), p3 = exp2f(s[lo][3] - base1);
      const float p4 = exp2f(s[hi][0] - base0), p5 = exp2f(s[hi][1] - base0);
      const float p6 = exp2f(s[hi][2] - base1), p7 = exp2f(s[hi][3] - base1);
      l0 += (p0 + p1) + (p4 + p5);
      l1 += (p2 + p3) + (p6 + p7);
      pa[kk][0] = pack_bf16(p0, p1);
      pa[kk][1] = pack_bf16(p2, p3);
      pa[kk][2] = pack_bf16(p4, p5);
      pa[kk][3] = pack_bf16(p6, p7);
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk) {
        const __nv_bfloat16* vp = vt + (n * 8 + g) * VLD + kk * 16 + 2 * t;
        mma_16816(acc[n], pa[kk], ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 = group_sum(l0);
  l1 = group_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (LSE && t == 0) {
    if (r0 < S) lse[(size_t)bh * S + r0] = row_lse(m0, l0);
    if (r1 < S) lse[(size_t)bh * S + r1] = row_lse(m1, l1);
  }
  __nv_bfloat16* oh = o + head;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * D + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * D + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
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

// LSE is a template flag: without it the kernels compile as they did
// before the lse output existed (the serve path's code is unchanged)
template <int D, bool LSE>
void launch_as(int dtype, const void* q, const void* k, const void* v,
               const int* seg_q, const int* seg_kv, void* o, float* lse,
               int H, int S, unsigned blocks, int q_tiles, float scale_log2,
               cudaStream_t s) {
  if (dtype == 2)
    flash_fwd_bf16<D, LSE><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv,
        static_cast<__nv_bfloat16*>(o), lse, H, S, q_tiles, scale_log2);
  else
    flash_fwd_f32<D, LSE><<<blocks, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg_q, seg_kv, static_cast<float*>(o),
        lse, H, S, q_tiles, scale_log2);
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_kv, void* o, float* lse,
                   int H, int S, unsigned blocks, int q_tiles,
                   float scale_log2, cudaStream_t s) {
  if (lse != nullptr)
    launch_as<D, true>(dtype, q, k, v, seg_q, seg_kv, o, lse, H, S, blocks,
                       q_tiles, scale_log2, s);
  else
    launch_as<D, false>(dtype, q, k, v, seg_q, seg_kv, o, lse, H, S, blocks,
                        q_tiles, scale_log2, s);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). dtype: 1 float32, 2 bfloat16.
// q, k, v, o [B, H, S, D] contiguous on one device, D in {16, 32, 64};
// seg_q, seg_kv [B, S] int32; lse [B, H, S] f32 or null (then nothing
// else changes). Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const int* seg_q,
                                      const int* seg_kv, void* o, float* lse,
                                      int B, int H, int S, int D,
                                      float sm_scale, void* stream) {
  if ((dtype != 1 && dtype != 2) || B <= 0 || H <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (S + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = sm_scale * LOG2E;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  switch (D) {
    case 16:
      return (int)launch<16>(dtype, q, k, v, seg_q, seg_kv, o, lse, H, S,
                             nb, q_tiles, scale_log2, s);
    case 32:
      return (int)launch<32>(dtype, q, k, v, seg_q, seg_kv, o, lse, H, S,
                             nb, q_tiles, scale_log2, s);
    case 64:
      return (int)launch<64>(dtype, q, k, v, seg_q, seg_kv, o, lse, H, S,
                             nb, q_tiles, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
