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
// Design (simple, correct first): one 128-thread block per (list,
// sub-block). Thread t owns row t of the sub-block. The block walks the
// feature dimension in 128-byte chunks: the 128 row chunks and the chunks
// of a tile of QT query slots are staged in shared memory with coalesced
// 16-byte loads, then each thread accumulates QT dots for its row (4
// __dp4a per 16 bytes for int8, FMA for f32/bf16; query reads are
// shared-memory broadcasts). Scores go to shared memory; each warp then
// runs p passes of a warp-wide argmax (value desc, column asc) for its
// query slots. Query tiles larger than QT loop, re-reading the rows.
//
// Bound on an H100 (3.35 TB/s HBM, 1,979 int8 TOP/s): the kernel reads
// the live rows of every list that has a query once per batch, plus
// every row id of those lists, and does 2*qcap ops per row byte, so at
// the engine's qcap (8..32) it is memory-bound. What this
// design leaves on the table: no tensor cores (wgmma s8 tiles), no TMA
// ring to keep more bytes in flight, no reuse of the staged rows across
// query tiles beyond L2, and a shared-memory broadcast per query chunk
// that caps the dp4a rate. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "subblock_topp.cuh"

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
  static const int elem[3] = {1, 4, 2};
  if (dtype < 0 || dtype > 2 || cap_len % SUB != 0 || nlist <= 0 ||
      nlist > 65535 || cap_len / SUB > 65535 || qcap <= 0 || p <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)d * elem[dtype];
  if (row_bytes % 16 != 0 || row_bytes > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_kind<0>(qdisp, lists, row_ids, live_n, vals, idx, nlist, qcap,
                           cap_len, (int)row_bytes, p, scale, s);
      break;
    case 1:
      err = launch_kind<1>(qdisp, lists, row_ids, live_n, vals, idx, nlist, qcap,
                           cap_len, (int)row_bytes, p, scale, s);
      break;
    default:
      err = launch_kind<2>(qdisp, lists, row_ids, live_n, vals, idx, nlist, qcap,
                           cap_len, (int)row_bytes, p, scale, s);
      break;
  }
  return (int)err;
}
