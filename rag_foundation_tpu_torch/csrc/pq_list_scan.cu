// IVF-PQ ADC list scan for Hopper (sm_90a): per posting list, score the
// query slots dispatched to it against every row's 4-bit PQ codes by table
// lookup, and keep the top-p rows of each 128-row sub-block.
//
// Replaces the Pallas TPU kernel `_pq_scan_kernel` behind `pq_list_scan`
// (rag_foundation_tpu/ops/pallas_pq.py:88 and :135; selection
// `extract_subblock_topp`, rag_foundation_tpu/ops/pallas_ivf.py:45). Same
// contract:
//
//   score(l, s, c) = sum over pos in [0, m) of
//                    lut_disp[l, s, code(l, c, pos) * m + pos]
//   with K = 16 codes, the LUT K-major as `flatten_luts` lays it out.
//   Unpacked tables: code(pos) = codes[l, c, pos]. Nibble-packed tables
//   ([.., m/2] bytes, byte = even | odd << 4): positions [0, m/2) are the
//   low nibbles and [m/2, m) the high nibbles, which is the [evens...,
//   odds...] order `flatten_luts(packed=True)` gives the LUT.
//   int8 LUT: exact int32 sum, returned as f32 (bit-identical to the plain
//   PyTorch version). bf16 LUT: f32 sum in position order (the plain
//   version sums in another order).
//   Dead rows (row_ids < 0) score -inf and are never selected. Outputs are
//   those of ivf_list_scan.cu: vals/idx[l, s, pass*nsub + b], idx =
//   l*cap_len + b*128 + r or -1. Query slots s >= live_n[l] (the dead tail
//   of a list's dispatch) are not computed and give (-inf, -1); a list
//   with no live slot is never read. Other dead slots are computed
//   unmasked, as on the TPU.
//
// What the TPU did and why this does not: the Pallas kernel expands the
// codes to a one-hot [rows, K*m] matrix and multiplies it with the LUT on
// the matrix unit, because a TPU has no gather. A GPU has one: shared
// memory. So the sum is m table lookups a (slot, row) pair, 1/32 of the
// one-hot product's operations.
//
// Bound on an H100: per batch the kernel must read the live rows' codes
// (m_bytes + 4 id bytes a row) and the live slots' LUTs once and write the
// outputs; it does live slots x live rows x m lookups, each a read of one
// LUT entry from shared memory. At the engine's shapes (m = 192, about 8
// live slots a list of about 2,400 rows) the two terms are of one size:
// the bytes over the HBM rate a little above the lookups over the
// shared-memory rate.
//
// Design: one 128-thread block per (list, group of sub-blocks); thread t
// owns row t of a sub-block. A tile of 8 query slots' LUTs is staged in
// shared memory TRANSPOSED to [k][pos][slot] (slot innermost), so ONE 8-
// or 16-byte shared load at (code, pos) fetches the entry of every slot of
// the tile: the lookups per row drop eightfold. Each K slab is padded by
// 16 bytes so that rows with different codes hit different banks. int8
// entries are stored biased by +128 as unsigned bytes and accumulated four
// slots to a register pair in 16-bit lanes (two PRMT and two IADD per four
// lookups; 255 * 256 < 2^16, flushed to int32 every 256 positions; the
// bias m*128 comes off at the end). The codes of the sub-block pass
// through shared memory in chunks of 16 words a row, word-transposed
// ([word][row], stride 129), so a thread's reads and the staging writes
// are both conflict-free and the global reads coalesce; the scores reuse
// that buffer. What the kernel waits for is latency, not bandwidth, so the
// block is kept small (about 33 KB of shared memory with an int8 LUT: six
// blocks an SM); a list with more than 8 live slots takes a second pass
// over its codes. The selection is the warp top-p shared with
// ivf_list_scan.cu. A block keeps its LUT tile across its sub-blocks, so
// the LUT is staged gridDim.x times a list, not once a sub-block. What is
// left on the table: tensor cores (the one-hot product as an int8 mma
// would trade 32x the operations for a much higher rate), TMA staging, and
// overlapping a chunk's staging with the previous chunk's lookups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "subblock_topp.cuh"

namespace {

constexpr int SUB = scan::SUB;
constexpr int WARPS = SUB / 32;
constexpr int K = 16;                 // codes per subquantizer (nbits = 4)
constexpr int CODE_STRIDE = SUB + 1;  // words: conflict-free both ways
constexpr int FLUSH = 256;            // positions per 16-bit accumulation run
constexpr int QT = 8;                 // query slots per tile
constexpr int CHUNK_WORDS = 16;       // code words per row staged at a time

// Per-thread accumulators of one query tile. KIND 0: int8 LUT, 2: bf16.
template <int KIND> struct Tile;

template <> struct Tile<0> {
  static constexpr int ENTRY = QT;    // bytes of one (k, pos) entry: QT x u8
  unsigned even[QT / 4], odd[QT / 4]; // 16-bit lanes: slots 4i+{0,2}, 4i+{1,3}
  int acc[QT];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) even[i] = odd[i] = 0;
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;
  }
  __device__ __forceinline__ void add(const unsigned char* e) {
    const uint2 v = *reinterpret_cast<const uint2*>(e);
    even[0] += __byte_perm(v.x, 0u, 0x4240);   // [b0, 0, b2, 0]
    odd[0] += __byte_perm(v.x, 0u, 0x4341);    // [b1, 0, b3, 0]
    even[1] += __byte_perm(v.y, 0u, 0x4240);
    odd[1] += __byte_perm(v.y, 0u, 0x4341);
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) {
      acc[4 * i + 0] += (int)(even[i] & 0xffffu);
      acc[4 * i + 2] += (int)(even[i] >> 16);
      acc[4 * i + 1] += (int)(odd[i] & 0xffffu);
      acc[4 * i + 3] += (int)(odd[i] >> 16);
      even[i] = odd[i] = 0;
    }
  }
  __device__ __forceinline__ float score(int j, int m) const {
    return __int2float_rn(acc[j] - 128 * m);
  }
};

template <> struct Tile<2> {
  static constexpr int ENTRY = QT * 2;   // QT x bf16
  float acc[QT];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.f;
  }
  __device__ __forceinline__ void add(const unsigned char* e) {
    const uint4 v = *reinterpret_cast<const uint4*>(e);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32: the top 16 bits
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ void flush() {}
  __device__ __forceinline__ float score(int j, int) const { return acc[j]; }
};

// the lookups of one code byte: position `pos`, and for packed tables the
// high nibble's position `pos + m_bytes`
template <int KIND>
__device__ __forceinline__ void lookup(Tile<KIND>& tile,
                                       const unsigned char* lut_s, int slab,
                                       unsigned code, int pos, int m_bytes,
                                       int packed) {
  constexpr int ENTRY = Tile<KIND>::ENTRY;
  tile.add(lut_s + (code & 15u) * slab + pos * ENTRY);
  if (packed) tile.add(lut_s + (code >> 4) * slab + (m_bytes + pos) * ENTRY);
}

template <int KIND>
__global__ void __launch_bounds__(SUB)
pq_scan_kernel(const unsigned char* __restrict__ lut_disp,
               const unsigned char* __restrict__ codes,
               const int* __restrict__ row_ids,
               const int* __restrict__ live_n,
               float* __restrict__ out_vals, int* __restrict__ out_idx,
               int qcap, int cap_len, int m, int m_bytes, int packed, int p) {
  using T = Tile<KIND>;
  constexpr int ENTRY = T::ENTRY;
  constexpr int ES = KIND == 0 ? 1 : 2;         // bytes of a LUT element
  extern __shared__ __align__(16) unsigned char smem[];
  const int slab = m * ENTRY + 16;              // bytes of one K slab, padded
  const int nwords = (m_bytes + 3) / 4;
  const int full_words = m_bytes / 4;
  unsigned char* lut_s = smem;                                  // K * slab
  // one buffer: a chunk of code words, then the sub-block's scores
  unsigned* codes_s = reinterpret_cast<unsigned*>(lut_s + K * slab);
  float* score_s = reinterpret_cast<float*>(codes_s);

  const int l = blockIdx.y;
  const int nsub = cap_len / SUB;
  const int width = nsub * p;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int km = K * m;
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);

  // dead tail of the dispatch: (-inf, -1), nothing read
  if (nlive < qcap)
    for (int sb = blockIdx.x; sb < nsub; sb += gridDim.x)
      scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub, sb, p, nlive,
                      qcap, t);
  if (nlive == 0) return;

  const unsigned char* lut_g = lut_disp + (size_t)l * qcap * km * ES;

  for (int q0 = 0; q0 < nlive; q0 += QT) {
    const int nq = min(QT, nlive - q0);
    __syncthreads();   // the previous tile's lookups are done
    // stage the tile's LUTs transposed: entry e = k*m + pos of every slot
    // goes to one ENTRY-byte cell (reads coalesce over e for each slot)
    for (int e = t; e < km; e += SUB) {
      const int k = e / m, pos = e - k * m;
      unsigned char* cell = lut_s + k * slab + pos * ENTRY;
      if constexpr (KIND == 0) {
        unsigned w[QT / 4];
#pragma unroll
        for (int i = 0; i < QT / 4; ++i) {
          unsigned word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = 4 * i + b;
            // slots past the tile's end hold bias only (never written out)
            const int v = j < nq ? (int)(signed char)__ldg(
                lut_g + (size_t)(q0 + j) * km + e) : 0;
            word |= (unsigned)(v + 128) << (8 * b);
          }
          w[i] = word;
        }
        *reinterpret_cast<uint2*>(cell) = make_uint2(w[0], w[1]);
      } else {
        const unsigned short* g =
            reinterpret_cast<const unsigned short*>(lut_g);
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned a = 2 * i < nq
              ? __ldg(g + (size_t)(q0 + 2 * i) * km + e) : 0u;
          const unsigned b = 2 * i + 1 < nq
              ? __ldg(g + (size_t)(q0 + 2 * i + 1) * km + e) : 0u;
          w[i] = a | (b << 16);
        }
        *reinterpret_cast<uint4*>(cell) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }

    for (int sb = blockIdx.x; sb < nsub; sb += gridDim.x) {
      const size_t row0 = (size_t)l * cap_len + (size_t)sb * SUB;
      const bool live = row_ids[row0 + t] >= 0;
      // also orders: LUT staged / previous sub-block's scores consumed
      if (__syncthreads_count(live) == 0) {
        // a sub-block of dead rows: (-inf, -1) for the tile's slots
        scan::fill_dead(out_vals, out_idx, l, qcap, width, nsub, sb, p, q0,
                        q0 + nq, t);
        continue;
      }
      const unsigned char* codes_g = codes + row0 * m_bytes;
      T tile;
      tile.zero();
      int run = 0;   // positions since the last flush
      for (int w0 = 0; w0 < nwords; w0 += CHUNK_WORDS) {
        const int nw = min(CHUNK_WORDS, nwords - w0);
        if (w0 > 0) __syncthreads();   // the previous chunk is consumed
        // stage the chunk word-transposed: [word][row]
        if ((m_bytes & 15) == 0 && nw == CHUNK_WORDS) {
          // whole chunk, 16-byte aligned rows: four 16-byte loads a thread
          for (int i = t; i < SUB * (CHUNK_WORDS / 4); i += SUB) {
            const int r = i / (CHUNK_WORDS / 4), q = i % (CHUNK_WORDS / 4);
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                codes_g + (size_t)r * m_bytes + 4 * w0 + 16 * q));
            unsigned* dst = codes_s + (4 * q) * CODE_STRIDE + r;
            dst[0] = v.x;
            dst[CODE_STRIDE] = v.y;
            dst[2 * CODE_STRIDE] = v.z;
            dst[3 * CODE_STRIDE] = v.w;
          }
        } else if ((m_bytes & 3) == 0) {
          const unsigned* g = reinterpret_cast<const unsigned*>(codes_g);
          for (int i = t; i < SUB * nw; i += SUB) {
            const int r = i / nw, w = i - r * nw;
            codes_s[w * CODE_STRIDE + r] = g[(size_t)r * nwords + w0 + w];
          }
        } else {
          for (int i = t; i < SUB * nw; i += SUB) {
            const int r = i / nw, w = i - r * nw;
            unsigned word = 0;
            for (int b = 0; b < 4; ++b)
              if (4 * (w0 + w) + b < m_bytes)
                word |= (unsigned)codes_g[(size_t)r * m_bytes +
                                          4 * (w0 + w) + b] << (8 * b);
            codes_s[w * CODE_STRIDE + r] = word;
          }
        }
        __syncthreads();
        for (int w = 0; w < nw; ++w) {
          const unsigned word = codes_s[w * CODE_STRIDE + t];
          const int pos0 = 4 * (w0 + w);
          if (w0 + w < full_words) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              lookup<KIND>(tile, lut_s, slab, (word >> (8 * b)) & 0xffu,
                           pos0 + b, m_bytes, packed);
          } else {
            for (int b = 0; pos0 + b < m_bytes; ++b)
              lookup<KIND>(tile, lut_s, slab, (word >> (8 * b)) & 0xffu,
                           pos0 + b, m_bytes, packed);
          }
          run += packed ? 8 : 4;
          if (run + 8 > FLUSH) { tile.flush(); run = 0; }
        }
      }
      tile.flush();
      __syncthreads();   // the last chunk is consumed: its buffer holds scores
#pragma unroll
      for (int j = 0; j < QT; ++j)
        score_s[j * SUB + t] = live ? tile.score(j, m) : -INFINITY;
      __syncthreads();

      for (int j = warp; j < nq; j += WARPS) {
        const size_t out0 = ((size_t)l * qcap + q0 + j) * width;
        scan::warp_topp<true>(score_s + j * SUB, lane, p, nsub, sb, (int)row0,
                        out_vals + out0, out_idx + out0);
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const void* lut_disp, const void* codes, const int* row_ids,
                   const int* live_n, float* vals, int* idx, int nlist,
                   int qcap, int cap_len, int m, int m_bytes, int packed,
                   int p, cudaStream_t stream) {
  constexpr int ENTRY = Tile<KIND>::ENTRY;
  constexpr size_t BUF = CHUNK_WORDS * CODE_STRIDE * 4 > QT * SUB * 4
                             ? CHUNK_WORDS * CODE_STRIDE * 4 : QT * SUB * 4;
  const size_t smem = (size_t)K * (m * ENTRY + 16) + BUF;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pq_scan_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // sub-block groups per list: enough blocks to fill the card at small
  // nlist, few LUT restagings at large nlist
  const int nsub = cap_len / SUB;
  int groups = (16384 + nlist - 1) / nlist;
  groups = groups < 1 ? 1 : (groups > nsub ? nsub : groups);
  const dim3 grid(groups, nlist);
  pq_scan_kernel<KIND><<<grid, SUB, smem, stream>>>(
      static_cast<const unsigned char*>(lut_disp),
      static_cast<const unsigned char*>(codes), row_ids, live_n, vals, idx,
      qcap, cap_len, m, m_bytes, packed, p);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). lut_dtype: 0 int8, 2 bfloat16.
// Shapes: lut_disp [nlist, qcap, 16*m], codes [nlist, cap_len, m_bytes]
// uint8 (m_bytes = m, or m/2 when packed), row_ids [nlist, cap_len] int32,
// live_n [nlist] int32 or null (all slots live), vals/idx
// [nlist, qcap, (cap_len/128)*p]; all contiguous on one device.
// Returns a cudaError_t (0 on success).
extern "C" int pq_list_scan_launch(int lut_dtype, int packed,
                                   const void* lut_disp, const void* codes,
                                   const int* row_ids, const int* live_n,
                                   float* vals, int* idx, int nlist, int qcap,
                                   int cap_len, int m, int m_bytes, int p,
                                   void* stream) {
  if ((lut_dtype != 0 && lut_dtype != 2) || cap_len % SUB != 0 || nlist <= 0 ||
      nlist > 65535 || qcap <= 0 || p <= 0 || m <= 0 ||
      m_bytes != (packed ? m / 2 : m) || (packed && (m & 1)))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lut_dtype == 2
          ? launch<2>(lut_disp, codes, row_ids, live_n, vals, idx, nlist, qcap,
                      cap_len, m, m_bytes, packed, p, s)
          : launch<0>(lut_disp, codes, row_ids, live_n, vals, idx, nlist, qcap,
                      cap_len, m, m_bytes, packed, p, s);
  return (int)err;
}
