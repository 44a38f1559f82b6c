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
// What the TPU did: it expands the codes to a one-hot [rows, K*m] matrix
// and multiplies it with the LUT on the matrix unit, because a TPU has no
// gather.
//
// Bound on an H100: per batch the kernel must read the live rows' codes
// (m_bytes + 4 id bytes a row) and the live slots' LUTs once and write the
// outputs; it does live slots x live rows x m lookups. At the engine's
// shapes (m = 192, about 8 live slots a list of about 2,400 rows) the
// bytes (0.66 ms at 3.35 TB/s) a little above the lookups at the shared-
// memory rate; at the 100M tier's (packed m = 256, about 1.8 live slots a
// list of about 4,100 rows) the bytes (3.04 ms) well above them. What
// holds a kernel back is issued instructions.
//
// int8 LUTs with m_bytes % 4 == 0, m <= 256 and p <= 32 (the engine's
// tier at m = 192, the 100M capacity tier at packed m = 256) take
// `pq_scan_v2`, a design for Hopper. Its scores wait as int16, which
// rests on the LUT's contract: int8 entries in [-127, 127], as
// `flatten_luts` clips them. A score at m <= 256 then lies in [-32,512,
// 32,512] and never reaches the dead mark -32,768.
// - Only live rows take a lane. A warp owns whole 128-row sub-blocks and
//   compacts their live rows (ballot/popc over row_ids); their scores go
//   back to the rows' own positions of the sub-block, dead positions
//   marked, so the top-p (and which row wins a tie) is unchanged.
// - One pass over the codes for up to 16 live slots: a block of 12 warps
//   stages its list's LUT tile once (8 slots when at most 8 are live); a
//   list with more than 16 takes further passes.
// - Asynchronous staging: each warp streams 32-byte chunks of its live
//   rows' codes through its own two-stage ring with `cp.async` (16 bytes,
//   or 4 when m_bytes % 16 != 0): the next chunk is in flight while it
//   computes the current one, and no block barrier sits on the load path.
//   A warp's first chunk goes in flight before the block stages the LUTs.
// - Tensor cores where they cut instructions: lists with more than 8 live
//   slots (two n-tiles) take the TPU's one-hot product, `mma.sync`
//   m16n8k32 u8 x s8 -> s32. A is the one-hot of 16 rows' codes, k = (code,
//   position) for 8 codes x 4 positions a k-step: one byte permutation
//   (`prmt`) a register, selecting from a table with a 1 at the lane's code
//   by the four codes as nibbles (the nibbles' sign bit selects codes 8-15),
//   so the sum is the score, exact in int32 (packed codes compare bytes
//   instead: 0x80 a match, 128x the score). B is the LUT tile, planes of
//   four positions whose words are the K-major LUT's own, loaded once a
//   word and reused by every 16-row group.
// - Lists with at most 8 live slots take a shared-memory lookup, which
//   issues fewer instructions there: one 8-byte cell of 8 slots' u8
//   entries (biased by +128, transposed to [k][pos][slot]) a (row,
//   position), added in 16-bit lanes (flushed to int32 after every chunk:
//   at most 64 lookups, 255 * 64 < 2^16).
// - Packed m = 256 lists (128 code bytes a row) with at most PAIR_MAX
//   live slots take the pair route instead, two slots a pass: a 128 KB
//   table indexed by code byte holds, for each byte position, the two
//   slots' sums of the byte's two nibble entries, biased by +256, in the
//   16-bit halves of a word. A row is 128 lookups of one shared load and
//   one add each (the 8-slot cell costs a load and eight byte operations a
//   nibble), and the halves never carry: 128 x 510 < 2^16. Lane i scores
//   its own row, reading word (i + k) % 32 of it at step k; the table
//   keeps the words of one (byte value, byte of the word) on the 32 banks,
//   so the lanes' loads never collide, whatever the codes. Each warp
//   streams 32 compacted rows (4 KB) a stage through its two-stage ring.
//   A list takes a pass for every two live slots: timed in turns at the
//   100M tier's dispatch, a limit of 8 beat 4 and 2 in ten pairs of ten
//   (PERF.md), so the 8-slot cells never run there.
// - The scores are integers below 2^15 in magnitude: they wait in shared
//   memory as int16, and the top-p packs score and position into one key
//   (topp_keys.cuh): one warp maximum a pass, four slots interleaved.
// Timed in turns on one card against this choice by live slots, the
// lookup alone lost ten pairs of ten, the one-hot product alone six of six
// (PERF.md).
// bf16 LUTs, m_bytes % 4 != 0, m > 256 and p > 32 take `pq_scan_kernel`: one
// 128-thread block per (list, group of sub-blocks), thread t owns row t, a
// tile of 8 slots' LUTs transposed to [k][pos][slot] so one 8- or 16-byte
// shared load fetches every slot's entry, codes staged word-transposed
// (f32 sums in position order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_s8.cuh"
#include "subblock_topp.cuh"
#include "topp_keys.cuh"

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

// ---- int8 LUT, m_bytes % 4 == 0: compacted rows, one pass, cp.async -------
enum { ROUTE_MMA = 0, ROUTE_LOOKUP = 1 };   // of one pass
constexpr int V2_WARPS = 12;              // most warps a block
constexpr int V2_QT = 16;                 // query slots a pass
constexpr int V2_CHUNK = 32;              // code bytes of a row a stage
constexpr int V2_CROW = V2_CHUNK + 16;    // staged row stride: rows g and
                                          // g + 8 (mma) or 8 rows of 16-byte
                                          // reads (lookup) hit other banks
constexpr int V2_STAGE = SUB * V2_CROW;   // also holds 16 x 128 int16 scores
constexpr int V2_WARP_BYTES = 2 * V2_STAGE + 2 * SUB;   // ring + 2 maps
constexpr short V2_DEAD = -32768;         // the score of a dead row
static_assert(V2_STAGE >= V2_QT * SUB * 2, "scores reuse a stage");

// mma route: the LUT tile as planes of four positions, one a word of the
// K-major LUT, [m/4][16 slots][16 codes + 4 pad]: a lane's B fragments are
// at compile-time offsets from one pointer a plane, and the 32 lanes' loads
// (8 slots x 4 codes) hit 32 banks (slot stride 20 words)
constexpr int MMA_SLOT_WORDS = 20;
constexpr int MMA_PLANE_WORDS = V2_QT * MMA_SLOT_WORDS;

__host__ __device__ inline size_t v2_lut_bytes(int route, int m) {
  if (route == ROUTE_MMA)
    return (size_t)(m / 4) * MMA_PLANE_WORDS * 4;
  return (size_t)K * (m * V2_QT + 16);   // [k][pos][16 slots] + pad
}

// the LUT region of a launch: either route's tile fits
__host__ __device__ inline size_t v2_lut_region(int m) {
  const size_t a = v2_lut_bytes(ROUTE_MMA, m), b = v2_lut_bytes(ROUTE_LOOKUP, m);
  return a > b ? a : b;
}

// The one-hot of 4 unpacked codes (one byte each, < 16) against code c by
// byte permutation: `sel` holds the four codes as the nibbles of its low
// 16 bits, `tab` is the table (x, y) with byte (c & 7) = 1. A nibble below
// 8 selects a byte of the table, one of 8 and above replicates the sign of
// byte (nibble & 7), which is 0: so selecting with sel gives 1 where the
// code is c < 8, and with sel ^ 0x8888 where it is c >= 8.
__device__ __forceinline__ unsigned prmt(unsigned x, unsigned y, unsigned s) {
  unsigned d;   // PTX prmt, default mode: a selector nibble's bit 3 is used
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(s));
  return d;
}

__device__ __forceinline__ unsigned code_nibbles(unsigned w) {
  return __byte_perm(w | (w >> 4), 0u, 0x0020);   // c0 | c1<<4 | c2<<8 | c3<<12
}

// bytes of `w` equal to the matching byte of `pat` -> 0x80, others -> 0
// (bytes < 128): three integer instructions for four one-hot entries
__device__ __forceinline__ unsigned eq_bytes(unsigned w, unsigned pat) {
  const unsigned x = (w ^ pat) | 0x80808080u;
  return ~(x - 0x01010101u) & 0x80808080u;
}

// 16-bit-lane sums of NT*8 biased u8 LUT entries (the lookup route)
template <int NT> struct Lanes {
  unsigned even[2 * NT], odd[2 * NT];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) even[i] = odd[i] = 0;
  }
  __device__ __forceinline__ void add(const unsigned char* e) {
    unsigned v[2 * NT];
    if constexpr (NT == 1) {
      const uint2 x = *reinterpret_cast<const uint2*>(e);
      v[0] = x.x; v[1] = x.y;
    } else {
      const uint4 x = *reinterpret_cast<const uint4*>(e);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      even[i] += __byte_perm(v[i], 0u, 0x4240);   // [b0, 0, b2, 0]
      odd[i] += __byte_perm(v[i], 0u, 0x4341);    // [b1, 0, b3, 0]
    }
  }
  __device__ __forceinline__ void flush(int* acc) {
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      acc[4 * i + 0] += (int)(even[i] & 0xffffu);
      acc[4 * i + 2] += (int)(even[i] >> 16);
      acc[4 * i + 1] += (int)(odd[i] & 0xffffu);
      acc[4 * i + 3] += (int)(odd[i] >> 16);
      even[i] = odd[i] = 0;
    }
  }
};

// mma route, one staged chunk of NG 16-row groups: for each word of four
// positions, the B fragments of the LUT tile, then every group's A
// fragments (one-hot of its codes) and products.
template <int NT, bool PACKED, int NG>
__device__ __forceinline__ void mma_unit(int* acc, const unsigned char* st,
                                         const unsigned* lut_w, int cb0,
                                         int nb, int m_bytes,
                                         const unsigned (&pat)[4], int g,
                                         int tig) {
  constexpr int H = PACKED ? 2 : 1;   // packed: low, then high nibbles
  for (int w = 0; w < nb / 4; ++w) {
    unsigned b[H][2][NT][2];
#pragma unroll
    for (int half = 0; half < H; ++half) {
      const int pw = (cb0 + 4 * w + half * m_bytes) >> 2;   // LUT word
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* bp = lut_w + pw * MMA_PLANE_WORDS +
                               (nt * 8 + g) * MMA_SLOT_WORDS + tig + 8 * h;
          b[half][h][nt][0] = bp[0];
          b[half][h][nt][1] = bp[4];
        }
    }
    unsigned w0[NG], w1[NG];   // rows g and g + 8 of each group
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      w0[grp] = *reinterpret_cast<const unsigned*>(
          st + (grp * 16 + g) * V2_CROW + 4 * w);
      w1[grp] = *reinterpret_cast<const unsigned*>(
          st + (grp * 16 + g + 8) * V2_CROW + 4 * w);
    }
    if constexpr (!PACKED) {
      // tables of this lane's codes tig and 4 + tig (and 8 + ..., 12 + ...)
      const unsigned t0x = 1u << (8 * tig), t0y = 0u;
      const unsigned t1x = 0u, t1y = 1u << (8 * tig);
#pragma unroll
      for (int grp = 0; grp < NG; ++grp) {
        const unsigned s0 = code_nibbles(w0[grp]), s1 = code_nibbles(w1[grp]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned f = h ? 0x8888u : 0u;   // codes 8.. for h = 1
          const unsigned av[4] = {prmt(t0x, t0y, s0 ^ f),
                                  prmt(t0x, t0y, s1 ^ f),
                                  prmt(t1x, t1y, s0 ^ f),
                                  prmt(t1x, t1y, s1 ^ f)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            s8::mma_u8s8(
                *reinterpret_cast<int(*)[4]>(acc + (grp * NT + nt) * 4), av,
                b[0][h][nt][0], b[0][h][nt][1]);
        }
      }
    } else {
      // packed: a word holds 8 codes, low nibbles then high; byte compares
#pragma unroll
      for (int grp = 0; grp < NG; ++grp)
#pragma unroll
        for (int half = 0; half < H; ++half) {
          const unsigned c0 = (half ? w0[grp] >> 4 : w0[grp]) & 0x0f0f0f0fu;
          const unsigned c1 = (half ? w1[grp] >> 4 : w1[grp]) & 0x0f0f0f0fu;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned av[4] = {eq_bytes(c0, pat[2 * h]),
                                    eq_bytes(c1, pat[2 * h]),
                                    eq_bytes(c0, pat[2 * h + 1]),
                                    eq_bytes(c1, pat[2 * h + 1])};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              s8::mma_u8s8(
                  *reinterpret_cast<int(*)[4]>(acc + (grp * NT + nt) * 4),
                  av, b[half][h][nt][0], b[half][h][nt][1]);
          }
        }
    }
  }
}

// lookup route, one staged chunk of NR 32-row passes: a lane scores row
// rp * 32 + lane of each pass, 16 positions a 16-byte load of its codes.
template <int NT, bool PACKED, int NR>
__device__ __forceinline__ void lookup_unit(int* acc, const unsigned char* st,
                                            const unsigned char* lut_s,
                                            int slab, int cell, int cb0,
                                            int nb, int m_bytes, int lane) {
  Lanes<NT> lanes[NR];
#pragma unroll
  for (int rp = 0; rp < NR; ++rp) lanes[rp].zero();
  for (int x = 0; x < nb; x += 16) {
    unsigned words[NR][4];
#pragma unroll
    for (int rp = 0; rp < NR; ++rp) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + (rp * 32 + lane) * V2_CROW + x);
      words[rp][0] = v.x; words[rp][1] = v.y;
      words[rp][2] = v.z; words[rp][3] = v.w;
    }
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      if (x + 4 * wi >= nb) break;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int pos = cb0 + x + 4 * wi + bb;
#pragma unroll
        for (int rp = 0; rp < NR; ++rp) {
          const unsigned code = (words[rp][wi] >> (8 * bb)) & 0xffu;
          lanes[rp].add(lut_s + (code & 15u) * slab + pos * cell);
          if constexpr (PACKED)
            lanes[rp].add(lut_s + (code >> 4) * slab + (m_bytes + pos) * cell);
        }
      }
    }
  }
#pragma unroll
  for (int rp = 0; rp < NR; ++rp)
    lanes[rp].flush(acc + rp * 8 * NT);   // at most 128 lookups a lane
}

struct V2Args {
  const signed char* lut_g;     // this list's LUTs [qcap, 16*m]
  const unsigned char* codes;
  const int* row_ids;
  float* out_vals;
  int* out_idx;
  int l, qcap, cap_len, m, m_bytes, p;
};

// The pair route's compaction and top-p; `v2_pass` keeps the same steps
// as lambdas over values it computes once, since through these helpers
// the m=192 route lost 9 pairs of 10 by 0.1-0.2% (PERF.md).
//
// The live rows of sub-block sb compacted into map (ballot/popc over
// row_ids, in row order), the ballots in bal; with none, the outputs of
// slots [q0, q0 + nq) for sb are (-inf, -1). Returns the live count.
__device__ __forceinline__ int compact_rows(const V2Args& a, int q0, int nq,
                                            int sb, unsigned char* map,
                                            unsigned (&bal)[4], int lane) {
  const int nsub = a.cap_len / SUB, width = nsub * a.p;
  const size_t row0 = (size_t)a.l * a.cap_len + (size_t)sb * SUB;
  bool lv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lv[i] = a.row_ids[row0 + lane + 32 * i] >= 0;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bal[i] = __ballot_sync(0xffffffffu, lv[i]);
    if (lv[i])
      map[n + __popc(bal[i] & ((1u << lane) - 1u))] =
          (unsigned char)(lane + 32 * i);
    n += __popc(bal[i]);
  }
  if (n == 0)
    for (int i = lane; i < nq * a.p; i += 32) {
      const int j = q0 + i / a.p, pass = i % a.p;
      const size_t o = ((size_t)a.l * a.qcap + j) * width +
                       (size_t)pass * nsub + sb;
      a.out_vals[o] = -INFINITY;
      a.out_idx[o] = -1;
    }
  __syncwarp();
  return n;
}

// The first sub-block from sb on, in steps of `stride`, with a live row
// (compacted into map, its count in n), or -1.
__device__ __forceinline__ int next_live(const V2Args& a, int q0, int nq,
                                         int sb, int stride,
                                         unsigned char* map, int& n,
                                         unsigned (&bal)[4], int lane) {
  for (const int nsub = a.cap_len / SUB; sb < nsub; sb += stride)
    if ((n = compact_rows(a, q0, nq, sb, map, bal, lane)) > 0) return sb;
  return -1;
}

// The dead rows of a sub-block marked in slots [0, nq) of sc (slot j at
// sc[j * SUB]).
__device__ __forceinline__ void mark_dead(short* sc, int nq,
                                          const unsigned (&bal)[4],
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (!((bal[i] >> lane) & 1u))
      for (int j = 0; j < nq; ++j) sc[j * SUB + lane + 32 * i] = V2_DEAD;
}

// The top-p of sub-block sb for slots [q0, q0 + nq) from their int16
// scores: one warp maximum a pass (topp_keys.cuh).
__device__ __forceinline__ void topp_out(const V2Args& a, const short* sc,
                                         int q0, int nq, int sb, int lane) {
  const int nsub = a.cap_len / SUB, width = nsub * a.p;
  const size_t o = ((size_t)a.l * a.qcap + q0) * width;
  keys::warp_topp_slots(sc, V2_DEAD, 0, nq, 1, lane, a.p, nsub, sb,
                        (int)((size_t)a.l * a.cap_len + (size_t)sb * SUB),
                        1.0f, a.out_vals + o, a.out_idx + o, width);
}

// One pass over the list for slots [q0, q0 + nq), nq <= 8 * NT.
template <int ROUTE, int NT, bool PACKED>
__device__ __forceinline__ void v2_pass(const V2Args& a, int q0, int nq,
                                        unsigned char* smem, int nw) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m = a.m, m_bytes = a.m_bytes, km = K * a.m;
  const int nsub = a.cap_len / SUB, width = nsub * a.p;
  unsigned char* lut_s = smem;
  unsigned char* wbase =
      smem + v2_lut_region(m) + (size_t)warp * V2_WARP_BYTES;
  unsigned char* maps = wbase + 2 * V2_STAGE;   // [2][SUB] compact -> row
  const int cell = 8 * NT, slab = m * cell + 16;

  // -- this warp's sub-blocks, compacted, through a two-stage ring ----------
  const int wstride = gridDim.x * nw;
  const int nchunks = (m_bytes + V2_CHUNK - 1) / V2_CHUNK;
  const size_t list0 = (size_t)a.l * a.cap_len;

  // the live rows of sub-block sb, compacted into map; with none, the
  // pass's outputs of sb are (-inf, -1). Returns the live count.
  auto prepare = [&](int sb, unsigned char* map, unsigned (&bal)[4]) -> int {
    const size_t row0 = list0 + (size_t)sb * SUB;
    bool lv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = a.row_ids[row0 + lane + 32 * i] >= 0;
    int n = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bal[i] = __ballot_sync(0xffffffffu, lv[i]);
      if (lv[i])
        map[n + __popc(bal[i] & ((1u << lane) - 1u))] =
            (unsigned char)(lane + 32 * i);
      n += __popc(bal[i]);
    }
    if (n == 0)
      for (int i = lane; i < nq * a.p; i += 32) {
        const int j = q0 + i / a.p, pass = i % a.p;
        const size_t o = ((size_t)a.l * a.qcap + j) * width +
                         (size_t)pass * nsub + sb;
        a.out_vals[o] = -INFINITY;
        a.out_idx[o] = -1;
      }
    __syncwarp();
    return n;
  };
  auto advance = [&](int sb, unsigned char* map, int& n,
                     unsigned (&bal)[4]) -> int {
    for (; sb < nsub; sb += wstride)
      if ((n = prepare(sb, map, bal)) > 0) return sb;
    return -1;
  };
  // chunk c of sub-block sb's n live rows into a stage, row r at r*V2_CROW
  auto issue = [&](int sb, int c, unsigned char* st, const unsigned char* map,
                   int n) {
    const unsigned char* src0 =
        a.codes + (list0 + (size_t)sb * SUB) * m_bytes + c * V2_CHUNK;
    const int nb = min(V2_CHUNK, m_bytes - c * V2_CHUNK);
    if ((m_bytes & 15) == 0) {
      const int np = nb / 16;
      if (np == 2) {
        const int j = lane & 1;
        for (int r = lane >> 1; r < n; r += 16)
          s8::cp_async16(st + r * V2_CROW + j * 16,
                         src0 + (size_t)map[r] * m_bytes + j * 16, 16);
      } else {
        for (int i = lane; i < n * np; i += 32) {
          const int r = i / np, j = i - r * np;
          s8::cp_async16(st + r * V2_CROW + j * 16,
                         src0 + (size_t)map[r] * m_bytes + j * 16, 16);
        }
      }
    } else {
      const int np = nb / 4;
      for (int i = lane; i < n * np; i += 32) {
        const int r = i / np, j = i - r * np;
        s8::cp_async4(st + r * V2_CROW + j * 4,
                      src0 + (size_t)map[r] * m_bytes + j * 4, 4);
      }
    }
  };

  // accumulators: mma [row group of 16][n-tile][fragment] (128 x the sum);
  // lookup [32-row pass][slot] (biased sums)
  constexpr int NACC = ROUTE == ROUTE_MMA ? 8 * NT * 4 : 4 * 8 * NT;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  unsigned pat[4];   // mma: code 4q + tig in every byte
#pragma unroll
  for (int q = 0; q < 4; ++q) pat[q] = (unsigned)(4 * q + tig) * 0x01010101u;
  const unsigned* lut_w = reinterpret_cast<const unsigned*>(lut_s);

  unsigned bal[4], bal_next[4];
  int n = 0;
  int sb = advance((int)blockIdx.x * nw + warp, maps, n, bal);
  int c = 0, mp = 0, buf = 0;
  if (sb >= 0) issue(sb, 0, wbase, maps, n);
  s8::cp_async_commit();
  // -- the LUT tile, once a pass (the warps' first chunks already in
  // flight) ---------------------------------------------------------------
  if constexpr (ROUTE == ROUTE_MMA) {
    // words (slot j, code c, positions 4w..4w+3) = the K-major LUT's own
    // words, at plane w, slot j, code c; slots past nq zero-filled
    const int mw = m / 4;
    for (int i = t; i < 8 * NT * K * mw; i += blockDim.x) {
      const int w = i % mw, jc = i / mw, c = jc & (K - 1), j = jc / K;
      const bool ok = j < nq;
      s8::cp_async4(lut_s + ((size_t)w * MMA_PLANE_WORDS +
                             j * MMA_SLOT_WORDS + c) * 4,
                    ok ? (const void*)(a.lut_g + (size_t)(q0 + j) * km +
                                       c * m + 4 * w)
                       : (const void*)a.lut_g,
                    ok ? 4 : 0);
    }
    s8::cp_async_commit();
    s8::cp_async_wait<0>();
  } else {
    // cells [k][pos][8*NT slots] of u8 entries biased by +128. With 8
    // slots the raw LUTs are first copied whole (16-byte cp.async, all in
    // flight) behind the cells and transposed from there
    const unsigned char* raw = nullptr;
    if constexpr (NT == 1) {
      unsigned char* r = lut_s + ((K * slab + 15) & ~15);
      for (int i = t; i < 8 * km / 16; i += blockDim.x) {
        const int j = i / (km / 16), o = (i - j * (km / 16)) * 16;
        const bool ok = j < nq;
        s8::cp_async16(r + j * km + o,
                       ok ? (const void*)(a.lut_g + (size_t)(q0 + j) * km + o)
                          : (const void*)a.lut_g,
                       ok ? 16 : 0);
      }
      s8::cp_async_commit();
      s8::cp_async_wait<0>();
      __syncthreads();
      raw = r;
    }
    for (int e = t; e < km; e += blockDim.x) {
      const int k = e / m, pos = e - k * m;
      unsigned w[2 * NT];
#pragma unroll
      for (int i = 0; i < 2 * NT; ++i) {
        unsigned word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * i + b;
          int v;
          if constexpr (NT == 1)
            v = (signed char)raw[j * km + e];
          else
            v = j < nq ? (int)a.lut_g[(size_t)(q0 + j) * km + e] : 0;
          word |= (unsigned)(v + 128) << (8 * b);
        }
        w[i] = word;
      }
      unsigned char* dst = lut_s + k * slab + pos * cell;
      if constexpr (NT == 1)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();

  while (sb >= 0) {
    // the next unit goes in flight before this one is computed
    int nsb = sb, nc = c + 1, nn = n, nmp = mp;
    if (nc == nchunks) {
      nc = 0;
      nmp = mp ^ 1;
      nsb = advance(sb + wstride, maps + nmp * SUB, nn, bal_next);
    }
    if (nsb >= 0)
      issue(nsb, nc, wbase + (buf ^ 1) * V2_STAGE, maps + nmp * SUB, nn);
    s8::cp_async_commit();
    s8::cp_async_wait<1>();
    __syncwarp();

    const unsigned char* st = wbase + buf * V2_STAGE;
    const unsigned char* map = maps + mp * SUB;
    const int cb0 = c * V2_CHUNK;
    const int nb = min(V2_CHUNK, m_bytes - cb0);
    if constexpr (ROUTE == ROUTE_MMA) {
      // a compile-time count of 16-row groups: no branch between them, so
      // their loads and products interleave
      switch ((n + 15) >> 4) {
#define PQ_MMA_CASE(NG)                                                    \
  case NG:                                                                 \
    mma_unit<NT, PACKED, NG>(acc, st, lut_w, cb0, nb, m_bytes, pat,      \
                             g, tig);                                      \
    break;
        PQ_MMA_CASE(1) PQ_MMA_CASE(2) PQ_MMA_CASE(3) PQ_MMA_CASE(4)
        PQ_MMA_CASE(5) PQ_MMA_CASE(6) PQ_MMA_CASE(7) PQ_MMA_CASE(8)
#undef PQ_MMA_CASE
      }
    } else {
      switch ((n + 31) >> 5) {
#define PQ_LOOKUP_CASE(NR)                                                 \
  case NR:                                                                 \
    lookup_unit<NT, PACKED, NR>(acc, st, lut_s, slab, cell, cb0, nb,       \
                                m_bytes, lane);                            \
    break;
        PQ_LOOKUP_CASE(1) PQ_LOOKUP_CASE(2) PQ_LOOKUP_CASE(3)
        PQ_LOOKUP_CASE(4)
#undef PQ_LOOKUP_CASE
      }
    }

    if (c == nchunks - 1) {
      // the stage just consumed holds the sub-block's scores
      __syncwarp();
      short* sc = reinterpret_cast<short*>(wbase + buf * V2_STAGE);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!((bal[i] >> lane) & 1u))
          for (int j = 0; j < nq; ++j) sc[j * SUB + lane + 32 * i] = V2_DEAD;
      if constexpr (ROUTE == ROUTE_MMA) {
#pragma unroll
        for (int grp = 0; grp < 8; ++grp)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = grp * 16 + g + (e >= 2 ? 8 : 0);
              const int j = nt * 8 + tig * 2 + (e & 1);
              int& v = acc[(grp * NT + nt) * 4 + e];
              if (r < n && j < nq)
                sc[j * SUB + map[r]] = (short)(PACKED ? v >> 7 : v);
              v = 0;
            }
      } else {
#pragma unroll
        for (int rp = 0; rp < 4; ++rp) {
          const int r = rp * 32 + lane;
#pragma unroll
          for (int j = 0; j < 8 * NT; ++j) {
            int& v = acc[rp * 8 * NT + j];
            if (r < n && j < nq)
              sc[j * SUB + map[r]] = (short)(v - 128 * m);
            v = 0;
          }
        }
      }
      __syncwarp();
      // the scores are integers: one warp maximum a pass (topp_keys.cuh)
      keys::warp_topp_slots(sc, V2_DEAD, 0, nq, 1, lane, a.p, nsub, sb,
                            (int)(list0 + (size_t)sb * SUB), 1.0f,
                            a.out_vals + ((size_t)a.l * a.qcap + q0) * width,
                            a.out_idx + ((size_t)a.l * a.qcap + q0) * width,
                            width);
#pragma unroll
      for (int i = 0; i < 4; ++i) bal[i] = bal_next[i];
    }
    __syncwarp();
    sb = nsb; c = nc; n = nn; mp = nmp; buf ^= 1;
  }
  s8::cp_async_wait<0>();
}

// ---- packed m = 256, at most PAIR_MAX live slots: a table by code byte ----
constexpr int PAIR_BYTES = 128;              // code bytes a row (m = 256)
constexpr int PAIR_MAX = 8;                  // most live slots of a list
constexpr int PAIR_STAGE = 32 * PAIR_BYTES;  // 32 compacted rows, one a lane
constexpr int PAIR_WARP_BYTES = 2 * PAIR_STAGE + 2 * SUB;   // ring + 2 maps
constexpr int PAIR_HALF = 256 * 256;         // bytes i = 0, 1 | 2, 3 of a word
constexpr size_t PAIR_TABLE = 2 * PAIR_HALF; // 128 KB
constexpr int PAIR_BIAS = 256 * PAIR_BYTES;  // of a 16-bit lane's sum
static_assert(PAIR_STAGE >= 2 * SUB * 2, "two slots' scores reuse a stage");
static_assert(510 * PAIR_BYTES < 65536, "the 16-bit lanes never carry");

// The table of slots q0 and q0 + 1 (nq = 1: the high halves 0): for code
// byte b at byte position pos = 4w + i, the word
//   (lut[q0][lo*m + pos] + 128) + (lut[q0][hi*m + PAIR_BYTES + pos] + 128)
//   | (the same of slot q0 + 1) << 16,            lo = b & 15, hi = b >> 4,
// at byte (i >> 1) * PAIR_HALF + b * 256 + (i & 1) * 128 + 4w: the 32
// words w of one (b, i) lie on the 32 banks. A thread builds the 32 words
// of one (w, i) and two values of hi, consecutive lanes on consecutive w.
__device__ __forceinline__ void pair_table(const V2Args& a, int q0, int nq,
                                           unsigned char* table) {
  const int m = a.m, km = K * m;
  const signed char* l0 = a.lut_g + (size_t)q0 * km;
  const signed char* l1 = l0 + km;
  auto entry = [&](int e) -> unsigned {
    const unsigned v0 = (unsigned)((int)__ldg(l0 + e) + 128);
    return nq > 1 ? v0 | (unsigned)((int)__ldg(l1 + e) + 128) << 16 : v0;
  };
  for (int task = threadIdx.x; task < 8 * PAIR_BYTES; task += blockDim.x) {
    const int w = task & 31, i = (task >> 5) & 3, hq = task >> 7;
    const int pos = 4 * w + i;
    unsigned lo[K];
#pragma unroll
    for (int k = 0; k < K; ++k) lo[k] = entry(k * m + pos);
    unsigned* dst = reinterpret_cast<unsigned*>(
        table + (i >> 1) * PAIR_HALF + (i & 1) * 128 + 4 * w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hi = 2 * hq + h;
      const unsigned hv = entry(hi * m + PAIR_BYTES + pos);
#pragma unroll
      for (int k = 0; k < K; ++k) dst[(hi * K + k) * 64] = lo[k] + hv;
    }
  }
}

// One lane's row (128 code bytes at `row`) against the table: at step k
// the lane's word w = (lane + k) % 32, so the lanes' loads of the staged
// codes and of the table fall on 32 banks. Returns the two slots' sums,
// each biased by PAIR_BIAS, in the 16-bit halves.
__device__ __forceinline__ unsigned pair_row(const unsigned char* row,
                                             const unsigned char* table,
                                             int lane) {
  unsigned acc0 = 0, acc1 = 0;   // each at most 64 x 510 a half
#pragma unroll
  for (int k = 0; k < PAIR_BYTES / 4; ++k) {
    const unsigned wb = (unsigned)((lane + k) & 31) * 4;
    const unsigned word = *reinterpret_cast<const unsigned*>(row + wb);
    // (byte i of word) << 8 | wb: the entry's offset in its half
    acc0 += *reinterpret_cast<const unsigned*>(
        table + __byte_perm(word, wb, 0x5504));
    acc1 += *reinterpret_cast<const unsigned*>(
        table + 128 + __byte_perm(word, wb, 0x5514));
    acc0 += *reinterpret_cast<const unsigned*>(
        table + PAIR_HALF + __byte_perm(word, wb, 0x5524));
    acc1 += *reinterpret_cast<const unsigned*>(
        table + PAIR_HALF + 128 + __byte_perm(word, wb, 0x5534));
  }
  return acc0 + acc1;
}

// One pass over the list for slots q0 and, with nq = 2, q0 + 1: the table,
// then each warp's sub-blocks, 32 compacted rows a stage.
__device__ __forceinline__ void pair_pass(const V2Args& a, int q0, int nq,
                                          unsigned char* smem, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* table = smem;
  unsigned char* wbase = smem + PAIR_TABLE + (size_t)warp * PAIR_WARP_BYTES;
  unsigned char* maps = wbase + 2 * PAIR_STAGE;   // [2][SUB] compact -> row
  const int wstride = gridDim.x * nw;
  const unsigned char* codes =
      a.codes + (size_t)a.l * a.cap_len * PAIR_BYTES;
  // compacted rows [32u, 32u + 32) of sub-block sb into a stage, row r at
  // r * PAIR_BYTES: 16 bytes a cp.async, 8 lanes a row
  auto issue = [&](int sb, int u, unsigned char* st, const unsigned char* map,
                   int n) {
    const unsigned char* src = codes + (size_t)sb * SUB * PAIR_BYTES;
    const int rows = min(32, n - 32 * u);
    for (int i = lane; i < 8 * rows; i += 32) {
      const int r = i >> 3, j = (i & 7) * 16;
      s8::cp_async16(st + r * PAIR_BYTES + j,
                     src + (size_t)map[32 * u + r] * PAIR_BYTES + j, 16);
    }
  };

  unsigned bal[4], bal_next[4];
  int n = 0, mp = 0, buf = 0;
  int sb = next_live(a, q0, nq, (int)blockIdx.x * nw + warp, wstride, maps,
                     n, bal, lane);
  if (sb >= 0) issue(sb, 0, wbase, maps, n);
  s8::cp_async_commit();
  pair_table(a, q0, nq, smem);   // the warps' first stages in flight
  __syncthreads();

  while (sb >= 0) {
    const unsigned char* map = maps + mp * SUB;
    const int nu = (n + 31) >> 5;
    unsigned acc[4] = {0u, 0u, 0u, 0u};   // rows 32u + lane
    int nsb = sb, nn = n;
    for (int u = 0; u < nu; ++u) {
      // the next stage (this sub-block's or the next one's) in flight first
      unsigned char* next = wbase + (buf ^ 1) * PAIR_STAGE;
      if (u + 1 < nu) {
        issue(sb, u + 1, next, map, n);
      } else {
        nsb = next_live(a, q0, nq, sb + wstride, wstride,
                        maps + (mp ^ 1) * SUB, nn, bal_next, lane);
        if (nsb >= 0) issue(nsb, 0, next, maps + (mp ^ 1) * SUB, nn);
      }
      s8::cp_async_commit();
      s8::cp_async_wait<1>();
      __syncwarp();
      const unsigned v = pair_row(wbase + buf * PAIR_STAGE + lane * PAIR_BYTES,
                                  table, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = i == u ? v : acc[i];
      __syncwarp();
      buf ^= 1;
    }
    // the stage consumed last holds the sub-block's scores
    short* sc = reinterpret_cast<short*>(wbase + (buf ^ 1) * PAIR_STAGE);
    mark_dead(sc, nq, bal, lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 32 * u + lane;
      if (r < n) {
        sc[map[r]] = (short)((int)(acc[u] & 0xffffu) - PAIR_BIAS);
        if (nq > 1) sc[SUB + map[r]] = (short)((int)(acc[u] >> 16) - PAIR_BIAS);
      }
    }
    __syncwarp();
    topp_out(a, sc, q0, nq, sb, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) bal[i] = bal_next[i];
    __syncwarp();
    sb = nsb; n = nn; mp ^= 1;
  }
  s8::cp_async_wait<0>();
}

template <bool PACKED>
__global__ void __launch_bounds__(V2_WARPS * 32, 1)
pq_scan_v2(const signed char* __restrict__ lut_disp,
           const unsigned char* __restrict__ codes,
           const int* __restrict__ row_ids, const int* __restrict__ live_n,
           float* __restrict__ out_vals, int* __restrict__ out_idx, int qcap,
           int cap_len, int m, int m_bytes, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.y;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsub = cap_len / SUB, width = nsub * p;
  const int nlive = live_n == nullptr ? qcap : min(qcap, live_n[l]);
  // dead tail of the dispatch: (-inf, -1), nothing read
  if (nlive < qcap)
    for (int sb = blockIdx.x * nw + warp; sb < nsub; sb += gridDim.x * nw)
      for (int i = lane; i < (qcap - nlive) * p; i += 32) {
        const int j = nlive + i / p, pass = i % p;
        const size_t o = ((size_t)l * qcap + j) * width + (size_t)pass * nsub + sb;
        out_vals[o] = -INFINITY;
        out_idx[o] = -1;
      }
  if (nlive == 0) return;
  const V2Args a{lut_disp + (size_t)l * qcap * K * m, codes, row_ids,
                 out_vals, out_idx, l, qcap, cap_len, m, m_bytes, p};
  if constexpr (PACKED) {
    // packed m = 256 with few live slots: the table by code byte, two
    // slots a pass
    if (m_bytes == PAIR_BYTES && nlive <= PAIR_MAX) {
      for (int q0 = 0; q0 < nlive; q0 += 2) {
        __syncthreads();   // the previous pass is done with the table
        pair_pass(a, q0, min(2, nlive - q0), smem, nw);
      }
      return;
    }
  }
  for (int q0 = 0; q0 < nlive; q0 += V2_QT) {
    const int nq = min(V2_QT, nlive - q0);
    __syncthreads();   // the previous pass is done with the LUT tile
    // by slots: the lookup for one n-tile of 8 slots, where it issues
    // fewer instructions, the one-hot product for two
    if (nq <= 8)
      v2_pass<ROUTE_LOOKUP, 1, PACKED>(a, q0, nq, smem, nw);
    else
      v2_pass<ROUTE_MMA, 2, PACKED>(a, q0, nq, smem, nw);
  }
}

// The shapes `pq_scan_v2` takes: int8 LUTs, whole code words, int16
// scores (m <= 256 with entries in [-127, 127]), a lane keeping each
// pass's winner (p <= 32). Its LUT tile and one warp's buffers fit shared
// memory at every such m.
constexpr int V2_MAX_M = 256;
bool v2_takes(int lut_dtype, int m, int m_bytes, int p) {
  return lut_dtype == 0 && (m_bytes & 3) == 0 && m <= V2_MAX_M && p <= 32;
}

// Launches the compacted kernel: as many warps a block (at most 12) as
// shared memory holds beside the LUT tile, or beside the pair route's
// table where that route may run (packed m = 256).
cudaError_t launch_v2(const void* lut_disp, const void* codes,
                      const int* row_ids, const int* live_n, float* vals,
                      int* idx, int nlist, int qcap, int cap_len, int m,
                      int m_bytes, int packed, int p, cudaStream_t stream) {
  const size_t limit = 227 * 1024;
  const size_t lut = v2_lut_region(m);
  const bool pair = packed && m_bytes == PAIR_BYTES;
  const int nsub = cap_len / SUB;
  int nw = (int)((limit - lut) / V2_WARP_BYTES);
  const int nw_pair = (int)((limit - PAIR_TABLE) / PAIR_WARP_BYTES);
  if (pair && nw_pair < nw) nw = nw_pair;
  nw = nw > V2_WARPS ? V2_WARPS : nw;
  nw = nw > nsub ? nsub : nw;
  size_t smem = lut + (size_t)nw * V2_WARP_BYTES;
  const size_t smem_pair = PAIR_TABLE + (size_t)nw * PAIR_WARP_BYTES;
  if (pair && smem_pair > smem) smem = smem_pair;
  if (nw < 1 || smem > limit) return cudaErrorInvalidValue;
  // blocks a list: one at the engine's nlist, more at small nlist
  int groups = (132 + nlist - 1) / nlist;
  const int most = (nsub + nw - 1) / nw;
  groups = groups > most ? most : groups;
  const dim3 grid(groups, nlist);
  const auto* lut8 = static_cast<const signed char*>(lut_disp);
  const auto* c8 = static_cast<const unsigned char*>(codes);
  auto kernel = packed ? pq_scan_v2<true> : pq_scan_v2<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nw * 32, smem, stream>>>(lut8, c8, row_ids, live_n, vals, idx,
                                          qcap, cap_len, m, m_bytes, p);
  return cudaGetLastError();
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
// [nlist, qcap, (cap_len/128)*p]; all contiguous on one device. int8 LUT
// entries must lie in [-127, 127] (`flatten_luts` clips them there): the
// int16 scores of `pq_scan_v2` rest on it. Routes: `pq_scan_v2` for int8
// LUTs with m_bytes % 4 == 0, m <= 256 and p <= 32 (inside it, the pair
// route for packed m = 256 lists of at most 8 live slots, the lookup for
// passes of at most 8, the one-hot product beyond); `pq_scan_kernel` for
// the rest. Returns a cudaError_t (0 on success).
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
  // the route follows from the shape alone; pq_scan_v2 picks its own
  // inside each block from the list's live slots
  if (v2_takes(lut_dtype, m, m_bytes, p))
    return (int)launch_v2(lut_disp, codes, row_ids, live_n, vals, idx, nlist,
                          qcap, cap_len, m, m_bytes, packed, p, s);
  const cudaError_t err =
      lut_dtype == 2
          ? launch<2>(lut_disp, codes, row_ids, live_n, vals, idx, nlist, qcap,
                      cap_len, m, m_bytes, packed, p, s)
          : launch<0>(lut_disp, codes, row_ids, live_n, vals, idx, nlist, qcap,
                      cap_len, m, m_bytes, packed, p, s);
  return (int)err;
}
