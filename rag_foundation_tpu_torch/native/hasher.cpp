// Native host shim of the port: the feature hasher and the host re-rank.
//
// The port's own copy of the JAX package's host shim, with the same C
// ABI and the same arithmetic, so that a library built from either
// source with the same flags computes the same bits:
//
// - ragtpu_hash_encode / ragtpu_hash_encode_one: chunk featurization
//   (tokenize + word/char-n-gram FNV-1a 64 hashing into sign buckets,
//   then an in-place L2 normalization with a double sum). It runs per
//   chunk at ingest and per query, and is the ingest hot loop; the
//   pure-Python path of models/hash_encoder.py computes the same buckets
//   and differs only in the last float32 ulp of the normalization.
// - ragtpu_rescore: the exact int8 re-rank of the ivf_pq host tier
//   (engine/archive.py HostArchive.rescore).
//
// Built at first use with `g++ -O3 -march=native -fopenmp-simd -shared
// -fPIC -std=c++17` (rag_foundation_tpu_torch/native/__init__.py) and
// loaded through ctypes: a plain C ABI, no binding library.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint64_t FNV_OFFSET = 0xcbf29ce484222325ULL;
constexpr uint64_t FNV_PRIME = 0x100000001b3ULL;

inline uint64_t fnv1a(const char* data, size_t len, uint64_t seed) {
  uint64_t h = FNV_OFFSET ^ seed;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= FNV_PRIME;
  }
  return h;
}

inline void add_feature(const char* data, size_t len, float* row, int dim,
                        uint64_t seed) {
  uint64_t h = fnv1a(data, len, seed);
  int bucket = static_cast<int>(h % static_cast<uint64_t>(dim));
  float sign = (h >> 63) ? 1.0f : -1.0f;
  row[bucket] += sign;
}

}  // namespace

extern "C" {

// Encode one UTF-8 text into `row` (length `dim`, pre-zeroed by caller).
// Tokenization: runs of [a-z0-9] after ASCII lowercasing (non-ASCII bytes
// are treated as separators — matches the Python re [a-z0-9]+ on lower()
// for ASCII content, the dominant case). Features: every token, plus
// char n-grams over the space-joined token stream.
void ragtpu_hash_encode_one(const char* text, long text_len, float* row,
                            int dim, int ngram, uint64_t seed) {
  std::string joined;
  joined.reserve(static_cast<size_t>(text_len));
  size_t i = 0;
  const size_t n = static_cast<size_t>(text_len);
  bool in_token = false;
  size_t tok_start = 0;
  std::string lowered;
  lowered.resize(n);
  for (size_t j = 0; j < n; ++j) {
    char c = text[j];
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    lowered[j] = c;
  }
  for (i = 0; i <= n; ++i) {
    const bool alnum =
        i < n && ((lowered[i] >= 'a' && lowered[i] <= 'z') ||
                  (lowered[i] >= '0' && lowered[i] <= '9'));
    if (alnum && !in_token) {
      in_token = true;
      tok_start = i;
    } else if (!alnum && in_token) {
      in_token = false;
      add_feature(lowered.data() + tok_start, i - tok_start, row, dim, seed);
      if (!joined.empty()) joined.push_back(' ');
      joined.append(lowered, tok_start, i - tok_start);
    }
  }
  if (ngram > 0 && joined.size() >= static_cast<size_t>(ngram)) {
    for (size_t j = 0; j + ngram <= joined.size(); ++j) {
      add_feature(joined.data() + j, static_cast<size_t>(ngram), row, dim,
                  seed);
    }
  }
  // L2 normalize in place
  double sq = 0.0;
  for (int b = 0; b < dim; ++b) sq += static_cast<double>(row[b]) * row[b];
  if (sq > 0.0) {
    const float inv = static_cast<float>(1.0 / __builtin_sqrt(sq));
    for (int b = 0; b < dim; ++b) row[b] *= inv;
  }
}

// Batch entry: texts are concatenated in `blob` with lengths in `lens`.
void ragtpu_hash_encode(const char* blob, const long* lens, int count,
                        float* out, int dim, int ngram, uint64_t seed) {
  const char* cursor = blob;
  for (int t = 0; t < count; ++t) {
    ragtpu_hash_encode_one(cursor, lens[t], out + static_cast<size_t>(t) * dim,
                           dim, ngram, seed);
    cursor += lens[t];
  }
}

// ---------------------------------------------------------------------------
// Exact host re-rank: the host-refine PQ tier's second hot stage.
//
// scores[i, j] = scale * dot(q[i, :], archive[cand[i, j], :])
//
// The numpy path (engine/archive.py HostArchive.rescore) gathers the
// int8 candidate rows and materializes an f32 copy before a batched
// GEMV: 5 bytes of memory traffic per archive byte. Here the int8->f32
// widening happens in registers inside the dot, so traffic is just the
// gathered rows themselves. The f32 reduction is reassociated (omp simd
// pragma), so sums differ from numpy's BLAS order by normal float
// noise: callers rank with argsort, and the tests compare with rtol
// (tests/test_torch_native.py).
//
// Semantics match the numpy path exactly: ids < 0 are pads (-inf); ids
// >= n clip to the last row (defensive, cannot happen).
void ragtpu_rescore(const int8_t* rows, int64_t n, int64_t d,
                    const int64_t* cand, const float* q, int64_t q_n,
                    int64_t c, float scale, float* out) {
  const int64_t last = n > 0 ? n - 1 : 0;
  constexpr int64_t kPrefetch = 8;  // candidate rows of DRAM latency to hide
  for (int64_t i = 0; i < q_n; ++i) {
    const float* qv = q + i * d;
    const int64_t* ci = cand + i * c;
    for (int64_t j = 0; j < c; ++j) {
      // software-prefetch a future candidate's whole row: the gather is
      // DRAM-latency-bound (each candidate is a random ~768 B row; the
      // hardware prefetcher only helps WITHIN a row), so overlapping
      // the next rows' fetches with this row's dot is the actual win;
      // numpy's fancy-index gather pays the full latency serially.
      if (j + kPrefetch < c) {
        int64_t pid = ci[j + kPrefetch];
        if (pid >= 0) {
          if (pid > last) pid = last;
          const char* p = reinterpret_cast<const char*>(rows + pid * d);
          for (int64_t off = 0; off < d; off += 64) {
            __builtin_prefetch(p + off, 0, 0);
          }
        }
      }
      int64_t id = ci[j];
      if (id < 0) {
        out[i * c + j] = -__builtin_inff();
        continue;
      }
      if (id > last) id = last;
      const int8_t* rv = rows + id * d;
      float acc = 0.0f;
#pragma omp simd reduction(+ : acc)
      for (int64_t kk = 0; kk < d; ++kk) {
        acc += qv[kk] * static_cast<float>(rv[kk]);
      }
      out[i * c + j] = acc * scale;
    }
  }
}

}  // extern "C"
