// Native ingest kernels for otters-tpu.
//
// The reference's build-side hot loops are Rust: per-chunk Bloom insertion
// over string bytes (meta_compute.rs:99-116) via fastbloom's hasher. Here the
// equivalents are C++ invoked through ctypes:
//   - bulk stable string hashing (FNV-1a 64 + splitmix64 finalizers, bit-for-
//     bit identical to the Python fallback in ops/hashing.py),
//   - Bloom bit-matrix construction with double hashing (ops/bloom.py
//     contract: h_i = g1 + i * g2 mod bits).
// Rows are chunk-contiguous, so the per-chunk OpenMP parallelism is
// write-conflict-free (each thread owns whole chunks).

#include <cstdint>
#include <cstddef>
#include <cstring>

namespace {

constexpr uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
constexpr uint64_t FNV_PRIME = 0x100000001B3ULL;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline uint64_t fnv1a64(const uint8_t* data, int64_t len) {
  uint64_t h = FNV_OFFSET;
  for (int64_t i = 0; i < len; ++i) {
    h = (h ^ data[i]) * FNV_PRIME;
  }
  return h;
}

}  // namespace

extern "C" {

// offsets has n+1 entries; string i is data[offsets[i]..offsets[i+1]).
void otters_hash_strings(const uint8_t* data, const int64_t* offsets,
                         int64_t n, uint64_t* g1, uint64_t* g2) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t x = fnv1a64(data + offsets[i], offsets[i + 1] - offsets[i]);
    g1[i] = splitmix64(x);
    g2[i] = splitmix64(x ^ 0xA5A5A5A5A5A5A5A5ULL) | 1ULL;
  }
}

// matrix: uint32[n_chunks * words], zero-initialized by the caller.
// chunk_start: int64[n_chunks + 1] row ranges (rows are chunk-contiguous).
void otters_bloom_build(const uint64_t* g1, const uint64_t* g2,
                        const uint8_t* nulls, const int64_t* chunk_start,
                        int64_t n_chunks, int64_t words, int64_t bits,
                        int64_t k, uint32_t* matrix) {
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t c = 0; c < n_chunks; ++c) {
    uint32_t* row = matrix + c * words;
    for (int64_t i = chunk_start[c]; i < chunk_start[c + 1]; ++i) {
      if (nulls[i]) continue;
      uint64_t h1 = g1[i];
      uint64_t h2 = g2[i];
      for (int64_t j = 0; j < k; ++j) {
        uint64_t pos = (h1 + static_cast<uint64_t>(j) * h2) % bits;
        row[pos >> 5] |= (1u << (pos & 31));
      }
    }
  }
}


// Bounded Levenshtein mask (fuzzy string matching, the reference roadmap's
// "fuzzy matching" item). Banded DP: only the |i - j| <= k diagonal band can
// hold values <= k, so each row costs O(2k+1); rows whose length differs
// from the pattern by more than k are rejected outright.
void otters_fuzzy_mask(const uint8_t* data, const int64_t* offsets, int64_t n,
                       const uint8_t* pat, int64_t plen, int64_t k,
                       uint8_t* out) {
  const int64_t BIG = 1 << 30;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = data + offsets[i];
    const int64_t slen = offsets[i + 1] - offsets[i];
    int64_t diff = slen > plen ? slen - plen : plen - slen;
    if (diff > k) {
      out[i] = 0;
      continue;
    }
    // dp over the pattern axis, banded around the main diagonal
    int64_t prev[2 * 16 + 1];
    int64_t cur[2 * 16 + 1];
    int64_t kk = k > 16 ? 16 : k;  // band cap (max_dist clamped Python-side)
    int64_t w = 2 * kk + 1;
    // prev[c] = dist(s[0..r], pat[0..r + c - kk]) for row r
    for (int64_t c = 0; c < w; ++c) {
      int64_t j = 0 + c - kk;
      prev[c] = (j >= 0 && j <= plen) ? (j >= 0 ? j : BIG) : BIG;
    }
    bool alive = true;
    for (int64_t r = 1; r <= slen && alive; ++r) {
      alive = false;
      for (int64_t c = 0; c < w; ++c) {
        int64_t j = r + c - kk;
        if (j < 0 || j > plen) {
          cur[c] = BIG;
          continue;
        }
        int64_t best = BIG;
        if (j > 0) {
          // substitute / match: prev band col for (r-1, j-1) is c
          int64_t d = prev[c];
          if (d < BIG) best = d + (s[r - 1] != pat[j - 1] ? 1 : 0);
          // insert into s (advance j only): cur band col for (r, j-1) is c-1
          if (c > 0 && cur[c - 1] + 1 < best) best = cur[c - 1] + 1;
        } else {
          best = r;  // j == 0: delete everything so far
        }
        // delete from s (advance r only): prev band col for (r-1, j) is c+1
        if (c + 1 < w && prev[c + 1] < BIG && prev[c + 1] + 1 < best)
          best = prev[c + 1] + 1;
        cur[c] = best;
        if (best <= k) alive = true;
      }
      for (int64_t c = 0; c < w; ++c) prev[c] = cur[c];
    }
    // final distance sits at (slen, plen): band col = plen - slen + kk
    int64_t fc = plen - slen + kk;
    int64_t d = (fc >= 0 && fc < w) ? prev[fc] : BIG;
    out[i] = (alive || slen == 0) && d <= k ? 1 : 0;
  }
}

// Extended string predicates over the UTF-8 arena (contains / starts_with /
// ends_with). The reference evaluates string rows in tight Rust loops
// (meta_compute.rs:291-318); this is the equivalent for the host-side
// predicates that cannot run on device. mode: 0=contains, 1=starts_with,
// 2=ends_with. Matches Python str semantics on the SAME UTF-8 bytes: an
// empty pattern matches every (non-null) row; nulls are masked out by the
// caller. Byte-level search is exact for UTF-8 substring/prefix/suffix
// because UTF-8 is self-synchronizing for whole-string patterns.
void otters_substr_mask(const uint8_t* data, const int64_t* offsets,
                        int64_t n, const uint8_t* pat, int64_t plen,
                        int64_t mode, uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = data + offsets[i];
    const int64_t slen = offsets[i + 1] - offsets[i];
    if (plen == 0) {
      out[i] = 1;
      continue;
    }
    if (slen < plen) {
      out[i] = 0;
      continue;
    }
    if (mode == 1) {  // starts_with
      out[i] = std::memcmp(s, pat, static_cast<size_t>(plen)) == 0;
    } else if (mode == 2) {  // ends_with
      out[i] =
          std::memcmp(s + slen - plen, pat, static_cast<size_t>(plen)) == 0;
    } else {  // contains: memchr on the first byte, then memcmp the rest
      const uint8_t first = pat[0];
      const uint8_t* cur = s;
      const uint8_t* end = s + slen - plen + 1;
      uint8_t hit = 0;
      while (cur < end) {
        const uint8_t* c = static_cast<const uint8_t*>(
            std::memchr(cur, first, static_cast<size_t>(end - cur)));
        if (c == nullptr) break;
        if (plen == 1 ||
            std::memcmp(c + 1, pat + 1, static_cast<size_t>(plen - 1)) == 0) {
          hit = 1;
          break;
        }
        cur = c + 1;
      }
      out[i] = hit;
    }
  }
}

}  // extern "C"
