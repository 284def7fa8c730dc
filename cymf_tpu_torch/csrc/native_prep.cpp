// Native host-side epoch prep of the PyTorch port: the port's own copy of
// the JAX package's C++ OpenMP pipeline (cymf_tpu/native/_native.cpp).
//
// The compute bodies are that file's: the per-step mt19937_64 streams
// seeded through SplitMix64, the counting sorts, the one-bit filter probe
// with its exact per-user fallback, and the bad_range reductions.  They are
// what make the streams the JAX package's.  The item-side counting sorts
// of the BPR and RelMF entries are the helper sort_side, which the
// once-a-fit static entries at the end (the port's own: the JAX package
// sorts those streams with numpy) share; their outputs equal numpy's bit
// for bit.  The CPython layer is gone: every entry point is an extern "C"
// function over raw pointers that writes into buffers its caller
// allocated, so the library needs no Python headers and loads with ctypes
// (cymf_tpu_torch/native/__init__.py, which also checks every length and
// range before it calls in).  Each
// returns 0, or 1 where the JAX code raises "indptr not nondecreasing".
// The OpenMP regions run cymf_prep_threads() threads; the streams do not
// depend on that count (each step seeds its own generator and writes only
// its own slice).
//
// Build: g++ -O3 -std=c++17 -fopenmp -fPIC -shared (done at first use by
// cymf_tpu_torch.native).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

int g_threads = 0;  // 0: the OpenMP runtime's default

int nthreads() {
#ifdef _OPENMP
  return g_threads > 0 ? g_threads : omp_get_max_threads();
#else
  return 1;
#endif
}

inline uint64_t splitmix64(uint64_t z) {
  z += 0x9e3779b97f4a7c15ULL;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// 128-aligned window starts over one step's counting-sort prefix sums;
// windows whose chunk grid would overrun B re-anchor so it ends exactly
// at B (sorted_accum.window_ranges(align=128))
void windows(const int64_t* counts, int64_t wrows, int64_t rows, int64_t nw,
             int64_t Bn, int64_t tile, int32_t* ws) {
  for (int64_t w = 0; w < nw; ++w) {
    const int64_t lo = counts[w * wrows];
    const int64_t hi = (w + 1) * wrows <= rows ? counts[(w + 1) * wrows] : Bn;
    int64_t astart = (lo / 128) * 128;
    const int64_t nch = (hi - astart + tile - 1) / tile;
    if (astart + nch * tile > Bn) {
      int64_t need = (Bn - lo + tile - 1) / tile;
      if (nch > need) need = nch;
      astart = Bn - need * tile;
    }
    ws[w] = static_cast<int32_t>(astart);
    ws[nw + w] = static_cast<int32_t>(hi - astart);
  }
}

// An id's row: id / slots, without the division on the logical layout
inline int64_t row_of(int32_t id, int64_t slots) {
  return slots == 1 ? id : id / slots;
}

// counts[k] = the ids of one step whose row is below k, for k <= rows;
// every row at or past `rows` shares the one bucket past them
// (counts[rows + 1] = B).  False on a negative id.
bool count_rows(const int32_t* v, int64_t B, int64_t slots, int64_t rows,
                int64_t* counts) {
  std::fill(counts, counts + rows + 2, 0);
  for (int64_t b = 0; b < B; ++b) {
    if (v[b] < 0) return false;
    ++counts[std::min(row_of(v[b], slots), rows) + 1];
  }
  for (int64_t r = 0; r <= rows; ++r) counts[r + 1] += counts[r];
  return true;
}

// One step's sorted side: a stable counting sort of its B ids by row
// (id / slots) into perm (positions) and srows (rows), and the windows
// over the sorted rows.  Rows at or past `rows` sort last, by row and then
// by position, as a stable argsort puts them.  counts: rows + 2 scratch.
// False (nothing written) on a negative id.
bool sort_side(const int32_t* v, int64_t B, int64_t slots, int64_t rows,
               int64_t wrows, int64_t tile, int64_t Bn, int64_t* counts,
               int32_t* perm, int32_t* srows, int32_t* win) {
  if (!count_rows(v, B, slots, rows, counts)) return false;
  windows(counts, wrows, rows, rows / wrows, Bn, tile, win);
  const int64_t tail = counts[rows];
  for (int64_t b = 0; b < B; ++b) {
    const int64_t r = row_of(v[b], slots);
    const int64_t pos = counts[std::min(r, rows)]++;
    perm[pos] = static_cast<int32_t>(b);
    srows[pos] = static_cast<int32_t>(r);
  }
  if (tail < B) {
    std::stable_sort(perm + tail, perm + B, [&](int32_t a, int32_t b) {
      return row_of(v[a], slots) < row_of(v[b], slots);
    });
    for (int64_t pos = tail; pos < B; ++pos)
      srows[pos] = static_cast<int32_t>(row_of(v[perm[pos]], slots));
  }
  return true;
}

struct Cooc {
  std::unordered_map<int64_t, double> acc;
};

}  // namespace

extern "C" {

// Sets the thread count of every later call (0: the runtime's default) and
// returns the count those calls will use.
int cymf_prep_threads(int n) {
  if (n >= 0) g_threads = n;
  return nthreads();
}

// Left-window 1/distance co-occurrence accumulation; keys are
// center + context * vocab_size.  Returns an opaque map and its size in
// *nnz; cymf_cooccurrence_take copies it out (in the map's order) and
// frees it.
void* cymf_cooccurrence(const int64_t* flat, const int64_t* lens,
                        int64_t num_lines, int64_t vocab_size,
                        int64_t window_size, int64_t* nnz) {
  Cooc* c = new Cooc;
  auto& acc = c->acc;
  acc.reserve(1 << 20);
  int64_t offset = 0;
  for (int64_t line = 0; line < num_lines; ++line) {
    const int64_t n = lens[line];
    const int64_t* ids = flat + offset;
    for (int64_t j = 0; j < n; ++j) {
      const int64_t lo = j - window_size > 0 ? j - window_size : 0;
      for (int64_t k = lo; k < j; ++k) {
        // left window only, 1/distance weighting
        acc[ids[j] + ids[k] * vocab_size] += 1.0 / static_cast<double>(j - k);
      }
    }
    offset += n;
  }
  *nnz = static_cast<int64_t>(acc.size());
  return c;
}

void cymf_cooccurrence_take(void* handle, int64_t* keys, double* vals) {
  Cooc* c = static_cast<Cooc*>(handle);
  int64_t idx = 0;
  for (const auto& kv : c->acc) {
    keys[idx] = kv.first;
    vals[idx] = kv.second;
    ++idx;
  }
  delete c;
}

// Per-epoch BPR host prep: negative draws, positive-set rejection (binary
// search over all keys), j-side counting sort by physical row and window
// ranges, OpenMP over steps.  Outputs j2, mask (f32), sj, rowsj: S*B each;
// winj: S*2*(rh/wrows).
int cymf_bpr_prep_epoch_v2(const int32_t* u2, const int64_t* pos_keys,
                           int64_t nkeys, int64_t S, int64_t B, int64_t U,
                           int64_t I, int64_t slots, int64_t rh,
                           int64_t wrows, int64_t tile, int64_t seed,
                           int32_t* j2, float* mask, int32_t* sj,
                           int32_t* rowsj, int32_t* winj) {
  const int64_t nw = rh / wrows;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads())
#endif
  {
    std::vector<int64_t> counts(rh + 2);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t t = 0; t < S; ++t) {
      const int32_t* u = u2 + t * B;
      int32_t* j = j2 + t * B;
      float* mf = mask + t * B;
      // SplitMix64-scrambled per-step seed -> mt19937_64
      uint64_t z = static_cast<uint64_t>(seed) + 0x9e3779b97f4a7c15ULL *
                   (static_cast<uint64_t>(t) + 1);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      std::mt19937_64 gen(z ^ (z >> 31));
      std::uniform_int_distribution<int64_t> dist(0, I - 1);
      for (int64_t b = 0; b < B; ++b) {
        const int64_t draw = dist(gen);
        j[b] = static_cast<int32_t>(draw);
        bool live = static_cast<int64_t>(u[b]) < U;
        if (live && nkeys > 0) {
          const int64_t key = static_cast<int64_t>(u[b]) * I + draw;
          const int64_t* lo =
              std::lower_bound(pos_keys, pos_keys + nkeys, key);
          if (lo != pos_keys + nkeys && *lo == key) live = false;
        }
        mf[b] = live ? 1.0f : 0.0f;
      }
      // counting sort of j by physical row (draws are never negative)
      sort_side(j, B, slots, rh, wrows, tile, B, counts.data(), sj + t * B,
                rowsj + t * B, winj + t * 2 * nw);
    }
  }
  return 0;
}

// mask[b] = 1 iff u[b] < U and (u[b], j[b]) is not in pos_keys: the
// rejection half of pool-mode prep (binary search over all keys).
int cymf_pool_reject(const int32_t* u, const int32_t* j,
                     const int64_t* pos_keys, int64_t nkeys, int64_t n,
                     int64_t U, int64_t I, float* mask) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads()) schedule(static)
#endif
  for (int64_t b = 0; b < n; ++b) {
    bool live = static_cast<int64_t>(u[b]) < U;
    if (live && nkeys > 0) {
      const int64_t key = static_cast<int64_t>(u[b]) * I + j[b];
      const int64_t* lo = std::lower_bound(pos_keys, pos_keys + nkeys, key);
      if (lo != pos_keys + nkeys && *lo == key) live = false;
    }
    mask[b] = live ? 1.0f : 0.0f;
  }
  return 0;
}

// Rejection via per-user key ranges: indptr (int64[U+1]) bounds each
// user's slice of the sorted keys, so each test searches ~1 KB.
int cymf_pool_reject_v2(const int32_t* u, const int32_t* j,
                        const int64_t* pos_keys, int64_t nkeys,
                        const int64_t* indptr, int64_t n, int64_t U,
                        int64_t I, float* mask) {
  bool bad_range = false;
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads()) schedule(static) \
    reduction(||: bad_range)
#endif
  for (int64_t b = 0; b < n; ++b) {
    const int64_t ub = static_cast<int64_t>(u[b]);
    bool live = ub < U;
    if (ub < 0) {
      bad_range = true;
      live = false;
    }
    if (live) {
      const int64_t lo = indptr[ub], hi = indptr[ub + 1];
      if (lo < 0 || hi < lo || hi > nkeys) {
        bad_range = true;
      } else {
        const int64_t key = ub * I + j[b];
        live = !std::binary_search(pos_keys + lo, pos_keys + hi, key);
      }
    }
    mask[b] = live ? 1.0f : 0.0f;
  }
  return bad_range ? 1 : 0;
}

// One-bit-per-hash membership filter over the sorted positive keys
// (2^log2_bits bits, (2^log2_bits)/64 words), built once per fit.
int cymf_build_key_filter(const int64_t* keys, int64_t nkeys,
                          int64_t log2_bits, uint64_t* bits) {
  const int64_t nwords = (1LL << log2_bits) / 64;
  const int shift = 64 - static_cast<int>(log2_bits);
  std::fill(bits, bits + nwords, 0ULL);
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads()) schedule(static)
#endif
  for (int64_t k = 0; k < nkeys; ++k) {
    const uint64_t h = splitmix64(static_cast<uint64_t>(keys[k])) >> shift;
    __atomic_fetch_or(&bits[h >> 6], 1ULL << (h & 63), __ATOMIC_RELAXED);
  }
  return 0;
}

// Filter-accelerated rejection: the filter probe first (prefetched 64
// lookups ahead), the exact per-user search only on set bits, so the mask
// equals the numpy searchsorted path's bit for bit.
int cymf_pool_reject_v3(const int32_t* u, const int32_t* j,
                        const int64_t* pos_keys, int64_t nkeys,
                        const int64_t* indptr, const uint64_t* bits,
                        int64_t n, int64_t U, int64_t I, int64_t log2_bits,
                        float* mask) {
  const int shift = 64 - static_cast<int>(log2_bits);
  bool bad_range = false;
  constexpr int64_t kAhead = 64;
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads()) schedule(static) \
    reduction(||: bad_range)
#endif
  for (int64_t blk = 0; blk < (n + 4095) / 4096; ++blk) {
    const int64_t lo_b = blk * 4096;
    const int64_t hi_b = std::min(lo_b + 4096, n);
    for (int64_t b = lo_b; b < hi_b; ++b) {
      if (b + kAhead < hi_b) {
        const int64_t ua = static_cast<int64_t>(u[b + kAhead]);
        if (ua < U) {
          const uint64_t ha = splitmix64(
              static_cast<uint64_t>(ua * I + j[b + kAhead])) >> shift;
          __builtin_prefetch(&bits[ha >> 6], 0, 0);
        }
      }
      const int64_t ub = static_cast<int64_t>(u[b]);
      bool live = ub < U;
      if (ub < 0) {
        bad_range = true;
        live = false;
      }
      if (live) {
        const int64_t key = ub * I + j[b];
        const uint64_t h = splitmix64(static_cast<uint64_t>(key)) >> shift;
        if (bits[h >> 6] & (1ULL << (h & 63))) {
          const int64_t lo = indptr[ub], hi = indptr[ub + 1];
          if (lo < 0 || hi < lo || hi > nkeys) {
            bad_range = true;
          } else {
            live = !std::binary_search(pos_keys + lo, pos_keys + hi, key);
          }
        }
      }
      mask[b] = live ? 1.0f : 0.0f;
    }
  }
  return bad_range ? 1 : 0;
}

// v2 with filter-accelerated rejection: the same per-step streams and
// outputs bit-identical to cymf_bpr_prep_epoch_v2 (all draws first, in the
// same order; only the membership test changes).
int cymf_bpr_prep_epoch_v3(const int32_t* u2, const int64_t* pos_keys,
                           int64_t nkeys, const int64_t* indptr,
                           const uint64_t* bits, int64_t S, int64_t B,
                           int64_t U, int64_t I, int64_t slots, int64_t rh,
                           int64_t wrows, int64_t tile, int64_t seed,
                           int64_t log2_bits, int32_t* j2, float* mask,
                           int32_t* sj, int32_t* rowsj, int32_t* winj) {
  const int shift = 64 - static_cast<int>(log2_bits);
  const int64_t nw = rh / wrows;
  bool bad_range = false;
  constexpr int64_t kAhead = 64;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads()) reduction(||: bad_range)
#endif
  {
    std::vector<int64_t> counts(rh + 2);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t t = 0; t < S; ++t) {
      const int32_t* u = u2 + t * B;
      int32_t* j = j2 + t * B;
      float* mf = mask + t * B;
      uint64_t z = static_cast<uint64_t>(seed) + 0x9e3779b97f4a7c15ULL *
                   (static_cast<uint64_t>(t) + 1);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      std::mt19937_64 gen(z ^ (z >> 31));
      std::uniform_int_distribution<int64_t> dist(0, I - 1);
      // pass 1: draws only (same stream order as v2)
      for (int64_t b = 0; b < B; ++b) {
        j[b] = static_cast<int32_t>(dist(gen));
      }
      // pass 2: rejection with filter probes prefetched ahead
      for (int64_t b = 0; b < B; ++b) {
        if (b + kAhead < B) {
          const int64_t ua = static_cast<int64_t>(u[b + kAhead]);
          if (ua < U) {
            const uint64_t ha = splitmix64(
                static_cast<uint64_t>(ua * I + j[b + kAhead])) >> shift;
            __builtin_prefetch(&bits[ha >> 6], 0, 0);
          }
        }
        const int64_t ub = static_cast<int64_t>(u[b]);
        bool live = ub < U;
        if (ub < 0) {
          bad_range = true;
          live = false;
        }
        if (live && nkeys > 0) {
          const int64_t key = ub * I + j[b];
          const uint64_t h = splitmix64(static_cast<uint64_t>(key)) >> shift;
          if (bits[h >> 6] & (1ULL << (h & 63))) {
            const int64_t lo = indptr[ub], hi = indptr[ub + 1];
            if (lo < 0 || hi < lo || hi > nkeys) {
              bad_range = true;
            } else {
              live = !std::binary_search(pos_keys + lo, pos_keys + hi, key);
            }
          }
        }
        mf[b] = live ? 1.0f : 0.0f;
      }
      // counting sort of j by physical row (identical to v2)
      sort_side(j, B, slots, rh, wrows, tile, B, counts.data(), sj + t * B,
                rowsj + t * B, winj + t * 2 * nw);
    }
  }
  return bad_range ? 1 : 0;
}

// Per-epoch RelMF prep: draw S*B uniform (u, i) cells, label each by
// membership in the sorted positive keys (filter probe + exact per-user
// search), counting-sort each step by the user's packed row (W windows),
// then the item side over the u-sorted stream (H windows, logical rows).
// Outputs u2, i2, sorted permutation si and rowsi: S*B int32; lab: S*B
// uint8; winw: S*2*(rw/wrows_w); wini: S*2*(rh/wrows_h).
int cymf_relmf_prep_epoch(const int64_t* pos_keys, int64_t nkeys,
                          const int64_t* indptr, const uint64_t* bits,
                          int64_t S, int64_t B, int64_t U, int64_t I,
                          int64_t slots, int64_t rw, int64_t rh,
                          int64_t wrows_w, int64_t wrows_h, int64_t tile,
                          int64_t seed, int64_t log2_bits, int32_t* u2,
                          int32_t* i2, uint8_t* lab, int32_t* winw,
                          int32_t* si, int32_t* rowsi, int32_t* wini) {
  const int shift = 64 - static_cast<int>(log2_bits);
  const int64_t nww = rw / wrows_w;
  const int64_t nwh = rh / wrows_h;
  constexpr int64_t kAhead = 64;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads())
#endif
  {
    std::vector<int32_t> ru(B), ri(B);
    std::vector<uint8_t> rl(B);
    std::vector<int64_t> countsw(rw + 1), countsh(rh + 2);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t t = 0; t < S; ++t) {
      uint64_t z = static_cast<uint64_t>(seed) + 0x9e3779b97f4a7c15ULL *
                   (static_cast<uint64_t>(t) + 1);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      std::mt19937_64 gen(z ^ (z >> 31));
      std::uniform_int_distribution<int64_t> dist(0, U * I - 1);
      for (int64_t b = 0; b < B; ++b) {
        const int64_t r = dist(gen);
        ru[b] = static_cast<int32_t>(r / I);
        ri[b] = static_cast<int32_t>(r % I);
      }
      // labels: filter probe (prefetched) + exact per-user range search
      for (int64_t b = 0; b < B; ++b) {
        if (b + kAhead < B) {
          const uint64_t ha = splitmix64(static_cast<uint64_t>(
              static_cast<int64_t>(ru[b + kAhead]) * I +
              ri[b + kAhead])) >> shift;
          __builtin_prefetch(&bits[ha >> 6], 0, 0);
        }
        const int64_t key = static_cast<int64_t>(ru[b]) * I + ri[b];
        bool hit = false;
        if (nkeys > 0) {
          const uint64_t h = splitmix64(static_cast<uint64_t>(key)) >> shift;
          if (bits[h >> 6] & (1ULL << (h & 63))) {
            const int64_t lo = indptr[ru[b]], hi = indptr[ru[b] + 1];
            hit = std::binary_search(pos_keys + lo, pos_keys + hi, key);
          }
        }
        rl[b] = hit ? 1 : 0;
      }
      // counting sort by the user's packed row; W windows from counts
      std::fill(countsw.begin(), countsw.end(), 0);
      for (int64_t b = 0; b < B; ++b) ++countsw[ru[b] / slots + 1];
      for (int64_t r = 0; r < rw; ++r) countsw[r + 1] += countsw[r];
      windows(countsw.data(), wrows_w, rw, nww, B, tile, winw + t * 2 * nww);
      int32_t* us = u2 + t * B;
      int32_t* is = i2 + t * B;
      uint8_t* ls = lab + t * B;
      {
        std::vector<int64_t> cursor(countsw.begin(), countsw.end() - 1);
        for (int64_t b = 0; b < B; ++b) {
          const int64_t pos = cursor[ru[b] / slots]++;
          us[pos] = ru[b];
          is[pos] = ri[b];
          ls[pos] = rl[b];
        }
      }
      // i side over the u-sorted stream (logical H rows: row == item id)
      sort_side(is, B, 1, rh, wrows_h, tile, B, countsh.data(), si + t * B,
                rowsi + t * B, wini + t * 2 * nwh);
    }
  }
  return 0;
}

// Once-a-fit BPR static prep: the minibatches of the shuffled interactions.
// Step t holds samples [t B, (t + 1) B) of users/items, padded past n with
// pad (users) and 0 (items), sorted stably by user into u2/i2 (S*B each):
// a counting sort over U + 1 buckets (pad the last) where U < 16 B, else a
// sort of (bucket, position) keys, which is also stable.  Returns 1 on a
// user outside [0, U) other than pad.
int cymf_sort_batches(const int32_t* users, const int32_t* items, int64_t n,
                      int64_t S, int64_t B, int64_t U, int32_t pad,
                      int32_t* u2, int32_t* i2) {
  const bool counting = U < 16 * B;
  bool bad = false;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads()) reduction(||: bad)
#endif
  {
    // 32-bit counts (B < 2^31): half the cache lines a step touches
    std::vector<int32_t> counts(counting ? U + 2 : 0);
    std::vector<uint64_t> keys(counting ? 0 : B);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t t = 0; t < S; ++t) {
      const int32_t* u = users + t * B;
      const int32_t* it = items + t * B;
      const int64_t m = std::max<int64_t>(0, std::min(n - t * B, B));
      int32_t* us = u2 + t * B;
      int32_t* is = i2 + t * B;
      bool ok = true;
      if (counting) {
        std::fill(counts.begin(), counts.end(), 0);
        for (int64_t b = 0; b < m && ok; ++b) {
          if (u[b] == pad) {
            ++counts[U + 1];
          } else if (u[b] < 0 || u[b] >= U) {
            ok = false;
          } else {
            ++counts[u[b] + 1];
          }
        }
        if (!ok) {
          bad = true;
          continue;
        }
        counts[U + 1] += static_cast<int32_t>(B - m);
        for (int64_t r = 0; r < U; ++r) counts[r + 1] += counts[r];
        for (int64_t b = 0; b < B; ++b) {
          const bool live = b < m && u[b] != pad;
          const int64_t pos = counts[live ? u[b] : U]++;
          us[pos] = live ? u[b] : pad;
          is[pos] = b < m ? it[b] : 0;
        }
      } else {
        for (int64_t b = 0; b < B && ok; ++b) {
          uint64_t key = static_cast<uint64_t>(U);
          if (b < m && u[b] != pad) {
            ok = u[b] >= 0 && u[b] < U;
            key = static_cast<uint64_t>(u[b]);
          }
          keys[b] = key << 32 | static_cast<uint64_t>(b);
        }
        if (!ok) {
          bad = true;
          continue;
        }
        std::sort(keys.begin(), keys.end());
        for (int64_t pos = 0; pos < B; ++pos) {
          const int64_t b = static_cast<int64_t>(keys[pos] & 0xffffffffULL);
          us[pos] = b < m ? u[b] : pad;
          is[pos] = b < m ? it[b] : 0;
        }
      }
    }
  }
  return bad ? 1 : 0;
}

// Once-a-fit static sorted side of an [S, B] id stream over logical rows
// (row = id): each step's sort_side (the j side of the per-epoch entries)
// into perm, srows (S*B) and win (S*2*(rows/wrows)); Bn: the step's length
// rounded up to a tile.  Returns 1 on a negative id.
int cymf_sorted_side(const int32_t* v2, int64_t S, int64_t B, int64_t rows,
                     int64_t wrows, int64_t tile, int64_t Bn, int32_t* perm,
                     int32_t* srows, int32_t* win) {
  const int64_t nw = rows / wrows;
  bool bad = false;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads()) reduction(||: bad)
#endif
  {
    std::vector<int64_t> counts(rows + 2);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t t = 0; t < S; ++t) {
      if (!sort_side(v2 + t * B, B, 1, rows, wrows, tile, Bn, counts.data(),
                     perm + t * B, srows + t * B, win + t * 2 * nw))
        bad = true;
    }
  }
  return bad ? 1 : 0;
}

// The windows of each step of an [S, B] stream ascending by row (id /
// slots) into win (S*2*(rows/wrows)): each window's edges by binary
// search, as window_ranges finds them.  Returns 1 on a negative id.
int cymf_sorted_windows(const int32_t* v2, int64_t S, int64_t B,
                        int64_t slots, int64_t rows, int64_t wrows,
                        int64_t tile, int64_t Bn, int32_t* win) {
  const int64_t nw = rows / wrows;
  bool bad = false;
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads()) reduction(||: bad)
#endif
  {
    std::vector<int64_t> edges(nw + 1);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t t = 0; t < S; ++t) {
      const int32_t* v = v2 + t * B;
      if (v[0] < 0) bad = true;
      // row < k wrows  <=>  id < k wrows slots, for ids >= 0
      for (int64_t k = 0; k <= nw; ++k)
        edges[k] = std::lower_bound(v, v + B, k * wrows * slots) - v;
      windows(edges.data(), 1, nw, nw, Bn, tile, win + t * 2 * nw);
    }
  }
  return bad ? 1 : 0;
}

// The packed engine's span gate: *fits = 1 iff every stride-sample chunk
// of the row stream u2 / slots (S*B, stride dividing B) has its in-table
// rows (< rw) within margin rows of its first row, or its first row past
// rw - margin, or no in-table row.  Returns 1 on a negative id.
int cymf_spans_fit(const int32_t* u2, int64_t S, int64_t B, int64_t slots,
                   int64_t stride, int64_t margin, int64_t rw,
                   int64_t* fits) {
  const int64_t nc = S * B / stride;
  const int64_t end = rw * slots;  // row < rw  <=>  id < rw slots
  bool bad = false, miss = false;
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads()) schedule(static) \
    reduction(||: bad, miss)
#endif
  for (int64_t c = 0; c < nc; ++c) {
    const int32_t* u = u2 + c * stride;
    int32_t hi = -1;  // the chunk's largest in-table id
    for (int64_t k = 0; k < stride; ++k) {
      if (u[k] < 0) bad = true;
      if (u[k] < end && u[k] > hi) hi = u[k];
    }
    const int64_t first = u[0] / slots;
    const int64_t last = hi < 0 ? -1 : hi / slots;
    if (!(last - first < margin || first > rw - margin || last < 0))
      miss = true;
  }
  *fits = miss ? 0 : 1;
  return bad ? 1 : 0;
}

}  // extern "C"
