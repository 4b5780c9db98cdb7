// Copied from distributed_matvec_tpu/enumeration/_native.cpp
// Native enumeration kernel: streaming representative search.
//
// C++ replacement for the multithreaded Haskell/C enumeration kernels the
// reference calls through `ls_hs_is_representative` batches
// (reference src/StatesEnumeration.chpl:158-200).  Design differences
// (a rebuild, not a line-by-line port):
//   * candidates are generated *inside* the kernel with the same-popcount
//     bit trick (StatesEnumeration.chpl:31-34) — nothing is materialized,
//   * the orbit scan early-exits the moment any g·σ < σ (the common case),
//     with group elements pre-sorted cheap-first by the Python wrapper,
//   * permutations are applied through shift/mask networks (symmetry.py's
//     decomposition), identical tables to the device kernels.
//
// Exposed as a C ABI for ctypes; no Python.h dependency.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct dmt_group {
  // [G*S] row-major networks; element 0 must be the identity.
  const uint64_t *mask;
  const uint64_t *lshift;
  const uint64_t *rshift;
  const uint64_t *xor_mask;  // [G]
  const double *char_real;   // [G] Re χ(g)
  int64_t g;                 // |G|
  int64_t s;                 // network width S
};

static inline uint64_t apply_perm(const dmt_group *grp, int64_t gi,
                                  uint64_t state) {
  const int64_t S = grp->s;
  const uint64_t *m = grp->mask + gi * S;
  const uint64_t *l = grp->lshift + gi * S;
  const uint64_t *r = grp->rshift + gi * S;
  uint64_t out = 0;
  for (int64_t k = 0; k < S; ++k) {
    out |= ((state & m[k]) << l[k]) >> r[k];
  }
  return out ^ grp->xor_mask[gi];
}

static inline uint64_t next_fixed_hamming(uint64_t v) {
  // StatesEnumeration.chpl:31-34
  const uint64_t t = v | (v - 1);
  const int ctz = __builtin_ctzll(v);
  return (t + 1) | (((~t & (t + 1)) - 1) >> (ctz + 1));
}

// Scan candidates in [lo, hi] (inclusive); keep representatives.
// Returns the number of survivors written, or -1 on capacity overflow.
// `count_only != 0` skips the writes (used for capacity probing).
static int64_t scan_range(uint64_t lo, uint64_t hi, int use_hamming,
                          const dmt_group *grp, double norm_tol,
                          uint64_t *out_states, double *out_norms,
                          int64_t capacity, int count_only) {
  const int64_t G = grp->g;
  int64_t n = 0;
  uint64_t v = lo;
  if (use_hamming && v == 0) {
    // popcount-0 sector is the single state 0
    if (lo == 0 && hi == 0) {
      if (!count_only) {
        if (capacity < 1) return -1;
        out_states[0] = 0;
        out_norms[0] = 1.0;
      }
      return 1;
    }
  }
  while (true) {
    // orbit scan with early exit
    double stab = 0.0;
    bool is_rep = true;
    for (int64_t gi = 0; gi < G; ++gi) {
      const uint64_t y = apply_perm(grp, gi, v);
      if (y < v) {
        is_rep = false;
        break;
      }
      if (y == v) stab += grp->char_real[gi];
    }
    if (is_rep) {
      const double n2 = stab / (double)G;
      if (n2 > norm_tol) {
        if (!count_only) {
          if (n >= capacity) return -1;
          out_states[n] = v;
          out_norms[n] = std::sqrt(n2);
        }
        ++n;
      }
    }
    if (v >= hi) break;
    const uint64_t nxt = use_hamming ? next_fixed_hamming(v) : v + 1;
    if (nxt <= v) break;  // overflow guard
    v = nxt;
  }
  return n;
}

// Parallel entry point: split [lo, hi] into `ntasks` sub-ranges at fixed-hamming
// index boundaries supplied by the caller (bounds[ntasks+1], bounds[0]=lo,
// bounds[ntasks]=hi+adjacent).  Each task writes into its own slice of a
// caller-provided buffer at offsets[t]; the caller compacts afterwards.
int64_t dmt_enumerate_ranges(const uint64_t *starts, const uint64_t *ends,
                             int64_t ntasks, int use_hamming,
                             const dmt_group *grp, double norm_tol,
                             uint64_t *out_states, double *out_norms,
                             const int64_t *offsets, const int64_t *caps,
                             int64_t *counts, int nthreads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    while (true) {
      const int64_t t = next.fetch_add(1);
      if (t >= ntasks || failed.load()) break;
      const int64_t got = scan_range(
          starts[t], ends[t], use_hamming, grp, norm_tol,
          out_states + offsets[t], out_norms + offsets[t], caps[t], 0);
      if (got < 0) {
        failed.store(1);
        break;
      }
      counts[t] = got;
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; ++i) pool.emplace_back(worker);
    for (auto &th : pool) th.join();
  }
  return failed.load() ? -1 : 0;
}

// Routing-plan hot loop: for each generated state β, the owning shard
// (splitmix64 finalizer % D — bit-identical to StatesEnumeration.chpl's
// hash64_01, :122-136) and β's position in the owner's sorted
// representative prefix.  One threaded pass replaces a per-peer
// mask + searchsorted sweep on the build host.
static inline uint64_t splitmix64_fin(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

int64_t dmt_lookup_owners(const uint64_t *betas, int64_t n,
                          const uint64_t *alphas,  // [D*M] row-major, sorted
                          const int64_t *counts,   // [D] real prefix sizes
                          int64_t D, int64_t M,
                          int32_t *out_owner, int32_t *out_idx,
                          uint8_t *out_found, int nthreads) {
  std::atomic<int64_t> next(0);
  const int64_t chunk = 1 << 16;
  const int64_t nchunks = (n + chunk - 1) / chunk;
  if (nchunks < (int64_t)nthreads) nthreads = (int)(nchunks > 0 ? nchunks : 1);
  auto worker = [&]() {
    while (true) {
      const int64_t s = next.fetch_add(chunk);
      if (s >= n) break;
      const int64_t e = s + chunk < n ? s + chunk : n;
      for (int64_t i = s; i < e; ++i) {
        const uint64_t b = betas[i];
        const int64_t d = D > 1 ? (int64_t)(splitmix64_fin(b) % (uint64_t)D)
                                : 0;
        const uint64_t *a = alphas + d * M;
        int64_t lo = 0, hi = counts[d];
        while (lo < hi) {  // lower_bound
          const int64_t mid = (lo + hi) >> 1;
          if (a[mid] < b) lo = mid + 1; else hi = mid;
        }
        out_owner[i] = (int32_t)d;
        const int found = lo < counts[d] && a[lo] == b;
        out_idx[i] = (int32_t)(found ? lo : 0);
        out_found[i] = (uint8_t)found;
      }
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < nthreads; ++i) pool.emplace_back(worker);
    for (auto &th : pool) th.join();
  }
  return 0;
}

// Count states with the same popcount in [lo, hi] (for capacity planning /
// unprojected fill).
int64_t dmt_count_fixed_hamming(uint64_t lo, uint64_t hi) {
  int64_t n = 0;
  uint64_t v = lo;
  while (true) {
    ++n;
    if (v >= hi) break;
    const uint64_t nxt = next_fixed_hamming(v);
    if (nxt <= v) break;
    v = nxt;
  }
  return n;
}

// Plain fill of the fixed-hamming sequence (unprojected path).
int64_t dmt_fill_fixed_hamming(uint64_t lo, uint64_t hi, uint64_t *out,
                               int64_t capacity) {
  int64_t n = 0;
  uint64_t v = lo;
  while (true) {
    if (n >= capacity) return -1;
    out[n++] = v;
    if (v >= hi) break;
    const uint64_t nxt = next_fixed_hamming(v);
    if (nxt <= v) break;
    v = nxt;
  }
  return n;
}

}  // extern "C"
