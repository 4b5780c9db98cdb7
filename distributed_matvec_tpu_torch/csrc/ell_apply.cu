// The ELL apply of the engines' "ell" mode: each row walks its T0 table
// terms in registers, in one launch, and the tail's rows take a second.
//
// Replaces no TPU kernel: the JAX package's ELL apply
// (distributed_matvec_tpu/parallel/engine.py, LocalEngine._apply_ell) is
// XLA gathers, multiplies and adds.  It was added because the port's plain
// version of that apply, term by term in PyTorch
// (distributed_matvec_tpu_torch/ops/ell_apply.py::ell_apply_plain, which
// the CPU takes and this kernel is held against), makes three passes over
// the state axis per term: a gather into a temporary, a multiply into a
// second, and a read-modify-write of y.
//
// What it computes, for every row i < n and column c < R:
//   y[i, c] = diag[i]·x[i, c] + Σ_{t<T0} coeff[t, i]·x[idx[t, i], c]
// summed in that order, each product rounded before it is added (built
// with --fmad=false), so a real sector's y equals the plain version's bit
// for bit.  The tail launch, over its S rows:
//   y[rows[s], c] += Σ_{t<Tw} tcoeff[t, s]·x[tidx[t, s], c]
// the sum from 0.0 in t order, then one add into y.  The rows are unique,
// so no atomics.  x may hold more rows than y (a shard's [x; received]):
// every index is below x's row count, which the caller guarantees.
//
// What bounds it on an H100: bytes.  Per apply it reads the [T0, n]
// tables once (12 B an entry real, 20 B complex, padding included), x
// gathered T0 times a row, the diagonal, and writes y once.  It does one
// multiply and one add per entry and column, far below the FP64 rate.  At
// chain_32_symm the tables are ≈ 1.17 GB and x is 37.7 MB a column.
//
// Design:
// - One thread per row, neighbouring threads on neighbouring rows, so
//   each term's idx and coeff loads coalesce (128 B and 256 B a warp).
//   The tables are read with __ldcs (evict-first): each entry is read once
//   an apply, and must not push x out of the 50 MB L2, which holds x at
//   R = 1.  x is read with __ldg.
// - The tables are read in place: the [:T0, :n] slice of the engine's
//   [T, N_pad] tables, with the row stride passed in, is never copied.
// - x and y are state-major, [rows, R] with R contiguous, so one row's
//   gather is R neighbouring values: one 32-byte sector at R = 4, read as
//   two 16-byte loads where the rows are 16-byte aligned.  A thread takes
//   up to 4 columns (blockIdx.y is the group of 4); R ≤ 4 is one group of
//   exactly R columns, and a wider R masks the last group's columns.
// - The t loop goes in steps of kU terms: the step's idx and coeff loads
//   are issued first, then its kU gathers, then the adds in t order, so
//   kU gathers a thread are in flight behind one another's latency (8 at
//   1 or 2 columns, 4 at 3 or 4, where the registers a gather takes grow).
// - The sum keeps the plain version's order and roundings, so the kernel
//   leaves nothing to tune in the arithmetic; only the memory side moved.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// real sectors: double
struct Real {
  using V = double;
  static __device__ __forceinline__ V zero() { return 0.0; }
  static __device__ __forceinline__ V scale(double d, V v) { return d * v; }
  static __device__ __forceinline__ V mul(V a, V b) { return a * b; }
  static __device__ __forceinline__ V add(V a, V b) { return a + b; }
};

// complex sectors: complex128 as (re, im) in a double2, the layout of
// torch's complex128
struct Complex {
  using V = double2;
  static __device__ __forceinline__ V zero() { return make_double2(0.0, 0.0); }
  static __device__ __forceinline__ V scale(double d, V v) {
    return make_double2(d * v.x, d * v.y);
  }
  static __device__ __forceinline__ V mul(V a, V b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return make_double2(a.x + b.x, a.y + b.y);
  }
};

// The RC values of one row at p (nc of them live where kMask), by __ldg;
// pairs of doubles as one 16-byte load where vec (p 16-byte aligned).
template <int RC, bool kMask>
__device__ __forceinline__ void load_row(const double* p, int nc, bool vec,
                                         double (&v)[RC]) {
  if constexpr (RC % 2 == 0) {
    if (vec && (!kMask || nc == RC)) {
#pragma unroll
      for (int h = 0; h < RC / 2; ++h) {
        const double2 w = __ldg(reinterpret_cast<const double2*>(p) + h);
        v[2 * h] = w.x;
        v[2 * h + 1] = w.y;
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) v[c] = (!kMask || c < nc) ? __ldg(p + c) : 0.0;
}

template <int RC, bool kMask>
__device__ __forceinline__ void load_row(const double2* p, int nc, bool,
                                         double2 (&v)[RC]) {
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    v[c] = (!kMask || c < nc) ? __ldg(p + c) : make_double2(0.0, 0.0);
  }
}

template <int RC, bool kMask>
__device__ __forceinline__ void store_row(double* p, int nc, bool vec,
                                          const double (&v)[RC]) {
  if constexpr (RC % 2 == 0) {
    if (vec && (!kMask || nc == RC)) {
#pragma unroll
      for (int h = 0; h < RC / 2; ++h) {
        reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (!kMask || c < nc) p[c] = v[c];
  }
}

template <int RC, bool kMask>
__device__ __forceinline__ void store_row(double2* p, int nc, bool,
                                          const double2 (&v)[RC]) {
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (!kMask || c < nc) p[c] = v[c];
  }
}

// acc[c] += Σ_{t<T} coeff[t·ld_coeff]·x[idx[t·ld_idx]·R + c], in t order,
// kU terms a step; idx and coeff point at this thread's column of the
// tables, x at its column group.
template <class A, int RC, bool kMask>
__device__ __forceinline__ void walk_terms(
    typename A::V (&acc)[RC], int T, const int32_t* __restrict__ idx,
    int64_t ld_idx, const typename A::V* __restrict__ coeff,
    int64_t ld_coeff, const typename A::V* __restrict__ x, int R, int nc,
    bool vec) {
  using V = typename A::V;
  constexpr int kU = RC <= 2 ? 8 : 4;
  int t = 0;
  for (; t + kU <= T; t += kU) {
    int32_t j[kU];
    V cf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      j[u] = __ldcs(idx + (t + u) * ld_idx);
      cf[u] = __ldcs(coeff + (t + u) * ld_coeff);
    }
    V g[kU][RC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      load_row<RC, kMask>(x + static_cast<int64_t>(j[u]) * R, nc, vec, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[c] = A::add(acc[c], A::mul(cf[u], g[u][c]));
    }
  }
  for (; t < T; ++t) {
    const int32_t j = __ldcs(idx + t * ld_idx);
    const V cf = __ldcs(coeff + t * ld_coeff);
    V g[RC];
    load_row<RC, kMask>(x + static_cast<int64_t>(j) * R, nc, vec, g);
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[c] = A::add(acc[c], A::mul(cf, g[c]));
  }
}

// y[i] = diag[i]·x[i] + Σ_{t<T0} coeff[t, i]·x[idx[t, i]] for rows i < n,
// columns [4·blockIdx.y, +RC) (all R columns when R ≤ 4).
template <class A, int RC, bool kMask>
__global__ void __launch_bounds__(kThreads)
ell_terms_kernel(int64_t n, int T0, const int32_t* __restrict__ idx,
                 int64_t ld_idx, const typename A::V* __restrict__ coeff,
                 int64_t ld_coeff, const double* __restrict__ diag,
                 const typename A::V* __restrict__ x,
                 typename A::V* __restrict__ y, int R, bool vec) {
  using V = typename A::V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c0 = 4 * static_cast<int>(blockIdx.y);
  const int nc = kMask ? min(RC, R - c0) : RC;
  const V* xc = x + c0;
  V acc[RC];
  load_row<RC, kMask>(xc + i * R, nc, vec, acc);
  const double d = __ldcs(diag + i);
#pragma unroll
  for (int c = 0; c < RC; ++c) acc[c] = A::scale(d, acc[c]);
  walk_terms<A, RC, kMask>(acc, T0, idx + i, ld_idx, coeff + i, ld_coeff, xc,
                           R, nc, vec);
  store_row<RC, kMask>(y + i * R + c0, nc, vec, acc);
}

// y[rows[s]] += Σ_{t<Tw} coeff[t, s]·x[idx[t, s]] for s < S, columns as
// above; the rows are unique.
template <class A, int RC, bool kMask>
__global__ void __launch_bounds__(kThreads)
ell_tail_kernel(int64_t S, int Tw, const int32_t* __restrict__ rows,
                const int32_t* __restrict__ idx, int64_t ld_idx,
                const typename A::V* __restrict__ coeff, int64_t ld_coeff,
                const typename A::V* __restrict__ x,
                typename A::V* __restrict__ y, int R, bool vec) {
  using V = typename A::V;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= S) return;
  const int c0 = 4 * static_cast<int>(blockIdx.y);
  const int nc = kMask ? min(RC, R - c0) : RC;
  V acc[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) acc[c] = A::zero();
  walk_terms<A, RC, kMask>(acc, Tw, idx + s, ld_idx, coeff + s, ld_coeff,
                           x + c0, R, nc, vec);
  V* py = y + static_cast<int64_t>(__ldg(rows + s)) * R + c0;
  V cur[RC];
  load_row<RC, kMask>(py, nc, vec, cur);
#pragma unroll
  for (int c = 0; c < RC; ++c) cur[c] = A::add(cur[c], acc[c]);
  store_row<RC, kMask>(py, nc, vec, cur);
}

// Both kernels take the same launch: rows over grid.x, column groups of
// 4 over grid.y; R ≤ 4 runs the exact-width instance, a wider R the masked
// one.  vec: every row of x and y starts 16-byte aligned (real sectors;
// complex rows always are).
struct Launch {
  dim3 grid;
  bool vec;
};

Launch plan(int64_t rows, int R, const void* x, const void* y) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  Launch l;
  l.grid = dim3(static_cast<unsigned int>((rows + kThreads - 1) / kThreads),
                static_cast<unsigned int>((R + 3) / 4));
  l.vec = R % 2 == 0 && aligned(x) && aligned(y);
  return l;
}

template <class A>
int launch_terms(int64_t n, int R, int T0, const int32_t* idx, int64_t ld_idx,
                 const void* coeff, int64_t ld_coeff, const double* diag,
                 const void* x, void* y, cudaStream_t s) {
  using V = typename A::V;
  const Launch l = plan(n, R, x, y);
  const auto* cf = static_cast<const V*>(coeff);
  const auto* xv = static_cast<const V*>(x);
  auto* yv = static_cast<V*>(y);
#define DMT_ELL_TERMS(RC, MASK)                                             \
  ell_terms_kernel<A, RC, MASK><<<l.grid, kThreads, 0, s>>>(                \
      n, T0, idx, ld_idx, cf, ld_coeff, diag, xv, yv, R, l.vec)
  switch (R) {
    case 1: DMT_ELL_TERMS(1, false); break;
    case 2: DMT_ELL_TERMS(2, false); break;
    case 3: DMT_ELL_TERMS(3, false); break;
    case 4: DMT_ELL_TERMS(4, false); break;
    default: DMT_ELL_TERMS(4, true); break;
  }
#undef DMT_ELL_TERMS
  return static_cast<int>(cudaGetLastError());
}

template <class A>
int launch_tail(int64_t S, int R, int Tw, const int32_t* rows,
                const int32_t* idx, int64_t ld_idx, const void* coeff,
                int64_t ld_coeff, const void* x, void* y, cudaStream_t s) {
  using V = typename A::V;
  const Launch l = plan(S, R, x, y);
  const auto* cf = static_cast<const V*>(coeff);
  const auto* xv = static_cast<const V*>(x);
  auto* yv = static_cast<V*>(y);
#define DMT_ELL_TAIL(RC, MASK)                                              \
  ell_tail_kernel<A, RC, MASK><<<l.grid, kThreads, 0, s>>>(                 \
      S, Tw, rows, idx, ld_idx, cf, ld_coeff, xv, yv, R, l.vec)
  switch (R) {
    case 1: DMT_ELL_TAIL(1, false); break;
    case 2: DMT_ELL_TAIL(2, false); break;
    case 3: DMT_ELL_TAIL(3, false); break;
    case 4: DMT_ELL_TAIL(4, false); break;
    default: DMT_ELL_TAIL(4, true); break;
  }
#undef DMT_ELL_TAIL
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int64_t rows, int R, int T, int64_t ld_idx, int64_t ld_coeff) {
  return rows > 0 && rows < (int64_t{1} << 31) && R >= 1 && R <= 65535 * 4 &&
         T >= 0 && ld_idx >= rows && ld_coeff >= rows;
}

}  // namespace

// y [n, R] = diag·x[:n] + Σ_{t<T0} coeff[t]·x[idx[t]] (state-major x and y,
// R contiguous; x holds at least n rows and every idx is below its row
// count).  idx int32 and coeff (float64, or complex128 where is_complex)
// are [T0, n] with row strides ld_idx and ld_coeff elements.  Returns the
// cudaError_t of the launch (0 on success); n = 0 launches nothing.
extern "C" int dmt_ell_apply(int is_complex, int64_t n, int R, int T0,
                             const void* idx, int64_t ld_idx,
                             const void* coeff, int64_t ld_coeff,
                             const double* diag, const void* x, void* y,
                             void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(n, R, T0, ld_idx, ld_coeff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  return is_complex
             ? launch_terms<Complex>(n, R, T0, ix, ld_idx, coeff, ld_coeff,
                                     diag, x, y, s)
             : launch_terms<Real>(n, R, T0, ix, ld_idx, coeff, ld_coeff, diag,
                                  x, y, s);
}

// y[rows[s]] += Σ_{t<Tw} coeff[t, s]·x[idx[t, s]] for the S unique rows
// (int32 [S]); idx and coeff are [Tw, S] with row strides ld_idx and
// ld_coeff.  Returns the cudaError_t of the launch; S = 0 launches nothing.
extern "C" int dmt_ell_tail(int is_complex, int64_t S, int R, int Tw,
                            const void* rows, const void* idx, int64_t ld_idx,
                            const void* coeff, int64_t ld_coeff,
                            const void* x, void* y, void* stream) {
  if (S == 0) return 0;
  if (!shape_ok(S, R, Tw, ld_idx, ld_coeff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* ix = static_cast<const int32_t*>(idx);
  return is_complex
             ? launch_tail<Complex>(S, R, Tw, r, ix, ld_idx, coeff, ld_coeff,
                                    x, y, s)
             : launch_tail<Real>(S, R, Tw, r, ix, ld_idx, coeff, ld_coeff, x,
                                 y, s);
}

// Message of a cudaError_t, for the wrapper's exception.
extern "C" const char* dmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
