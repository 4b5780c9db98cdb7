// Fused decode + gather + multiply + scatter of one compressed plan chunk.
//
// Replaces distributed_matvec_tpu/ops/plan_codec.py::fused_decode_gather_scatter,
// the Pallas kernel of the streamed engine (pl.pallas_call at plan_codec.py:695).
// The plain PyTorch version it is held against is
// distributed_matvec_tpu_torch/ops/plan_codec.py::_fused_decode_gather_scatter_plain.
//
// What it computes, for each live entry i of one chunk:
//   dest = bits [i*w_dest, (i+1)*w_dest) of the dest word stream
//   row  = bits [i*w_row,  (i+1)*w_row)  of the row word stream
//   out[min(dest, n_recv)] = cdict[codes[i]] * x[row]
// and every slot that no live entry writes is 0.  Destinations are unique
// by construction (in-bucket rank); padding entries carry the n_recv
// sentinel and all have the same value (pad code, row 0).
//
// What bounds it on an H100: bytes.  Per launch it reads the two packed
// streams ((w_dest + w_row) bits per live entry), the codes (1 or 2 bytes
// per entry), the D bucket fill counts, the dictionary and x (B doubles,
// gathered), and writes the send buffer ((n_recv + 1) doubles); it does
// one multiply per entry, one FLOP per ~14 bytes, so no tensor-core f64
// path is worth using.  The send buffer is most of the bytes.
//
// Design (fused_decode_kernel):
// - The send buffer is written exactly once, in this one launch, with no
//   separate zero fill.  It is D buckets of cap = n_recv / D slots, one per
//   destination shard.  The entries routed to bucket k take the in-bucket
//   ranks 0 ... fill[k] - 1, so the occupied slots of bucket k are the
//   prefix [k*cap, k*cap + fill[k]) (the plan build raises on any live
//   amplitude it cannot place).  A slot at or above its bucket's fill gets
//   0.0 and every other slot gets its entry's amplitude.  The fill counts
//   are the SEND side's occupancy: the chunk's rok stream describes the
//   receive buffer after the exchange, which equals the send buffer only
//   at D = 1.  Padding entries form the tail of the live stream: the
//   thread of entry n_live - 1 writes the drop slot n_recv, with the
//   padding value when that entry is padding and 0.0 when the chunk has
//   none.  Other padding entries store nothing.
// - One block per tile of kTile = kThreads * kEntries consecutive entries
//   and the same range of slots.  The block stages the tile's span of the
//   dest stream, the row stream and the codes into shared memory: every
//   thread first issues its 16-byte loads, marked evict-first (__ldcs: the
//   plan is read once), then stores them, and one barrier later the block
//   decodes.  That is at most 10 320 bytes of shared memory a block (48 KB
//   is the limit without an attribute).  Several blocks per SM overlap one
//   block's staging with another's stores.
// - The dictionary (256 doubles for u8 codes, up to 64 K for u16) and the
//   fill counts are read with __ldg: they stay in L1, and staging the
//   dictionary in shared memory as well measured slower on the H100.
// - D = 1 has its own instantiation (kBuckets false): its slot rule is one
//   compare against fill[0], with no bucket bookkeeping in registers.  So
//   it measured no slower on the H100 than the rok-taking design it
//   replaced, which one instantiation for every D did not
//   (tools/torch_decode_bench.py times the two in turns).
// - Thread t takes entries e0 + t + kThreads*r, r < kEntries: neighbouring
//   threads hold neighbouring entries, so shared-memory reads of the bit
//   fields are conflict-free and, where dest is the identity (one device),
//   the stores coalesce.  Any unique dest inside the bucket prefixes is
//   correct, in any order.
// - Bit offsets are 64-bit (n * width exceeds 2^32 at chain_32 sizes).  A
//   field is read as a funnel shift of its word and the next: each packed
//   stream carries one spare word, so the next word always exists, and no
//   shift by 32 is ever issued.  Slot indices are below 2^31 (the wrapper
//   checks).  A thread finds the bucket of its first slot with one 32-bit
//   division (none at D = 1) and steps it along its later slots.
// - The send buffer is written with default stores, so it stays in L2 for
//   the receive side, which reads it next.
// Build with --fmad=false; the one product per entry has nothing to contract.
//
// fused_decode_per_entry_kernel is the earlier design, kept so its time can
// be measured beside this one: one thread per live entry reading the
// streams from global memory, and the caller zero-fills out first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// entries per thread of fused_decode_kernel
constexpr int kEntries = 4;

__host__ __device__ constexpr int64_t round16(int64_t n) {
  return (n + 15) & ~int64_t{15};
}

constexpr int64_t kTile = int64_t{kThreads} * kEntries;

// Largest byte span of a tile in a `width`-bit stream: its words plus the
// spare word after them.
__host__ __device__ constexpr int64_t field_span(int width) {
  return 4 * (((kTile - 1) * width + 31) / 32 + 2);
}

// Shared memory for a staged span of at most len bytes: the span starts up
// to 15 bytes into its first 16-byte granule.
__host__ __device__ constexpr int64_t stage_bytes(int64_t len) {
  return round16(len + 15);
}

// 16-byte granules each thread stages, at most, per stream
constexpr int kFieldGranules =
    static_cast<int>((stage_bytes(field_span(32)) / 16 + kThreads - 1) / kThreads);
constexpr int kCodeGranules =
    static_cast<int>((stage_bytes(kTile * 2) / 16 + kThreads - 1) / kThreads);

// One stream's span [lo, hi) of n bytes at base, as this thread's share of
// its 16-byte granules.  Stream byte b goes to shared byte b - origin, where
// origin is lo rounded down so that base + origin is 16-byte aligned.  A
// granule inside [0, n) is one 16-byte evict-first load (__ldcs: the plan
// is read once); one that overhangs the stream's ends is gathered byte by
// byte, so nothing outside [0, n) is read.  All loads are issued before
// any is stored to shared memory.
template <int G>
struct Span {
  int64_t origin;
  int ngran;
  uint4 v[G];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ base,
                                       int64_t lo, int64_t hi, int64_t n) {
    origin = lo - static_cast<int64_t>(reinterpret_cast<uintptr_t>(base + lo) & 15);
    ngran = static_cast<int>((hi - origin + 15) >> 4);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = threadIdx.x + j * kThreads;
      const int64_t b0 = origin + 16 * static_cast<int64_t>(g);
      if (g >= ngran) continue;
      if (b0 >= 0 && b0 + 16 <= n) {
        v[j] = __ldcs(reinterpret_cast<const uint4*>(base + b0));
        continue;
      }
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int64_t b = b0 + k;
        if (b >= lo && b < hi && b < n) {
          w[k >> 2] |= static_cast<uint32_t>(__ldcs(base + b)) << (8 * (k & 3));
        }
      }
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  __device__ __forceinline__ void store(uint8_t* dst) const {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = threadIdx.x + j * kThreads;
      if (g < ngran) reinterpret_cast<uint4*>(dst)[g] = v[j];
    }
  }
};

// Value i of a width-bit stream staged at s with the given origin
// (origin % 4 == 0).
__device__ __forceinline__ uint32_t field(const uint8_t* s, int64_t origin,
                                          int64_t i, int width) {
  const int64_t bit = i * static_cast<int64_t>(width);
  const auto* w = reinterpret_cast<const uint32_t*>(s + 4 * (bit >> 5) - origin);
  const uint32_t v = __funnelshift_r(w[0], w[1], static_cast<uint32_t>(bit & 31));
  return width == 32 ? v : (v & ((1u << width) - 1u));
}

struct Smem {
  int dest, row, code, total;  // byte offsets into the block's buffer
};

template <typename Code>
Smem smem_layout(int w_dest, int w_row) {
  Smem s{};
  s.dest = 0;
  s.row = s.dest + static_cast<int>(stage_bytes(field_span(w_dest)));
  s.code = s.row + static_cast<int>(stage_bytes(field_span(w_row)));
  s.total = s.code + static_cast<int>(stage_bytes(kTile * sizeof(Code)));
  return s;
}

// kBuckets: D > 1.  At D = 1 the one bucket is the whole buffer, and the
// slot rule is a compare against fill[0].
template <typename Code, bool kBuckets>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const uint32_t* __restrict__ dest_words, int64_t nwd,
                    const uint32_t* __restrict__ row_words, int64_t nwr,
                    const Code* __restrict__ codes,
                    const int32_t* __restrict__ fill, uint32_t cap,
                    const double* __restrict__ cdict,
                    const double* __restrict__ x, double* __restrict__ out,
                    int64_t n_live, int w_dest, int w_row, int64_t n_recv,
                    Smem lay) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t e1 = e0 + kTile < n_live ? e0 + kTile : n_live;
  constexpr int64_t cb = sizeof(Code);
  // the bucket [lo, hi) of this thread's first slot and its fill,
  // advanced along the thread's slots below: one division per thread,
  // none at D = 1
  uint32_t k = 0, lo = 0, hi = cap;
  if (kBuckets && e0 + threadIdx.x < n_recv) {
    k = static_cast<uint32_t>(e0 + threadIdx.x) / cap;
    lo = k * cap;
    hi = lo + cap;
  }
  auto f = static_cast<uint32_t>(__ldg(fill + k));

  Span<kFieldGranules> sd, sr;
  Span<kCodeGranules> sc;
  sd.ngran = sr.ngran = sc.ngran = 0;
  sd.origin = sr.origin = sc.origin = 0;
  if (e0 < e1) {
    sd.load(reinterpret_cast<const uint8_t*>(dest_words),
            4 * ((e0 * w_dest) >> 5), 4 * (((e1 - 1) * w_dest >> 5) + 2),
            4 * nwd);
    sr.load(reinterpret_cast<const uint8_t*>(row_words),
            4 * ((e0 * w_row) >> 5), 4 * (((e1 - 1) * w_row >> 5) + 2),
            4 * nwr);
    sc.load(reinterpret_cast<const uint8_t*>(codes), e0 * cb, e1 * cb,
            n_live * cb);
  }
  sd.store(smem + lay.dest);
  sr.store(smem + lay.row);
  sc.store(smem + lay.code);
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kEntries; ++r) {
    const int t = threadIdx.x + kThreads * r;
    const int64_t i = e0 + t;
    if (i < e1) {
      const int64_t dest = field(smem + lay.dest, sd.origin, i, w_dest);
      const uint32_t row = field(smem + lay.row, sr.origin, i, w_row);
      const Code code =
          *reinterpret_cast<const Code*>(smem + lay.code + i * cb - sc.origin);
      const double amp = __ldg(cdict + code) * __ldg(x + row);
      if (dest < n_recv) out[dest] = amp;
      if (i == n_live - 1) out[n_recv] = dest < n_recv ? 0.0 : amp;
    }
    // i doubles as a slot index: the block's slots are its entries' range.
    // Slot i is empty iff its in-bucket index is at or above its bucket's
    // fill.
    if (i < n_recv) {
      const auto slot = static_cast<uint32_t>(i);
      if (kBuckets) {
        while (slot >= hi) {
          ++k;
          lo = hi;
          hi += cap;
          f = static_cast<uint32_t>(__ldg(fill + k));
        }
      }
      if (slot - lo >= f) out[i] = 0.0;
    }
  }
  if (n_live == 0 && blockIdx.x == 0 && threadIdx.x == 0) out[n_recv] = 0.0;
}

template <typename Code>
int launch(const uint32_t* dest_words, int64_t nwd, const uint32_t* row_words,
           int64_t nwr, const void* codes, const int32_t* fill, uint32_t cap,
           int64_t n_buckets, const double* cdict, const double* x,
           double* out, int64_t n_live, int w_dest, int w_row,
           int64_t n_recv, cudaStream_t s) {
  const int64_t span = n_live > n_recv ? n_live : n_recv;
  const auto blocks =
      static_cast<unsigned int>(span > 0 ? (span + kTile - 1) / kTile : 1);
  const Smem lay = smem_layout<Code>(w_dest, w_row);
  auto* kernel = n_buckets > 1 ? fused_decode_kernel<Code, true>
                               : fused_decode_kernel<Code, false>;
  kernel<<<blocks, kThreads, lay.total, s>>>(
      dest_words, nwd, row_words, nwr, static_cast<const Code*>(codes),
      fill, cap, cdict, x, out, n_live, w_dest, w_row, n_recv, lay);
  return static_cast<int>(cudaGetLastError());
}

// -- the earlier design -------------------------------------------------------

__device__ __forceinline__ uint32_t read_bits(const uint32_t* __restrict__ words,
                                              int64_t i, int width) {
  const int64_t bit0 = i * static_cast<int64_t>(width);
  const int64_t w0 = bit0 >> 5;
  const uint32_t off = static_cast<uint32_t>(bit0 & 31);
  uint32_t v = __ldg(words + w0) >> off;
  if (off + static_cast<uint32_t>(width) > 32u) {
    // spills: off >= 1 here, so the shift is in [1, 31]
    v |= __ldg(words + w0 + 1) << (32u - off);
  }
  return width == 32 ? v : (v & ((1u << width) - 1u));
}

template <typename Code>
__global__ void __launch_bounds__(kThreads)
fused_decode_per_entry_kernel(const uint32_t* __restrict__ dest_words,
                              const uint32_t* __restrict__ row_words,
                              const Code* __restrict__ codes,
                              const double* __restrict__ cdict,
                              const double* __restrict__ x,
                              double* __restrict__ out, int64_t n_live,
                              int w_dest, int w_row, int64_t n_recv) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_live) return;
  const int64_t dest = read_bits(dest_words, i, w_dest);
  const uint32_t row = read_bits(row_words, i, w_row);
  const double amp = __ldg(cdict + __ldg(codes + i)) * __ldg(x + row);
  out[dest < n_recv ? dest : n_recv] = amp;
}

bool widths_ok(int w_dest, int w_row) {
  return w_dest >= 1 && w_dest <= 32 && w_row >= 1 && w_row <= 32;
}

}  // namespace

// edest: the chunk's dest stream (nwd words) followed by its row stream
// (nwr words).  fill: the D per-bucket fill counts of the send buffer,
// whose n_recv = D * cap slots are D buckets of cap.  code_bits: 8 (uint8
// codes) or 16 (uint16 codes).  Writes every slot of out [n_recv + 1]; see
// the precondition on the fill counts above.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dmt_fused_decode_gather_scatter(
    const void* edest, int64_t nwd, int64_t nwr, const void* codes,
    int code_bits, const void* fill, int64_t n_buckets, const double* cdict,
    const double* x, double* out, int64_t n_live, int w_dest, int w_row,
    int64_t n_recv, void* stream) {
  if (!widths_ok(w_dest, w_row) || n_live < 0 || n_recv < 0 ||
      n_recv >= (int64_t{1} << 31) || n_buckets < 1 ||
      n_recv % n_buckets != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* dest_words = static_cast<const uint32_t*>(edest);
  const auto* fills = static_cast<const int32_t*>(fill);
  // an empty buffer has no slot to place; any nonzero divisor serves
  const auto cap = static_cast<uint32_t>(n_recv > 0 ? n_recv / n_buckets : 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (code_bits == 8) {
    return launch<uint8_t>(dest_words, nwd, dest_words + nwd, nwr, codes,
                           fills, cap, n_buckets, cdict, x, out, n_live,
                           w_dest, w_row, n_recv, s);
  }
  if (code_bits == 16) {
    return launch<uint16_t>(dest_words, nwd, dest_words + nwd, nwr, codes,
                            fills, cap, n_buckets, cdict, x, out, n_live,
                            w_dest, w_row, n_recv, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The earlier design, for timing beside the kernel above: same streams, no
// fill counts; out must be zero-filled by the caller.
extern "C" int dmt_fused_decode_per_entry(
    const void* edest, int64_t nwd, const void* codes, int code_bits,
    const double* cdict, const double* x, double* out, int64_t n_live,
    int w_dest, int w_row, int64_t n_recv, void* stream) {
  if (!widths_ok(w_dest, w_row)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_live <= 0) return 0;
  const auto* dest_words = static_cast<const uint32_t*>(edest);
  const uint32_t* row_words = dest_words + nwd;
  const auto blocks = static_cast<unsigned int>((n_live + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (code_bits == 8) {
    fused_decode_per_entry_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
        dest_words, row_words, static_cast<const uint8_t*>(codes), cdict, x,
        out, n_live, w_dest, w_row, n_recv);
  } else if (code_bits == 16) {
    fused_decode_per_entry_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        dest_words, row_words, static_cast<const uint16_t*>(codes), cdict, x,
        out, n_live, w_dest, w_row, n_recv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t, for the wrapper's exception.
extern "C" const char* dmt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
