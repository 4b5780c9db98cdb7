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
// Destinations are unique by construction (in-bucket rank), so every store
// lands in its own slot and no atomics are needed; padding entries carry the
// n_recv sentinel and all land, with the same value, in the trailing drop
// slot.  The caller zero-fills out [n_recv + 1] before the launch.
//
// What bounds it on an H100: bytes.  Per launch it reads the two packed
// streams ((w_dest + w_row) bits per live entry), the codes (1 or 2 bytes
// per entry), the dictionary and x (B doubles, gathered), and writes the
// send buffer ((n_recv + 1) doubles); it does one multiply per entry.  At
// chain_32_symm with B = 65536 that is some 15-25 MB per launch, a few
// microseconds at 3.35 TB/s, and 72 launches per apply.
//
// Design: one thread per live entry.  Bit offsets are 64-bit (n * width
// exceeds 2^32 at chain_32 sizes).  Each thread reads the one u32 word that
// holds the start of its value and the next word only when the value spills
// into it, so no shift by 32 is ever issued (undefined in CUDA as in XLA).
// Neighbouring threads read neighbouring words of the streams and codes, so
// those loads coalesce; the x gather and the out scatter follow the plan.
// Build with --fmad=false; the one product per entry has nothing to contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
fused_decode_gather_scatter_kernel(const uint32_t* __restrict__ dest_words,
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

}  // namespace

// edest: the chunk's dest stream (nwd words) followed by its row stream.
// code_bits: 8 (uint8 codes) or 16 (uint16 codes).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dmt_fused_decode_gather_scatter(
    const void* edest, int64_t nwd, const void* codes, int code_bits,
    const double* cdict, const double* x, double* out, int64_t n_live,
    int w_dest, int w_row, int64_t n_recv, void* stream) {
  if (w_dest < 1 || w_dest > 32 || w_row < 1 || w_row > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_live <= 0) return 0;
  const auto* dest_words = static_cast<const uint32_t*>(edest);
  const uint32_t* row_words = dest_words + nwd;
  const auto blocks = static_cast<unsigned int>((n_live + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (code_bits == 8) {
    fused_decode_gather_scatter_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
        dest_words, row_words, static_cast<const uint8_t*>(codes), cdict, x,
        out, n_live, w_dest, w_row, n_recv);
  } else if (code_bits == 16) {
    fused_decode_gather_scatter_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
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
