// Bit-serial arithmetic over vertical bit-planes for Hopper (sm_90a):
// ripple-carry add / subtract modulo 2**n_bits and unsigned a < b.
//
// Replaces: src/repro/kernels/arith.py::bitserial_add_kernel and
// ::bitserial_lt_kernel (Pallas: a full adder, or the lt / eq compare
// chain, rippled across the planes in vector registers with n_bits
// unrolled at trace time), reached through kernels/ops.py::bitserial_add /
// ::bitserial_lt and ops/arith.py (add_columns, sub_columns, lt_columns).
// Plain versions: src/repro_torch/kernels/ref.py::bitserial_add and
// ::bitserial_lt.
//
// What bounds it on this card: bytes. Add reads two planes and writes one
// per bit, 3 * n_bits * 4 bytes per word position, against about 6 logic
// instructions per bit; lt reads two planes per bit and writes one word,
// (2 * n_bits + 1) * 4 bytes, against about 4 instructions per bit.
//
// Design. One thread owns one word position (grid-stride loop) and walks
// its planes with the carry (or lt / eq) in registers, so the carry never
// touches memory. Plane j of an operand sits at j * n words, so each
// plane load and store of a warp covers 32 consecutive words (128 B); the
// plane loads do not depend on the carry, so the unrolled loop keeps
// several in flight. Subtraction is a + ~b + 1: b is complemented and the
// carry-in is all ones. n_bits and sub are launch arguments, so one build
// serves every width.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
bitserial_add_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, long long n, int n_bits,
                     uint32_t flip, uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += stride) {
    uint32_t c = flip;               // carry-in: 0 (add) or ~0 (sub)
#pragma unroll 4
    for (int j = 0; j < n_bits; ++j) {
      const long long at = static_cast<long long>(j) * n + idx;
      const uint32_t aj = __ldg(a + at);
      const uint32_t bj = __ldg(b + at) ^ flip;
      out[at] = aj ^ bj ^ c;
      c = (aj & bj) | (bj & c) | (c & aj);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bitserial_lt_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, long long n, int n_bits,
                    uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += stride) {
    uint32_t lt = 0u, eq = 0xffffffffu;
#pragma unroll 4
    for (int j = n_bits - 1; j >= 0; --j) {   // MSB first
      const long long at = static_cast<long long>(j) * n + idx;
      const uint32_t aj = __ldg(a + at);
      const uint32_t bj = __ldg(b + at);
      lt |= eq & ~aj & bj;
      eq &= ~(aj ^ bj);
    }
    out[idx] = lt;
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// a, b, out: (n_bits, n) words, plane j at j * n. sub: 0 add, 1 subtract.
// Returns a cudaError_t.
extern "C" int bitserial_add_launch(const void* a, const void* b, int n_bits,
                                    long long n, int sub, void* out,
                                    void* stream) {
  bitserial_add_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n,
      n_bits, sub ? 0xffffffffu : 0u, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a, b: (n_bits, n) words, plane j at j * n; out: (n,) words.
// Returns a cudaError_t.
extern "C" int bitserial_lt_launch(const void* a, const void* b, int n_bits,
                                   long long n, void* out, void* stream) {
  bitserial_lt_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n,
      n_bits, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
