// Fused BitWeaving-V between-scan for Hopper (sm_90a): the packed result
// of c1 <= v <= c2 over a column stored as vertical bit planes.
//
// Replaces: src/repro/kernels/bitweaving.py::bitweaving_scan_kernel
// (Pallas: one (b, 2048) plane block per grid step, the four comparison
// states in vector registers, c1 / c2 / n_bits baked in at trace time),
// reached through kernels/ops.py::bitweaving_scan and
// ops/predicate.py::between_scan / VerticalColumn.scan.
// Plain version: src/repro_torch/kernels/ref.py::bitweaving_scan.
//
// Plane layout: (b, g) words, row-major, plane 0 = LSB; bit i of word k
// of plane j is bit j of value 32k + i. The scan walks MSB -> LSB.
//
// What bounds it on this card: bytes. Each of the n_bits planes is read
// once and one result word is written per 32 values, (n_bits + 1) * 4
// bytes per output word, against about four logic instructions per plane
// word.
//
// Design. One thread owns one output word: it walks planes n_bits-1 .. 0
// keeping lt1 / eq1 / lt2 / eq2 in registers, so no intermediate plane
// reaches device memory. Neighbouring threads own neighbouring words, so
// every plane read of a warp is one 128-byte line. c1, c2 and n_bits are
// launch arguments, so one build serves every query; bits of c1 / c2 at
// or above n_bits are never read, as in the reference's loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitweaving_scan_kernel(const uint32_t* __restrict__ planes, long long g,
                       int n_bits, unsigned long long c1,
                       unsigned long long c2, uint32_t* __restrict__ out) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= g) return;
  uint32_t lt1 = 0u, eq1 = ~0u, lt2 = 0u, eq2 = ~0u;
#pragma unroll 4
  for (int j = n_bits - 1; j >= 0; --j) {
    const uint32_t p = __ldg(planes + static_cast<long long>(j) * g + k);
    const uint32_t c1j = ((c1 >> j) & 1ull) ? ~0u : 0u;
    const uint32_t c2j = ((c2 >> j) & 1ull) ? ~0u : 0u;
    lt1 |= eq1 & ~p & c1j;
    eq1 &= ~(p ^ c1j);
    lt2 |= eq2 & ~p & c2j;
    eq2 &= ~(p ^ c2j);
  }
  out[k] = ~lt1 & (lt2 | eq2);
}

}  // namespace

// planes: n_bits planes of g words each (plane j at planes + j * g);
// out: g words. c1 / c2 are the bounds' low 64 bits; n_bits <= 64.
// Returns a cudaError_t.
extern "C" int bitweaving_scan_launch(const void* planes, long long g,
                                      int n_bits, unsigned long long c1,
                                      unsigned long long c2, void* out,
                                      void* stream) {
  const long long blocks = (g + kThreads - 1) / kThreads;
  bitweaving_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), g, n_bits, c1, c2,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
