// 32x32 bit transpose for Hopper (sm_90a): horizontal integer values ->
// BitWeaving-V bit planes.
//
// Replaces: src/repro/kernels/bittranspose.py::bit_transpose_kernel (the
// Pallas 5-stage masked-swap butterfly), reached through
// ops/transpose.to_vertical when a column is registered.
// Plain version: src/repro_torch/kernels/ref.py::bit_transpose.
//
// Convention (LSB-first): out[w, g] bit i == bit w of values[32*g + i].
//
// What bounds it on this card: bytes. Each value is read once (4 B) and
// each plane word written once (n_bits/32 * 4 B per value); the work per
// value is one warp vote per plane.
//
// Design. A warp vote does the transpose: with lane i holding
// values[32g + i], __ballot_sync(~0u, (v >> w) & 1) is exactly out[w, g].
// Each warp walks 32 consecutive groups; after group k, lane k keeps that
// group's n_bits ballots in registers. At the end lane i stores plane w of
// group g0 + i, so every load and every store of the warp covers 32
// consecutive words (128 B). No shared memory, no barrier.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bit_transpose_kernel(const uint32_t* __restrict__ values,
                                     long long n_groups, int n_bits,
                                     uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long g0 = warp * 32;
  if (g0 >= n_groups) return;                  // uniform across the warp
  uint32_t mine[32];
#pragma unroll
  for (int w = 0; w < 32; ++w) mine[w] = 0u;
  for (int k = 0; k < 32; ++k) {
    const long long g = g0 + k;
    const uint32_t v = g < n_groups ? values[g * 32 + lane] : 0u;
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w < n_bits) {
        const uint32_t plane_word = __ballot_sync(0xffffffffu, (v >> w) & 1u);
        if (lane == k) mine[w] = plane_word;
      }
    }
  }
  const long long g = g0 + lane;
  if (g < n_groups) {
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w < n_bits) out[w * n_groups + g] = mine[w];
    }
  }
}

}  // namespace

// values: (32 * n_groups,) words; out: (n_bits, n_groups) words.
// Returns a cudaError_t.
extern "C" int bit_transpose_launch(const void* values, long long n_groups,
                                    int n_bits, void* out, void* stream) {
  const long long warps = (n_groups + 31) / 32;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  bit_transpose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), n_groups, n_bits,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
