// 32x32 bit transpose for Hopper (sm_90a): horizontal integer values ->
// BitWeaving-V bit planes, and back.
//
// Replaces: src/repro/kernels/bittranspose.py::bit_transpose_kernel (the
// Pallas 5-stage masked-swap butterfly), reached through
// ops/transpose.to_vertical when a column is registered, and
// ::bit_untranspose_kernel (the same butterfly on the transposed block),
// reached through ops/transpose.from_vertical.
// Plain versions: src/repro_torch/kernels/ref.py::bit_transpose and
// ::bit_untranspose.
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

// The inverse: n_bits <= 32 planes -> 32 values per group, the planes at
// and above n_bits reading as zero. Bounded by bytes too (each of the
// n_bits plane words read once, each value written once: (n_bits + 32) / 32
// * 4 bytes a value).
//
// Design: lane l of a warp owns group g0 + l of 32 consecutive groups. It
// loads that group's 32 plane words into registers (for each plane the
// warp reads 32 consecutive words, 128 B) and transposes the 32 x 32 bit
// block in place with the 5-stage masked-swap butterfly (Hacker's Delight
// 7-3, LSB-first): 80 swaps of about six instructions for 32 values,
// where one warp vote per value would issue about five warp instructions
// a value. The 32 values of each group then go through a 32 x 33 shared
// tile (the odd row length keeps both passes free of bank conflicts), so
// each store of the warp writes one group's 32 values as 128 consecutive
// bytes.
template <int J, uint32_t M>
__device__ __forceinline__ void swap_stage(uint32_t (&a)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & J) == 0) {
      const uint32_t t = ((a[k] >> J) ^ a[k + J]) & M;
      a[k] ^= t << J;
      a[k + J] ^= t;
    }
  }
}

// a[j] bit i -> a[i] bit j
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  swap_stage<16, 0x0000ffffu>(a);
  swap_stage<8, 0x00ff00ffu>(a);
  swap_stage<4, 0x0f0f0f0fu>(a);
  swap_stage<2, 0x33333333u>(a);
  swap_stage<1, 0x55555555u>(a);
}

__global__ void __launch_bounds__(kThreads)
bit_untranspose_kernel(const uint32_t* __restrict__ planes,
                       long long n_groups, int n_bits,
                       uint32_t* __restrict__ values) {
  __shared__ uint32_t tile[kThreads / 32][32][33];
  const int lane = threadIdx.x & 31;
  uint32_t(*t)[33] = tile[threadIdx.x >> 5];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long g0 = warp * 32;
  if (g0 >= n_groups) return;                  // uniform across the warp
  const long long mine = g0 + lane;
  uint32_t a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[j] = j < n_bits && mine < n_groups
               ? __ldg(planes + j * n_groups + mine)
               : 0u;
  }
  transpose32(a);                              // a[i]: value 32 * mine + i
#pragma unroll
  for (int i = 0; i < 32; ++i) t[lane][i] = a[i];
  __syncwarp();
  const long long n_here = n_groups - g0 < 32 ? n_groups - g0 : 32;
  for (int k = 0; k < n_here; ++k) {
    values[(g0 + k) * 32 + lane] = t[k][lane];
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

// planes: (n_bits, n_groups) words; values: (32 * n_groups,) words.
// Returns a cudaError_t.
extern "C" int bit_untranspose_launch(const void* planes, long long n_groups,
                                      int n_bits, void* values,
                                      void* stream) {
  const long long warps = (n_groups + 31) / 32;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  bit_untranspose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), n_groups, n_bits,
      static_cast<uint32_t*>(values));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
