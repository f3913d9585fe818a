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
// each plane word written once (n_bits/32 * 4 B per value).
//
// Design (both directions): lane l of a warp owns group g0 + l of 32
// consecutive groups, and the 32 x 32 bit block of a group is transposed
// in registers with the 5-stage masked-swap butterfly (Hacker's Delight
// 7-3, LSB-first): 80 swaps of about six instructions for 32 values, where
// one warp vote per value and plane would issue about five warp
// instructions a value. The 32 values of each group pass through a
// 32 x 33 shared tile (the odd row length keeps both passes free of bank
// conflicts), so every device access of the warp covers 128 consecutive
// bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// values -> planes: the warp's 32 loads of 128 consecutive bytes (value
// 32 (g0 + k) + lane, k = 0 .. 31) are all in flight before the first
// lands in the tile; lane l then reads its group's 32 values, transposes
// them (a[w] = out[w, g0 + l]) and stores the n_bits planes asked for.
// 4-byte loads take a base at any word offset.
__global__ void __launch_bounds__(kThreads)
bit_transpose_kernel(const uint32_t* __restrict__ values,
                     long long n_groups, int n_bits,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kThreads / 32][32][33];
  const int lane = threadIdx.x & 31;
  uint32_t(*t)[33] = tile[threadIdx.x >> 5];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long g0 = warp * 32;
  if (g0 >= n_groups) return;                  // uniform across the warp
  const long long n_here = n_groups - g0 < 32 ? n_groups - g0 : 32;
  const uint32_t* src = values + g0 * 32 + lane;
  uint32_t a[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = k < n_here ? __ldg(src + 32 * k) : 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) t[k][lane] = a[k];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = t[lane][i];
  transpose32(a);                              // a[w]: plane w of g0 + lane
  const long long g = g0 + lane;
  if (g < n_groups) {
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w < n_bits) out[w * n_groups + g] = a[w];
    }
  }
}

// The inverse: n_bits <= 32 planes -> 32 values per group, the planes at
// and above n_bits reading as zero. Bounded by bytes too (each of the
// n_bits plane words read once, each value written once: (n_bits + 32) / 32
// * 4 bytes a value).
//
// Planes -> values: lane l loads its group's n_bits plane words (each
// load of the warp covers 128 consecutive bytes), transposes them, and the
// tile turns each group's 32 values into one 128-byte store of the warp.
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
