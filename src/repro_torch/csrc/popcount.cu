// Total popcount of a run of words for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/popcount.py::popcount_kernel (Pallas: a SWAR
// popcount per (8, 2048) block into one int32 partial per grid cell, the
// partials summed by XLA), reached through kernels/ops.py::popcount.
// Plain version: src/repro_torch/kernels/ref.py::popcount.
//
// What bounds it on this card: bytes. Every word is read once (4 bytes)
// against two integer instructions (POPC and an add); the output is one
// 8-byte total.
//
// Design. A TPU grid runs in order and can sum partials afterwards; CUDA
// blocks run in no order, so each thread counts its words with __popc in
// a grid-stride loop (a uint4 per step when the run is 16-byte aligned),
// the warp sums with shuffles, the CTA sums its warps in shared memory,
// and one thread per CTA adds the CTA's total to the 64-bit result with
// one atomicAdd. Integer addition is exact in any order, so the result is
// the plain version's, and it cannot wrap below 2^64 set bits (the
// reference's int32 total wraps at 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
popcount_kernel(const uint32_t* __restrict__ words, long long n, int vec,
                unsigned long long* __restrict__ total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned long long mine = 0;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 x = __ldg(w4 + i);
      mine += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) {
    mine += __popc(__ldg(words + i));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mine += __shfl_down_sync(0xffffffffu, mine, off);
  }
  __shared__ unsigned long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    unsigned long long v = lane < kWarps ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) atomicAdd(total, v);
  }
}

}  // namespace

// words: n words; total: one zeroed 64-bit counter the kernel adds to.
// Returns a cudaError_t.
extern "C" int popcount_launch(const void* words, long long n, void* total,
                               void* stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(words) & 15u) == 0;
  const long long units = vec ? n / 4 + n % 4 : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  popcount_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, vec ? 1 : 0,
      static_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
