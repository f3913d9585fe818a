// Sign pack / unpack for Hopper (sm_90a): the 32:1 gradient compression of
// majority-vote signSGD.
//
// Replaces: src/repro/kernels/signpack.py::pack_signs_kernel ((r, 32 w)
// float -> (r, w) uint32, bit i of a word = the IEEE sign bit of lane i,
// by a bitcast and a shift-or tree over (8, 512-word) VMEM blocks) and
// unpack_signs_kernel ((r, w) words -> (r, 32 w) {+1, -1}, bit 1 -> -1),
// reached through optim/signum.py's pack_tree / unpack_tree on both sides
// of the compressed majority all-reduce. Plain versions: src/repro_torch/
// kernels/ref.py::pack_signs and unpack_signs.
//
// What bounds them on this card: bytes. Pack reads 32 lanes (128 bytes in
// float32, 64 in bf16) per 4-byte word written; unpack the reverse. One
// sign test or select per lane is far below the card's integer rate.
//
// Design. A contiguous (r, 32 w) input is one flat run of 32 N lanes for N
// = r w words (row j's word i is flat word j w + i), so both kernels walk
// flat words and the row structure costs nothing. One warp handles 32
// consecutive words at a time: pack reads lane l of word j at 32 j + l (32
// coalesced loads, one per word), and __ballot_sync of the sign bits gives
// word j directly (bit l = lane l's predicate); lane j stores word j.
// Unpack loads the 32 words coalesced, broadcasts each with __shfl_sync,
// and lane l writes element 32 j + l: coalesced stores. The sign is the
// raw bit (-0.0 and negative NaNs give 1), as the reference's bitcast and
// jnp.signbit do; a grid-stride loop covers any N, and a ragged last group
// of words is masked.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ bool sign_bit(T x);

template <>
__device__ __forceinline__ bool sign_bit<float>(float x) {
  return (__float_as_uint(x) >> 31) != 0u;
}

template <>
__device__ __forceinline__ bool sign_bit<__nv_bfloat16>(__nv_bfloat16 x) {
  return (__bfloat16_as_ushort(x) >> 15) != 0u;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_signs_kernel(const T* __restrict__ x, uint32_t* __restrict__ out,
                  long long n_words) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long w0 = (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                       threadIdx.x / 32) * 32;
       w0 < n_words; w0 += warps * 32) {
    const int n = n_words - w0 < 32 ? static_cast<int>(n_words - w0) : 32;
    uint32_t mine = 0u;
    for (int j = 0; j < n; ++j) {
      const uint32_t word =
          __ballot_sync(0xffffffffu, sign_bit<T>(x[(w0 + j) * 32 + lane]));
      if (lane == j) mine = word;
    }
    if (lane < n) out[w0 + lane] = mine;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unpack_signs_kernel(const uint32_t* __restrict__ words, T* __restrict__ out,
                    long long n_words) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const T plus = from_float<T>(1.f), minus = from_float<T>(-1.f);
  for (long long w0 = (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                       threadIdx.x / 32) * 32;
       w0 < n_words; w0 += warps * 32) {
    const int n = n_words - w0 < 32 ? static_cast<int>(n_words - w0) : 32;
    const uint32_t mine = lane < n ? words[w0 + lane] : 0u;
    for (int j = 0; j < n; ++j) {
      const uint32_t word = __shfl_sync(0xffffffffu, mine, j);
      out[(w0 + j) * 32 + lane] = (word >> lane) & 1u ? minus : plus;
    }
  }
}

int grid_for(long long n_words) {
  // enough warps to cover the words once, capped near 16 CTAs per SM
  const long long groups = (n_words + 31) / 32;
  const long long ctas = (groups + kThreads / 32 - 1) / (kThreads / 32);
  return static_cast<int>(ctas < 2112 ? ctas : 2112);
}

}  // namespace

// x: n_words * 32 contiguous float32 (dtype 0) or bfloat16 (dtype 1) lanes
// -> out: n_words uint32 words. Returns a cudaError_t.
extern "C" int pack_signs_launch(const void* x, void* out, long long n_words,
                                 int dtype, void* stream) {
  if (n_words < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (dtype == 0) {
    pack_signs_kernel<float><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const float*>(x), o, n_words);
  } else {
    pack_signs_kernel<__nv_bfloat16><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: n_words contiguous uint32 -> out: n_words * 32 lanes of {+1, -1}
// in float32 (dtype 0) or bfloat16 (dtype 1). Returns a cudaError_t.
extern "C" int unpack_signs_launch(const void* words, void* out,
                                   long long n_words, int dtype,
                                   void* stream) {
  if (n_words < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  if (dtype == 0) {
    unpack_signs_kernel<float><<<grid_for(n_words), kThreads, 0, s>>>(
        w, static_cast<float*>(out), n_words);
  } else {
    unpack_signs_kernel<__nv_bfloat16><<<grid_for(n_words), kThreads, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(out), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
