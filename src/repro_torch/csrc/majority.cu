// Majority of k packed bit-planes against a threshold for Hopper (sm_90a):
// the paper's triple-row activation lifted to k operands.
//
// Replaces: src/repro/kernels/majority.py::majority_kernel (Pallas: a
// carry-save counter of ceil(log2(k+1)) planes held in vector registers,
// k unrolled at trace time), reached through kernels/ops.py::majority and
// core/errors.py::vote_outputs (the reliability vote of the query
// service). Plain version: src/repro_torch/kernels/ref.py::majority_k.
//
// What bounds it on this card: bytes. Each of the k input planes is read
// once and the result written once, (k + 1) * 4 bytes per word position,
// against about 2k + 3 * ceil(log2(k+1)) logic instructions per word.
//
// Design. One thread owns V consecutive word positions (grid-stride
// loop): V = 4, one 16-byte load per plane, when the word count is a
// multiple of 4 and both pointers are 16-byte aligned, else V = 1. The
// thread streams the k planes once, kBatch planes at a time with every
// load of a batch issued before the first add, and ripple-adds each into
// an LSB-first counter of n_planes bit-planes kept in registers (n_planes
// = ceil(log2(k+1)), at most kMaxPlanes); then it compares the counter
// with the threshold MSB first, as the reference's _csa_add_bit /
// _ge_const do. k and the threshold are launch arguments, so one build
// serves every vote; the counter width is a template argument (one
// instantiation per width), so a thread holds only the counter planes
// its k needs and the card keeps more threads, and loads, in flight. A threshold <= 0 gives all ones and one above k all
// zeros; the counter never sees such a threshold (the reference kernel
// would compare against its low n_planes bits only).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
// counter width cap: k <= 2**kMaxPlanes - 1
constexpr int kMaxPlanes = 8;
// plane loads in flight per thread before the first add
constexpr int kBatch = 4;

template <int V>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else {
    w[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    p[0] = w[0];
  }
}

template <int V, int NP>
__global__ void __launch_bounds__(kThreads)
majority_kernel(const uint32_t* __restrict__ planes, long long n, int k,
                int threshold, uint32_t* __restrict__ out) {
  const long long units = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  if (threshold <= 0 || threshold > k) {
    const uint32_t fill = threshold <= 0 ? 0xffffffffu : 0u;
    uint32_t w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = fill;
    for (; u < units; u += stride) store<V>(out + u * V, w);
    return;
  }
  for (; u < units; u += stride) {
    uint32_t counter[NP][V];
#pragma unroll
    for (int s = 0; s < NP; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) counter[s][v] = 0u;
    }
    for (int i0 = 0; i0 < k; i0 += kBatch) {
      uint32_t w[kBatch][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < k) {
          load<V>(planes + static_cast<long long>(i0 + j) * n + u * V, w[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < k) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            uint32_t carry = w[j][v];
#pragma unroll
            for (int s = 0; s < NP; ++s) {
              const uint32_t t = counter[s][v];
              counter[s][v] = t ^ carry;
              carry = t & carry;
            }
          }
        }
      }
    }
    uint32_t result[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint32_t ge = 0u, eq = 0xffffffffu;
#pragma unroll
      for (int j = NP - 1; j >= 0; --j) {
        const uint32_t tj = ((threshold >> j) & 1) ? 0xffffffffu : 0u;
        ge |= eq & counter[j][v] & ~tj;
        eq &= ~(counter[j][v] ^ tj);
      }
      result[v] = ge | eq;
    }
    store<V>(out + u * V, result);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int V>
void launch(int n_planes, unsigned blocks, cudaStream_t s,
            const uint32_t* p, long long n, int k, int threshold,
            uint32_t* o) {
  switch (n_planes) {
#define MAJORITY_CASE(NP)                                              \
    case NP:                                                           \
      majority_kernel<V, NP><<<blocks, kThreads, 0, s>>>(p, n, k,      \
                                                       threshold, o);  \
      break;
    MAJORITY_CASE(1) MAJORITY_CASE(2) MAJORITY_CASE(3) MAJORITY_CASE(4)
    MAJORITY_CASE(5) MAJORITY_CASE(6) MAJORITY_CASE(7) MAJORITY_CASE(8)
#undef MAJORITY_CASE
  }
}

}  // namespace

// planes: (k, n) words, plane i at planes + i * n; out: (n,) words.
// n_planes: the counter width, ceil(log2(k + 1)) in 1..8.
// Returns a cudaError_t.
extern "C" int majority_launch(const void* planes, int k, long long n,
                               int n_planes, int threshold, void* out,
                               void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || k < 0 ||
      k > (1 << n_planes) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = n % 4 == 0 && aligned16(planes) && aligned16(out);
  const long long units = vec ? n / 4 : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<uint32_t*>(out);
  if (vec) {
    launch<4>(n_planes, static_cast<unsigned>(blocks), s, p, n, k,
              threshold, o);
  } else {
    launch<1>(n_planes, static_cast<unsigned>(blocks), s, p, n, k,
              threshold, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
