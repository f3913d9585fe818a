// Fused bulk bitwise operations for Hopper (sm_90a): and, or, xor, nand,
// nor, xnor, andnot, not and 3-input majority in one pass over the words.
//
// Replaces: src/repro/kernels/bitwise.py::bitwise_kernel and
// ::banked_bitwise_kernel (Pallas, (8, 2048) VMEM tiles on a row x column
// grid; the banked variant puts the bank on the leading grid axis),
// reached through kernels/ops.py::bitwise / ::bitwise_banked and
// ops/bitwise.py. Plain version: src/repro_torch/kernels/ref.py::bitwise.
//
// What bounds it on this card: bytes. Each operand word is read once and
// each result word written once, (arity + 1) * 4 bytes per word, against
// one logic instruction (LOP3) per word.
//
// Design. An elementwise op does not care about layout, so the words of
// one bank are walked as one flat run. When every pointer is 16-byte
// aligned and a bank's run is a multiple of 4 words, each thread moves a
// uint4 (16 bytes) per operand per step of a grid-stride loop; otherwise
// one word per step. The ragged tail of a vector run (under 4 words) is
// done word by word. Grid axis y is the bank, so a CTA never crosses
// banks, as the reference's grid does not. The op is a template argument:
// one instantiation per op, picked by the launch function.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// CTAs per bank; the grid-stride loop covers longer runs
constexpr long long kMaxBlocksPerBank = 132 * 16;

enum Op : int {
  kAnd = 0, kOr, kXor, kNand, kNor, kXnor, kAndnot, kNot, kMaj3
};

template <int OP>
__host__ __device__ constexpr int arity() {
  return OP == kNot ? 1 : (OP == kMaj3 ? 3 : 2);
}

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b,
                                          uint32_t c) {
  if constexpr (OP == kAnd) return a & b;
  else if constexpr (OP == kOr) return a | b;
  else if constexpr (OP == kXor) return a ^ b;
  else if constexpr (OP == kNand) return ~(a & b);
  else if constexpr (OP == kNor) return ~(a | b);
  else if constexpr (OP == kXnor) return ~(a ^ b);
  else if constexpr (OP == kAndnot) return a & ~b;
  else if constexpr (OP == kNot) return ~a;
  else return (a & b) | (b & c) | (c & a);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
bitwise_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
               long long bank_words, int vec) {
  constexpr int kArity = arity<OP>();
  const long long base = static_cast<long long>(blockIdx.y) * bank_words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  a += base;
  if constexpr (kArity >= 2) b += base;
  if constexpr (kArity >= 3) c += base;
  out += base;
  long long done = 0;
  if (vec) {
    const long long n4 = bank_words >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 x = __ldg(a4 + i);
      uint4 y = make_uint4(0u, 0u, 0u, 0u), z = y;
      if constexpr (kArity >= 2) y = __ldg(b4 + i);
      if constexpr (kArity >= 3) z = __ldg(c4 + i);
      uint4 r;
      r.x = apply<OP>(x.x, y.x, z.x);
      r.y = apply<OP>(x.y, y.y, z.y);
      r.z = apply<OP>(x.z, y.z, z.z);
      r.w = apply<OP>(x.w, y.w, z.w);
      o4[i] = r;
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < bank_words; i += stride) {
    const uint32_t x = __ldg(a + i);
    uint32_t y = 0u, z = 0u;
    if constexpr (kArity >= 2) y = __ldg(b + i);
    if constexpr (kArity >= 3) z = __ldg(c + i);
    out[i] = apply<OP>(x, y, z);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int OP>
int launch(const void* a, const void* b, const void* c, void* out,
           int n_banks, long long bank_words, cudaStream_t stream) {
  constexpr int kArity = arity<OP>();
  const bool vec = bank_words % 4 == 0 && aligned16(a) && aligned16(out)
      && (kArity < 2 || aligned16(b)) && (kArity < 3 || aligned16(c));
  const long long units = vec ? bank_words / 4 : bank_words;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerBank) blocks = kMaxBlocksPerBank;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_banks));
  bitwise_kernel<OP><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out),
      bank_words, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 and, 1 or, 2 xor, 3 nand, 4 nor, 5 xnor, 6 andnot, 7 not, 8 maj3.
// a, b, c: n_banks * bank_words words each (b, c NULL where the op takes
// fewer operands); out: the same count. Bank k owns words
// [k * bank_words, (k + 1) * bank_words). Returns a cudaError_t.
extern "C" int bitwise_launch(int op, const void* a, const void* b,
                              const void* c, int n_banks,
                              long long bank_words, void* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAnd: return launch<kAnd>(a, b, c, out, n_banks, bank_words, s);
    case kOr: return launch<kOr>(a, b, c, out, n_banks, bank_words, s);
    case kXor: return launch<kXor>(a, b, c, out, n_banks, bank_words, s);
    case kNand: return launch<kNand>(a, b, c, out, n_banks, bank_words, s);
    case kNor: return launch<kNor>(a, b, c, out, n_banks, bank_words, s);
    case kXnor: return launch<kXnor>(a, b, c, out, n_banks, bank_words, s);
    case kAndnot:
      return launch<kAndnot>(a, b, c, out, n_banks, bank_words, s);
    case kNot: return launch<kNot>(a, b, c, out, n_banks, bank_words, s);
    case kMaj3: return launch<kMaj3>(a, b, c, out, n_banks, bank_words, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
