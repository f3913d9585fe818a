// Opcode-table VM for Hopper (sm_90a): one launch runs a whole lowered
// AAP program over a batch of subarray planes.
//
// Replaces: src/repro/kernels/vm.py::_vm_call (Pallas body _vm_kernel),
// reached through vm_megakernel / core.lowering.execute_lowered.
// Plain version: src/repro_torch/kernels/vm.py::vm_plain (same arguments,
// bit-identical results).
//
// What bounds it on this card. Every command is column-local: word c of
// every row depends only on word c of the rows it reads. Per word the
// kernel reads each seeded row once and writes each output row once (or
// nothing, in count mode), while it performs one sense-and-write step per
// command. Short programs (an OR tree) are bound by the bytes read. Long
// ones (an 8-bit ripple adder, ~130 commands) are bound on chip: the rows
// live in shared memory (128 B a clock per SM), and each command reads
// its sources there, runs one 3-input majority a word on the SM's integer
// pipe (64 lanes) and writes its results back. With fault masks every
// command also streams four mask rows from device memory, and the bytes
// bound again.
//
// Design. The host pre-decodes the table once per plan (kernels/vm.py::
// decode; tests/test_torch_vm.py runs the encoded words through a numpy
// interpreter): constant sources fold away, dead writes and commands go,
// the rows a tile needs are renumbered into slots with their offsets
// scaled, and a one-source command becomes maj3(x, 0, ~0). Each command
// is then branch-free: up to three predicated 16-byte shared loads, one
// LOP3 a word per source for its polarity, one for the majority, and its
// writes (a uniform loop). The launch is a persistent grid of one wave of
// thread blocks; block i takes tiles i, i + grid, ..., so the blocks on
// the card at a time stream neighbouring columns. Thread t owns K words of
// every slot row of a tile (two 16-byte quads 4 x threads words apart at
// K = 8), so every shared access is its own, 128-bit and conflict-free,
// and no barrier is needed between commands. All of a tile's seeded rows
// are copied in at once with cp.async (rows whose device address is not
// 16-byte aligned, and the ragged tail, word by word); while one block
// waits on its copies the others on the SM run commands. Count mode
// popcounts each output word, reduces across the warp into one shared
// int32 per output, and adds one int32 per (block, batch slice, output)
// into the (batch, n_out) result with atomicAdd: integer sums are exact
// in any order. Materialize mode stores 16 bytes a quad where the output
// row is aligned. With fault masks a thread owns one word (K = 1), the
// next command's masks load while the current one runs, and a source may
// be the previous command's value, kept in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// program words (kernels/vm.py::encode)
constexpr uint32_t kPol = 1u << 31;       // XOR the value with all-ones
constexpr uint32_t kReg = 1u << 30;       // the previous command's value
constexpr uint32_t kConst = 1u << 29;     // zero
constexpr uint32_t kDup = 1u << 28;       // the first source's value
constexpr uint32_t kSlot = kDup - 1u;     // scaled shared word offset
constexpr uint32_t kIndex = (1u << 18) - 1u;  // header: the table row
constexpr int kWritesShift = 18;              // header: words written

// The K words one thread owns in a row of a tile: one word (K = 1), or
// K / 4 quads of 16 bytes `qs` words apart (qs = 4 x the block's threads),
// so that each quad access of a warp covers 512 consecutive bytes.
template <int K>
struct Words {
  uint32_t w[K];
};

template <int K>
__device__ __forceinline__ Words<K> splat(uint32_t x) {
  Words<K> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.w[i] = x;
  return r;
}

// the word index of w[i] relative to the thread's first word
template <int K>
__device__ __forceinline__ long long offset_of(int i, int qs) {
  return K == 1 ? 0 : static_cast<long long>(i / 4) * qs + (i % 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared accesses as explicit 16-byte vector instructions (the compiler
// may otherwise split a store of four computed words into four 4-byte
// stores, each a 4-way bank conflict). Volatile, so they keep their order
// among themselves and with the copies; the program words, read with
// plain loads, are never written after the start.
template <int K>
__device__ __forceinline__ Words<K> lds(const uint32_t* p, int qs) {
  Words<K> r;
  if constexpr (K == 1) {
    asm volatile("ld.shared.u32 %0, [%1];\n"
                 : "=r"(r.w[0]) : "r"(smem_addr(p)));
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r.w[4 * j]), "=r"(r.w[4 * j + 1]),
                     "=r"(r.w[4 * j + 2]), "=r"(r.w[4 * j + 3])
                   : "r"(smem_addr(p + j * qs)));
    }
  }
  return r;
}

template <int K>
__device__ __forceinline__ void sts(uint32_t* p, int qs, const Words<K>& x) {
  if constexpr (K == 1) {
    asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(smem_addr(p)),
                 "r"(x.w[0]));
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::
                       "r"(smem_addr(p + j * qs)), "r"(x.w[4 * j]),
                   "r"(x.w[4 * j + 1]), "r"(x.w[4 * j + 2]),
                   "r"(x.w[4 * j + 3]));
    }
  }
}

// One flagged operand: a shared row of this thread's column, the
// previous command's value, the first operand's, or zero; then its
// polarity. Selects and a predicated load, no branch.
template <int K>
__device__ __forceinline__ Words<K> fetch(uint32_t src, const uint32_t* col,
                                          int qs, const Words<K>& prev,
                                          const Words<K>& first) {
  Words<K> x;
  const bool dup = src & kDup;
#pragma unroll
  for (int i = 0; i < K; ++i) x.w[i] = dup ? first.w[i] : prev.w[i];
  if (!(src & (kReg | kConst | kDup))) x = lds<K>(col + (src & kSlot), qs);
  const uint32_t keep = (src & kConst) ? 0u : ~0u;
  const uint32_t p = (src & kPol) ? ~0u : 0u;
#pragma unroll
  for (int i = 0; i < K; ++i) x.w[i] = (x.w[i] & keep) ^ p;
  return x;
}

// A source without fault masks: a shared row of this thread's column or
// zero (the load predicated off); the decoder inverts only the first
// source of a command, one LOP3 a word.
template <int K, bool kFirst>
__device__ __forceinline__ Words<K> operand(uint32_t src, const uint32_t* col,
                                            int qs) {
  Words<K> x = splat<K>(0u);
  if (!(src & kConst)) x = lds<K>(col + (src & kSlot), qs);
  if constexpr (kFirst) {
    const uint32_t p = (src & kPol) ? ~0u : 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) x.w[i] ^= p;
  }
  return x;
}

template <int K>
__device__ __forceinline__ void put(uint32_t dst, uint32_t* col, int qs,
                                    const Words<K>& v) {
  const uint32_t p = (dst & kPol) ? ~0u : 0u;
  Words<K> x;
#pragma unroll
  for (int i = 0; i < K; ++i) x.w[i] = v.w[i] ^ p;
  sts<K>(col + (dst & kSlot), qs, x);
}

// this thread's words of a W-word device row, zero past W
template <int K>
__device__ __forceinline__ Words<K> ldg(const uint32_t* __restrict__ row,
                                        long long w0, long long W, int qs) {
  Words<K> r;
  if constexpr (K == 1) {
    r.w[0] = w0 < W ? __ldg(row + w0) : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const long long wj = w0 + static_cast<long long>(j) * qs;
      const uint32_t* p = row + wj;
      if (wj + 4 <= W && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        r.w[4 * j] = q.x; r.w[4 * j + 1] = q.y;
        r.w[4 * j + 2] = q.z; r.w[4 * j + 3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r.w[4 * j + i] = wj + i < W ? __ldg(p + i) : 0u;
        }
      }
    }
  }
  return r;
}

template <int K>
__device__ __forceinline__ void stg(uint32_t* __restrict__ row, long long w0,
                                    long long W, int qs, const Words<K>& x) {
  if constexpr (K == 1) {
    if (w0 < W) row[w0] = x.w[0];
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const long long wj = w0 + static_cast<long long>(j) * qs;
      uint32_t* p = row + wj;
      if (wj + 4 <= W && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            x.w[4 * j], x.w[4 * j + 1], x.w[4 * j + 2], x.w[4 * j + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (wj + i < W) p[i] = x.w[4 * j + i];
        }
      }
    }
  }
}

// a 4-byte asynchronous copy, zero-filled when the word lies past the row
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* row,
                                          long long w, long long W) {
  const bool in = w < W;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(in ? row + w : row),
                   "r"(in ? 4 : 0));
}

// Copy this thread's words of a W-word device row into shared memory
// asynchronously, zero-filling past W: one 16-byte copy a quad where it
// is 16-byte aligned, else one 4-byte copy a word. `row` itself is the
// source of a copy that reads nothing, so no address past the row goes to
// the copy engine.
template <int K>
__device__ __forceinline__ void load_async(uint32_t* dst,
                                           const uint32_t* row, long long w0,
                                           long long W, int qs) {
  if constexpr (K == 1) {
    copy_word(dst, row, w0, W);
  } else {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const long long wj = w0 + static_cast<long long>(j) * qs;
      const uint32_t* p = row + wj;
      if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
        // wj is a multiple of 4 words, so `row` is 16-byte aligned too
        const long long n = W - wj;
        const int bytes = n >= 4 ? 16 : n > 0 ? static_cast<int>(4 * n) : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                         "r"(smem_addr(dst + j * qs)), "l"(bytes ? p : row),
                         "r"(bytes));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          copy_word(dst + j * qs + i, row, wj + i, W);
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct VmArgs {
  const int32_t* prog;        // encoded program (kernels/vm.py::encode)
  int prog_ints, n_load, n_out, n_cslots;
  const uint32_t* plane;      // (batch, n_in, W)
  int batch, n_in;
  long long W;
  const uint32_t* errors;     // NULL or (batch, 4 * n_cmds, W)
  int n_cmds;
  const uint32_t* mask;       // NULL or (1 | batch, W); count mode only
  int mask_per_batch;
  int mask_off;               // the mask row's word offset in a tile
  int tile_words;             // the tile: rows x threads x K words
  uint32_t* out_words;        // (batch, n_out, W)
  int32_t* out_counts;        // (batch, n_out), zeroed by the caller
};

__host__ __device__ constexpr int round4(int n) {
  return (n + 3) & ~3;
}

template <bool kCount, int K, bool kFaults>
__global__ void __launch_bounds__(256) vm_kernel(const VmArgs a) {
  extern __shared__ int4 smem[];
  int32_t* s_prog = reinterpret_cast<int32_t*>(smem);
  int32_t* s_count = s_prog + a.prog_ints;     // prog_ints % 4 == 0
  uint32_t* s_buf = reinterpret_cast<uint32_t*>(s_count + round4(a.n_out));
  const int2* s_loads = reinterpret_cast<const int2*>(s_prog);
  const uint32_t* s_outs =
      reinterpret_cast<const uint32_t*>(s_prog + round4(2 * a.n_load));
  const int4* s_cmds = reinterpret_cast<const int4*>(
      s_prog + round4(2 * a.n_load) + round4(a.n_out));

  const int t = threadIdx.x;
  const int threads = blockDim.x;
  for (int k = t; k < a.prog_ints / 4; k += threads) {
    smem[k] = reinterpret_cast<const int4*>(a.prog)[k];
  }
  if (kCount) {
    for (int k = t; k < a.n_out; k += threads) s_count[k] = 0;
  }
  __syncthreads();

  const long long W = a.W;
  const long long tile = static_cast<long long>(threads) * K;
  const long long n_tiles = (W + tile - 1) / tile;
  const long long n_items = n_tiles * a.batch;
  if (blockIdx.x >= n_items) return;          // uniform across the block
  const int qs = 4 * threads;
  const int tk = (K == 1 ? 1 : 4) * t;        // this thread's first word

  uint32_t* col = s_buf + tk;                 // this thread's column
  // all of a tile's seeded rows (and the mask row) in flight at once
  auto issue = [&](long long item) {
    const long long b = item / n_tiles;
    const long long w0 = (item - b * n_tiles) * tile + tk;
    for (int j = 0; j < a.n_load; ++j) {
      const int2 l = s_loads[j];
      load_async<K>(col + l.x, a.plane + (b * a.n_in + l.y) * W, w0, W, qs);
    }
    if (kCount && a.mask) {
      load_async<K>(col + a.mask_off,
                    a.mask + (a.mask_per_batch ? b * W : 0), w0, W, qs);
    }
    cp_async_commit();
  };

  // items blockIdx.x, + gridDim.x, ...: the blocks on the card at a time
  // work on neighbouring tiles, so each row streams in long runs
  const long long step = gridDim.x;
  issue(blockIdx.x);
  for (long long item = blockIdx.x; item < n_items; item += step) {
    cp_async_wait<0>();
    const long long b = item / n_tiles;
    const long long w0 = (item - b * n_tiles) * tile + tk;

    // The next command's header (and, with fault masks, its masks) is
    // loaded while this one runs; the slot past the last command lies in
    // the count slots, so reading it is harmless.
    Words<K> prev = splat<K>(0u);
    Words<K> e[4], e_next[4];
    int c = 0;
    int4 h = s_cmds[0];
    if (kFaults && a.n_cslots > 0) {
      const uint32_t* m = a.errors + (b * a.n_cmds + (h.x & kIndex)) * 4 * W;
#pragma unroll
      for (int q = 0; q < 4; ++q) e_next[q] = ldg<K>(m + q * W, w0, W, qs);
    }
    while (c < a.n_cslots) {
      const uint32_t hdr = static_cast<uint32_t>(h.x);
      const int n_writes = static_cast<int>(hdr >> kWritesShift);
      const int next = c + 1 + ((n_writes + 3) >> 2);
      const uint32_t first_write = static_cast<uint32_t>(s_cmds[c + 1].x);
      const int4 h_next = s_cmds[next];
      Words<K> s0, s1, s2;
      if constexpr (kFaults) {
#pragma unroll
        for (int q = 0; q < 4; ++q) e[q] = e_next[q];
        if (next < a.n_cslots) {
          const uint32_t* m =
              a.errors + (b * a.n_cmds + (h_next.x & kIndex)) * 4 * W;
#pragma unroll
          for (int q = 0; q < 4; ++q) e_next[q] = ldg<K>(m + q * W, w0, W, qs);
        }
        s0 = fetch<K>(h.y, col, qs, prev, prev);
        s1 = fetch<K>(h.z, col, qs, prev, s0);
        s2 = fetch<K>(h.w, col, qs, prev, s0);
      } else {
        s0 = operand<K, true>(h.y, col, qs);
        s1 = operand<K, false>(h.z, col, qs);
        s2 = operand<K, false>(h.w, col, qs);
      }
      Words<K> v;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        v.w[i] = (s0.w[i] & s1.w[i]) | (s1.w[i] & s2.w[i]) |
                 (s2.w[i] & s0.w[i]);
      }
      if constexpr (kFaults) {
        // TRA fault injection: the four pattern classes partition the
        // bits, so exactly one class mask applies per bit
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const uint32_t ones3 = s0.w[i] & s1.w[i] & s2.w[i];
          const uint32_t lit = s0.w[i] | s1.w[i] | s2.w[i];
          v.w[i] ^= (e[0].w[i] & ~lit) | (e[1].w[i] & (lit & ~v.w[i])) |
                    (e[2].w[i] & (v.w[i] & ~ones3)) | (e[3].w[i] & ones3);
        }
      }
      // nearly every command writes one row or none
      if (n_writes > 0) put<K>(first_write, col, qs, v);
      const uint32_t* more = reinterpret_cast<const uint32_t*>(s_cmds + c + 1);
      for (int k = 1; k < n_writes; ++k) put<K>(more[k], col, qs, v);
      prev = v;
      h = h_next;
      c = next;
    }

    if (!kCount) {
      for (int k = 0; k < a.n_out; ++k) {
        stg<K>(a.out_words + (b * a.n_out + k) * W, w0, W, qs,
               fetch<K>(s_outs[k], col, qs, prev, prev));
      }
    } else {
      Words<K> m = a.mask ? lds<K>(col + a.mask_off, qs) : splat<K>(~0u);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (w0 + offset_of<K>(i, qs) >= W) m.w[i] = 0u;  // pad words
      }
      for (int k = 0; k < a.n_out; ++k) {
        const Words<K> x = fetch<K>(s_outs[k], col, qs, prev, prev);
        unsigned n = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) n += __popc(x.w[i] & m.w[i]);
        n = __reduce_add_sync(0xffffffffu, n);
        if ((t & 31) == 0 && n) atomicAdd(&s_count[k], static_cast<int>(n));
      }
      if (item + step >= n_items || (item + step) / n_tiles != b) {
        __syncthreads();                       // this slice's last tile
        for (int k = t; k < a.n_out; k += threads) {
          if (s_count[k]) {
            atomicAdd(&a.out_counts[b * a.n_out + k], s_count[k]);
            s_count[k] = 0;
          }
        }
        __syncthreads();
      }
    }
    if (item + step < n_items) issue(item + step);
  }
}

template <bool kCount, int K, bool kFaults>
cudaError_t launch(const VmArgs& a, int threads, cudaStream_t stream) {
  const auto kernel = vm_kernel<kCount, K, kFaults>;
  const size_t smem = sizeof(int32_t) * (a.prog_ints + round4(a.n_out)) +
                      sizeof(uint32_t) * static_cast<size_t>(a.tile_words);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0, device = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess ||
      (e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess) {
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tile = static_cast<long long>(threads) * K;
  const long long items = (a.W + tile - 1) / tile * a.batch;
  const long long wave = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(items < wave ? items : wave);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// prog: `prog_ints` int32 words from kernels/vm.py::encode (`n_load`
// loads, `n_out` outputs, `n_cslots` 16-byte command slots). plane:
// (batch, n_in, W) words; errors: NULL or (batch, 4*n_cmds, W); mask:
// NULL or (1|batch, W), read in count mode at word offset `mask_off` of a
// shared tile of `tile_words` words. out: (batch, n_out, W) words, or
// (batch, n_out) int32 counts (zeroed by the caller) when count_mode != 0.
// A block is `threads` threads of `words` words each: 1, 4 or 8 without
// fault masks, 1 with them. Returns a cudaError_t.
extern "C" int vm_launch(const void* prog, int prog_ints, int n_load,
                         int n_out, int n_cslots, const void* plane,
                         int batch, int n_in, long long W, const void* errors,
                         int n_cmds, const void* mask, int mask_per_batch,
                         int mask_off, int tile_words, void* out,
                         int count_mode, int threads, int words,
                         void* stream) {
  VmArgs a;
  a.prog = static_cast<const int32_t*>(prog);
  a.prog_ints = prog_ints;
  a.n_load = n_load;
  a.n_out = n_out;
  a.n_cslots = n_cslots;
  a.plane = static_cast<const uint32_t*>(plane);
  a.batch = batch;
  a.n_in = n_in;
  a.W = W;
  a.errors = static_cast<const uint32_t*>(errors);
  a.n_cmds = n_cmds;
  a.mask = static_cast<const uint32_t*>(mask);
  a.mask_per_batch = mask_per_batch;
  a.mask_off = mask_off;
  a.tile_words = tile_words;
  a.out_words = static_cast<uint32_t*>(out);
  a.out_counts = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  const bool c = count_mode != 0;
  if (errors) {
    if (words == 1) {
      rc = c ? launch<true, 1, true>(a, threads, s)
             : launch<false, 1, true>(a, threads, s);
    }
  } else if (words == 8) {
    rc = c ? launch<true, 8, false>(a, threads, s)
           : launch<false, 8, false>(a, threads, s);
  } else if (words == 4) {
    rc = c ? launch<true, 4, false>(a, threads, s)
           : launch<false, 4, false>(a, threads, s);
  } else if (words == 1) {
    rc = c ? launch<true, 1, false>(a, threads, s)
           : launch<false, 1, false>(a, threads, s);
  }
  return static_cast<int>(rc);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
