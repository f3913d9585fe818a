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
// command. Short programs (an OR tree) are bound by the bytes read; long
// ones (an 8-bit ripple adder, ~130 commands) by integer issue and
// shared-memory traffic: each step is a 3-input majority with polarity
// (one LOP3 after folding), three shared-memory loads and one or two
// stores.
//
// Design. One CTA per (batch slice, block of `block_cols` words), one
// thread per word column. The CTA copies its n_rows x block_cols plane tile
// into shared memory once, row-major, so thread t owns column t of every
// row: accesses are conflict-free, and no barrier is needed between
// commands because no thread reads another thread's column. The opcode
// table goes to shared memory once per CTA and every thread reads the same
// entry (a broadcast). Rows the caller did not seed start as constants
// (reset state or zero) and are never read from device memory. Count mode
// popcounts each output word (__popc), reduces across the warp and then
// the CTA in shared memory, and adds one int32 per (CTA, output) into the
// (batch, n_out) result with atomicAdd: integer sums are exact in any
// order, so the result is bit-identical to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kC1Row = 7;     // C1: all-ones in the subarray's reset state

template <bool kCount>
__global__ void vm_kernel(const int32_t* __restrict__ prog, int n_cmds,
                          int n_out, const uint32_t* __restrict__ plane,
                          int n_in, int n_rows, int first_row, int W,
                          const uint32_t* __restrict__ errors,
                          const uint32_t* __restrict__ mask, int mask_stride,
                          uint32_t* __restrict__ out_words,
                          int32_t* __restrict__ out_counts) {
  extern __shared__ int32_t smem[];
  const int cols = blockDim.x;
  const int n_prog = 5 * n_cmds + n_out;
  int32_t* s_prog = smem;                      // table, then output rows
  int32_t* s_count = smem + n_prog;            // n_out per-CTA counts
  uint32_t* s_plane = reinterpret_cast<uint32_t*>(s_count + n_out);

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * cols + t;
  const bool live = c < W;
  const size_t Ws = static_cast<size_t>(W);

  for (int k = t; k < n_prog; k += cols) s_prog[k] = prog[k];
  if (kCount) {
    for (int k = t; k < n_out; k += cols) s_count[k] = 0;
  }
  __syncthreads();

  uint32_t* col = s_plane + t;                 // row r lives at col[r*cols]
  if (live) {
    const uint32_t* src = plane + static_cast<size_t>(b) * n_in * Ws + c;
    for (int r = 0; r < n_rows; ++r) {
      uint32_t x = 0u;
      if (r < first_row) {
        x = (r == kC1Row) ? ~0u : 0u;
      } else if (r < first_row + n_in) {
        x = src[static_cast<size_t>(r - first_row) * Ws];
      }
      col[r * cols] = x;
    }
    const uint32_t* err =
        errors ? errors + static_cast<size_t>(b) * 4 * n_cmds * Ws + c
               : nullptr;
    for (int i = 0; i < n_cmds; ++i) {
      const int32_t* cmd = s_prog + 5 * i;
      const uint32_t kind = static_cast<uint32_t>(cmd[0]);
      const uint32_t s0 = col[cmd[1] * cols] ^ (0u - ((kind >> 2) & 1u));
      const uint32_t s1 = col[cmd[2] * cols] ^ (0u - ((kind >> 3) & 1u));
      const uint32_t s2 = col[cmd[3] * cols] ^ (0u - ((kind >> 4) & 1u));
      uint32_t v = (s0 & s1) | (s1 & s2) | (s2 & s0);
      if (err) {
        // TRA fault injection: the four pattern classes partition the
        // bits, so exactly one class mask applies per bit
        const uint32_t* e = err + static_cast<size_t>(4 * i) * Ws;
        const uint32_t ones3 = s0 & s1 & s2;
        const uint32_t lit = s0 | s1 | s2;
        v ^= (e[0] & ~lit) | (e[Ws] & (lit & ~v)) |
             (e[2 * Ws] & (v & ~ones3)) | (e[3 * Ws] & ones3);
      }
      const uint32_t aux = static_cast<uint32_t>(cmd[4]);
      const uint32_t neg = (aux >> 8) & 0xFFu;
      for (uint32_t m = (aux | neg) & 0xFFu; m; m &= m - 1) {
        const int r = __ffs(m) - 1;            // neg overrides pos
        col[r * cols] = ((neg >> r) & 1u) ? ~v : v;
      }
      col[(aux >> 16) * cols] = v;             // D/C destination or sink
    }
  }

  const int32_t* s_out = s_prog + 5 * n_cmds;
  if (!kCount) {
    if (live) {
      uint32_t* dst = out_words + static_cast<size_t>(b) * n_out * Ws + c;
      for (int k = 0; k < n_out; ++k) {
        dst[static_cast<size_t>(k) * Ws] = col[s_out[k] * cols];
      }
    }
    return;
  }
  uint32_t m = 0u;
  if (live) m = mask ? mask[static_cast<size_t>(b) * mask_stride + c] : ~0u;
  for (int k = 0; k < n_out; ++k) {
    const unsigned n = live ? __popc(col[s_out[k] * cols] & m) : 0u;
    const unsigned warp_sum = __reduce_add_sync(0xffffffffu, n);
    if ((t & 31) == 0 && warp_sum) atomicAdd(&s_count[k], static_cast<int>(warp_sum));
  }
  __syncthreads();
  for (int k = t; k < n_out; k += cols) {
    if (s_count[k]) atomicAdd(&out_counts[static_cast<size_t>(b) * n_out + k], s_count[k]);
  }
}

template <bool kCount>
cudaError_t launch(const int32_t* prog, int n_cmds, int n_out,
                   const uint32_t* plane, int batch, int n_in, int n_rows,
                   int first_row, int W, const uint32_t* errors,
                   const uint32_t* mask, int mask_per_batch, void* out,
                   int cols, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * (5 * n_cmds + 2 * n_out) +
                      sizeof(uint32_t) * static_cast<size_t>(n_rows) * cols;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vm_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + cols - 1) / cols, batch);
  vm_kernel<kCount><<<grid, cols, smem, stream>>>(
      prog, n_cmds, n_out, plane, n_in, n_rows, first_row, W, errors, mask,
      mask_per_batch ? W : 0, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// prog: int32 [table (n_cmds x 5) | output row indices (n_out)].
// plane: (batch, n_in, W) words holding rows first_row .. first_row+n_in-1.
// errors: NULL or (batch, 4*n_cmds, W); mask: NULL or (1|batch, W).
// out: (batch, n_out, W) words, or (batch, n_out) int32 counts (zeroed by
// the caller) when count_mode != 0. Returns a cudaError_t.
extern "C" int vm_launch(const void* prog, int n_cmds, int n_out,
                         const void* plane, int batch, int n_in, int n_rows,
                         int first_row, int W, const void* errors,
                         const void* mask, int mask_per_batch, void* out,
                         int count_mode, int cols, void* stream) {
  const auto* p = static_cast<const int32_t*>(prog);
  const auto* x = static_cast<const uint32_t*>(plane);
  const auto* e = static_cast<const uint32_t*>(errors);
  const auto* m = static_cast<const uint32_t*>(mask);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      count_mode ? launch<true>(p, n_cmds, n_out, x, batch, n_in, n_rows,
                                first_row, W, e, m, mask_per_batch, out, cols, s)
                 : launch<false>(p, n_cmds, n_out, x, batch, n_in, n_rows,
                                 first_row, W, e, m, mask_per_batch, out, cols, s);
  return static_cast<int>(rc);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
