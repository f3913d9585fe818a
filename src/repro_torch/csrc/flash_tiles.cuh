// Tiles and mma.sync helpers of the first design's bf16 flash forward at
// head dims 16 and 32 (flashattn.cu::flash_mma_kernel), the one kernel
// left on mma.sync. Everything here has internal linkage.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per tile
constexpr int kMmaThreads = 128;  // bf16 kernels: four warps
constexpr float kNegInf = -1e30f;

// bf16 operands on mma.sync.m16n8k16 with float32 accumulation. Fragment
// layouts (g = lane / 4, t = lane % 4): A (16 x 16, row-major) a0 = rows g,
// columns 2t, 2t + 1; a1 = row g + 8; a2 / a3 = the same rows at columns
// + 8. B (16 x 8, column-major) b0 = rows 2t, 2t + 1 of column g; b1 = rows
// + 8. C (16 x 8) c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
// So a B operand B[k][n] is read from a shared matrix M[n][k] (k
// contiguous), and a warp's C fragments of two adjacent 8-column tiles,
// packed to bf16, are the A fragment of one 16-deep step.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + 64) of one head of x into shared memory, 16 bytes
// at a time; rows past `rows` are zero. Every load of the tile is issued
// before the first store, so their latencies overlap. kTranspose = false:
// dst[r][d] with row stride HD + 8; true: dst[d][r] with row stride
// kBK + 8, and consecutive threads take consecutive rows, so the 2-byte
// stores of a warp fall in distinct banks.
template <int HD, bool kTranspose>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x,
                                           long long row_stride, int r0,
                                           int rows) {
  constexpr int kChunks = HD / 8;                 // 16-byte chunks per row
  constexpr int kPerThread = kBK * kChunks / kMmaThreads;
  uint4 val[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = kTranspose ? c % kBK : c / kChunks;
    const int d = (kTranspose ? c / kBK : c % kChunks) * 8;
    val[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      val[i] = *reinterpret_cast<const uint4*>(
          x + static_cast<long long>(r0 + r) * row_stride + d);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = kTranspose ? c % kBK : c / kChunks;
    const int d = (kTranspose ? c / kBK : c % kChunks) * 8;
    if constexpr (kTranspose) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(d + j) * (kBK + 8) + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (HD + 8) + d) = val[i];
    }
  }
}

}  // namespace
