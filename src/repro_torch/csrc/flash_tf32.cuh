// Hopper (sm_90a) building blocks of the float32 flash-attention kernels
// (flashattn.cu: the forward, flashattn_bwd.cu: the backward), which run
// their products on the tensor cores as three TF32 products ("3xTF32"):
// each operand x is split into hi = tf32(x) (cvt.rna.tf32.f32: round to
// nearest, ties away from zero, 10 mantissa bits kept) and lo = tf32(x -
// hi), and a b is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in
// float32. A tf32 product of two tf32 values is exact in float32, and the
// dropped a_lo b_lo is about 2^-22 of a b, so the result is float32-grade
// rather than the 10-bit mantissa of one TF32 pass.
//
// Layouts. For .tf32 wgmma has no transpose bit: both shared-memory
// operands are K-major (the product's depth contiguous). A tile of R rows
// of hd values is brought in by TMA as ceil(hd / 32) boxes of 32 float32
// columns (128 bytes a row), each box R * 128 bytes with the 128-byte
// swizzle, so flash_sm90.cuh's desc_k / kstep_k apply unchanged: a k-step
// of 8 tf32 values is 32 bytes, as one of 16 bf16 values is. The products
// over rows (P V, dS K, P^T dO, dS^T Q) read their B operand from a
// transposed copy, [hd][row] with the rows contiguous, in boxes of 32 rows
// by hd, which `tf32_split_kernel` writes once per launch. Their A
// operand is an accumulator held in registers; its float32 C fragment
// (thread (g, t) of a warp holds columns 2t, 2t + 1 of rows g and g + 8 in
// each 8-column block) is not the tf32 A fragment (columns t and t + 4),
// so the transposed copy stores the rows of each aligned group of 8 in
// the order 0, 2, 4, 6, 1, 3, 5, 7: the product's k index t then is row
// 2t and t + 4 is row 2t + 1, which the thread holds, and the sum over the
// group is unchanged. Everything has internal linkage.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// the split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi), as the bits wgmma reads.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The row of an aligned group of 8 stored at position p of a transposed
// copy: 0, 2, 4, 6, 1, 3, 5, 7.
__device__ __forceinline__ int tf32_group_row(int p) {
  return p < 4 ? 2 * p : 2 * p - 7;
}

// A float32 accumulator of N values a thread (N / 4 blocks of 8 columns;
// block j holds columns 2t, 2t + 1 of row g in elements 4 j, 4 j + 1 and
// of row g + 8 in 4 j + 2, 4 j + 3) as the split tf32 A fragments of a
// product over its columns: k-step j (8 deep) takes block j as registers
// 4 j .. 4 j + 3 = (row g, k t), (row g + 8, k t), (row g, k t + 4), (row
// g + 8, k t + 4), with k t = column 2t and k t + 4 = column 2t + 1 (the
// transposed copy's order).
template <int N>
__device__ __forceinline__ void acc_to_tf32_frags(const float (&x)[N],
                                                  uint32_t (&hi)[N],
                                                  uint32_t (&lo)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    tf32_split(x[4 * j], hi[4 * j], lo[4 * j]);
    tf32_split(x[4 * j + 2], hi[4 * j + 1], lo[4 * j + 1]);
    tf32_split(x[4 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
    tf32_split(x[4 * j + 3], hi[4 * j + 3], lo[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// wgmma on tf32: d (64 x N, float32) = A B, or += where `accumulate`; A
// 64 x 8 and B 8 x N, both K-major in shared memory (ss), or A from
// registers in the fragment layout above (rs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n80(float (&d)[40],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n112(float (&d)[56],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void tf32_ss(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "ss width");
  if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db, accumulate);
  } else {
    wgmma_tf32_ss_n64(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void tf32_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 80 || N == 112 ||
                N == 128, "rs width");
  if constexpr (N == 16) {
    wgmma_tf32_rs_n16(d, a, db, accumulate);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, db, accumulate);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db, accumulate);
  } else if constexpr (N == 80) {
    wgmma_tf32_rs_n80(d, a, db, accumulate);
  } else if constexpr (N == 112) {
    wgmma_tf32_rs_n112(d, a, db, accumulate);
  } else {
    wgmma_tf32_rs_n128(d, a, db, accumulate);
  }
}

// d (64 x N) = A B^T over the head dim's HD / 8 k-steps, 3xTF32: A's 64
// rows (hi and lo tiles of `a_rows` rows) and B's N rows (hi and lo tiles
// of N rows), all K-major. The small products go first.
template <int HD, int N>
__device__ __forceinline__ void ss3_product(float (&d)[N / 2], uint64_t a_hi,
                                            uint64_t a_lo, int a_rows,
                                            uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    const uint64_t ah = kstep_k(a_hi, a_rows, ks);
    const uint64_t bh = kstep_k(b_hi, N, ks);
    tf32_ss<N>(d, kstep_k(a_lo, a_rows, ks), bh, ks > 0);
    tf32_ss<N>(d, ah, kstep_k(b_lo, N, ks), 1);
    tf32_ss<N>(d, ah, bh, 1);
  }
}

// d (64 x HD) = A B over a depth of K rows, 3xTF32: A's split fragments
// (`acc_to_tf32_frags` of a 64 x K accumulator), B from a transposed copy
// (hi and lo tiles of HD rows by K, K-major). d starts afresh: the caller
// adds it into its own float32 total (round to nearest), because the
// tensor cores' float32 sums do not round to nearest and an accumulator
// that took every tile's products drifted with the length of the sum
// (a dk / dv accumulator over 8 heads x 4,096 queries, some 12,000
// products, reached 0.65 of the card's gate; one tile's 3 K / 8 do not).
template <int HD, int K>
__device__ __forceinline__ void rs3_product(float (&d)[HD / 2],
                                            const uint32_t (&hi)[K / 2],
                                            const uint32_t (&lo)[K / 2],
                                            uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                            hi[4 * kk + 3]};
    const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                            lo[4 * kk + 3]};
    const uint64_t bh = kstep_k(b_hi, HD, kk);
    tf32_rs<HD>(d, al, bh, kk > 0);
    tf32_rs<HD>(d, ah, kstep_k(b_lo, HD, kk), 1);
    tf32_rs<HD>(d, ah, bh, 1);
  }
}

// total += d, element by element (float32 adds, round to nearest).
template <int N>
__device__ __forceinline__ void add_into(float (&total)[N],
                                         const float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) total[i] += d[i];
}

// ---------------------------------------------------------------------------
// host: float32 tensor maps
// ---------------------------------------------------------------------------

// A 4-D float32 map, innermost first: dims, the byte strides of dims 1-3,
// a box of 32 columns by `rows` rows (128-byte swizzle; reads past the
// dims are zeros). False if refused.
bool make_f32_map(CUtensorMap* map, const void* base, const cuuint64_t* dims,
                  const cuuint64_t* byte_strides, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, byte_strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The row copies `tf32_split_kernel` writes, (B, S, heads, hd)
// contiguous: boxes of 32 head-dim columns by `rows` sequence rows of one
// head, at coordinates (column, row, head, batch).
bool make_rows_map(CUtensorMap* map, const float* base, int batch, int seq,
                   int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 4ull * hd * heads;
  const cuuint64_t strides[3] = {row, 4ull * hd, row * seq};
  return make_f32_map(map, base, dims, strides, rows);
}

// The transposed copies, (B, heads, hd, seq8) contiguous: boxes of 32
// sequence positions by all hd rows of one head, at coordinates
// (position, 0, head, batch).
bool make_cols_map(CUtensorMap* map, const float* base, int batch, int seq8,
                   int heads, int hd) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(seq8),
                              static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 4ull * seq8;
  const cuuint64_t strides[3] = {row, row * hd, row * hd * heads};
  return make_f32_map(map, base, dims, strides, hd);
}

// ---------------------------------------------------------------------------
// the pre-pass
// ---------------------------------------------------------------------------

// One operand of the pre-pass.
struct SplitJob {
  const float* x;                 // (B, S, heads, hd) through its strides
  long long strides[3];           // batch, sequence, head (elements)
  float* rows;    // null, or hi then lo, each (B, S, heads, hd)
  float* cols;    // null, or hi then lo, each (B, heads, hd, S8)
  int seq, seq8, heads;
  int first;                      // its first CTA
};

constexpr int kSplitJobs = 4;

struct SplitParams {
  SplitJob job[kSplitJobs];
  int n_jobs, batch, hd;
};

// The split copies of up to four float32 operands in one launch: a CTA per
// 32 sequence positions of one head of one operand, staged in shared
// memory; the row copies are written along hd, the transposed ones along
// the sequence (each aligned group of 8 in `tf32_group_row` order,
// positions S..S8-1 zero). What bounds it is bytes: each operand read
// once, two or four times its size written.
__global__ void __launch_bounds__(256) tf32_split_kernel(const SplitParams p) {
  __shared__ float tile[32][129];
  // the CTA's operand (constant indices: the jobs stay in parameter space)
  SplitJob job = p.job[0];
#pragma unroll
  for (int i = 1; i < kSplitJobs; ++i) {
    if (i < p.n_jobs && static_cast<int>(blockIdx.x) >= p.job[i].first) {
      job = p.job[i];
    }
  }
  const int tiles = (job.seq8 + 31) / 32;
  const int local = static_cast<int>(blockIdx.x) - job.first;
  const int s0 = local % tiles * 32;
  const int h = local / tiles % job.heads, b = local / tiles / job.heads;
  const int hd = p.hd;
  const float* x = job.x + b * job.strides[0] + h * job.strides[2];
  const long long rows_part =
      static_cast<long long>(p.batch) * job.seq * job.heads * hd;
  for (int i = threadIdx.x; i < 32 * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, s = s0 + r;
    const float v = s < job.seq ? x[s * job.strides[1] + d] : 0.f;
    tile[r][d] = v;
    if (job.rows != nullptr && s < job.seq) {
      uint32_t hi, lo;
      tf32_split(v, hi, lo);
      const long long o =
          ((static_cast<long long>(b) * job.seq + s) * job.heads + h) * hd +
          d;
      job.rows[o] = __uint_as_float(hi);
      job.rows[rows_part + o] = __uint_as_float(lo);
    }
  }
  if (job.cols == nullptr) return;
  __syncthreads();
  const long long cols_part =
      static_cast<long long>(p.batch) * job.heads * hd * job.seq8;
  for (int i = threadIdx.x; i < 32 * hd; i += blockDim.x) {
    const int d = i / 32, c = i % 32, s = s0 + c;
    if (s >= job.seq8) continue;
    uint32_t hi, lo;
    tf32_split(tile[(c & ~7) + tf32_group_row(c & 7)][d], hi, lo);
    const long long o =
        ((static_cast<long long>(b) * job.heads + h) * hd + d) * job.seq8 +
        s;
    job.cols[o] = __uint_as_float(hi);
    job.cols[cols_part + o] = __uint_as_float(lo);
  }
}

// Floats of one operand's split copies: the rows' (hi and lo) and the
// transposed ones'.
inline long long rows_floats(int batch, int seq, int heads, int hd) {
  return 2LL * batch * seq * heads * hd;
}

inline int seq8(int seq) { return (seq + 7) / 8 * 8; }

inline long long cols_floats(int batch, int seq, int heads, int hd) {
  return 2LL * batch * heads * hd * seq8(seq);
}

// The pre-pass's operands, then one launch for all of them.
struct Split {
  SplitParams p;
  long long blocks = 0;

  Split(int batch, int hd) {
    p.n_jobs = 0;
    p.batch = batch;
    p.hd = hd;
  }

  // x (rows and / or cols may be null).
  void add(const void* x, const long long* strides, int seq, int heads,
           float* rows, float* cols) {
    SplitJob& job = p.job[p.n_jobs++];
    job.x = static_cast<const float*>(x);
    for (int i = 0; i < 3; ++i) job.strides[i] = strides[i];
    job.rows = rows;
    job.cols = cols;
    job.seq = seq;
    job.seq8 = seq8(seq);
    job.heads = heads;
    job.first = static_cast<int>(blocks);
    blocks += static_cast<long long>((job.seq8 + 31) / 32) * heads * p.batch;
  }

  cudaError_t launch(cudaStream_t stream) const {
    if (p.hd > 128 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    tf32_split_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace
