// Flash attention backward for Hopper (sm_90a): dq, dk and dv of
// o = softmax(q k^T / sqrt(hd) + mask) v, recomputing p from q, k and the
// forward's saved logsumexp rows.
//
// Replaces: src/repro/kernels/flashattn.py::flash_attention_bwd_kernel
// (Pallas: a dq kernel on grid (B, H, nq, nk) with dq in VMEM scratch
// across the sequential key axis, and a dk / dv kernel on grid (B, H, nk,
// nq) writing float32 dk / dv per query head, which XLA then sums over the
// GQA group and casts to k's dtype), reached through the custom VJP of
// flash_attention in every training layer's backward. Plain version:
// src/repro_torch/kernels/flashattn.py::flash_attention_bwd_plain.
//
// What bounds it on this card: operations. At the training path's shape
// (microbatch B = 4, H = 16, KV = 8, S = 4096, hd = 128, causal, bf16) the
// five products over the unmasked pairs are 10 B H hd S (S + 1) / 2 =
// 6.9e11 FLOP, 0.69 ms at 989 TFLOP/s, against q, k, v, o, do, lse, dq,
// dk, dv = 0.60 GB, 0.18 ms at 3.35 TB/s.
//
// Design. Blocks run in no order, so each output gets the CTA that owns
// it and a loop takes the place of the TPU's sequential grid axis:
//   dq: one CTA per (64-row query tile, head, batch) walks the key tiles up
//   to the diagonal, recomputes s = q k^T, p = exp(s * scale - lse) and
//   dp = do v^T, and accumulates dq += ds k with ds = p (dp - delta) scale.
//   dk / dv: one CTA per (64-key tile, key/value head, batch) walks the G
//   query heads of its group and, for each, every query tile at or below
//   the diagonal, accumulating dv += p^T do and dk += ds^T q. The group's
//   sum stays in the CTA's registers, so there are no atomics, no
//   per-query-head float32 copies in device memory, and the result is
//   deterministic.
// delta = rowsum(o * do) is one PyTorch reduction in the wrapper, as the
// reference computes it outside its kernels. Operands are read in the
// model's (B, S, heads, hd) layout through their strides (hd contiguous);
// lse and delta are contiguous (B, H, Sq) float32. Query rows past Sq and
// keys past Sk are masked (p = 0: no phantom gradients, as the reference's
// +inf lse padding gives) and never stored.
//
//   bf16: four warps on mma.sync.m16n8k16 with float32 accumulation; every
//   operand tile is staged in shared memory, row-major where it is an A
//   operand or the B operand of a product over hd, transposed where it is
//   the B operand of a product over keys or queries. The masks, exp, p
//   and ds are float32, as in the reference. Rounded once to bf16, ds =
//   p (dp - delta), which cancels within a row, moves small dq elements
//   of the first causal rows by 2-4% of dq's RMS, and p moves dv of the
//   first keys (which every query sees) as far (measured on the card).
//   So both go in as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi),
//   two products each for dq, dk and dv (ten products in all where the
//   algorithm has seven), which keeps about 16 bits of p and ds.
//   float32: scalar FP32 FMAs, 256 threads, each owning a 4 x 4 block of
//   the 64 x 64 score tile and a 4 x (hd / 16) block of its accumulators.
//
// A first design: no K/V or Q/dO pipelining, a block-wide barrier per
// tile; wgmma, TMA and a ring of tiles are later work.
#include "flash_tiles.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;               // (B, H, Sq)
  const float* delta;             // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  long long q_strides[3];         // batch, sequence, head (elements)
  long long k_strides[3];
  long long v_strides[3];
  long long do_strides[3];
  long long dq_strides[3];
  long long dk_strides[3];
  long long dv_strides[3];
  int sq, sk, heads, group;       // group = H / KV
  int causal;
  float scale;
};

// The number of key tiles the q tile starting at q0 reads.
__device__ __forceinline__ int bwd_key_tiles(const BwdParams& p, int q0) {
  int n = (p.sk + kBK - 1) / kBK;
  if (p.causal) {
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n = last < n ? last : n;
  }
  return n;
}

// The first q tile that reaches the key tile starting at k0 (tiles of
// equal size, positions aligned at 0).
__device__ __forceinline__ int bwd_first_q_tile(const BwdParams& p, int k0) {
  return p.causal ? k0 / kBQ : 0;
}

__device__ __forceinline__ bool bwd_valid(const BwdParams& p, int qpos,
                                          int kpos) {
  return qpos < p.sq && kpos < p.sk && (!p.causal || qpos >= kpos);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

// acc[nt] += A B over one 64 x 64 tile product with a depth of HD: A rows
// [16 warp, 16 warp + 16) of the row-major sA[64][HD + 8]; B[k][n] read
// from the row-major sB[n][k] = sB[64][HD + 8].
template <int HD>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[kBK / 8][4],
                                                 const __nv_bfloat16* sA,
                                                 const __nv_bfloat16* sB,
                                                 int warp, int g, int t) {
  const __nv_bfloat16* a_lo = sA + (warp * 16 + g) * (HD + 8) + 2 * t;
  const __nv_bfloat16* a_hi = a_lo + 8 * (HD + 8);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t a[4] = {lds32(a_lo + ks * 16), lds32(a_hi + ks * 16),
                           lds32(a_lo + ks * 16 + 8),
                           lds32(a_hi + ks * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const __nv_bfloat16* br = sB + (nt * 8 + g) * (HD + 8) + 2 * t;
      mma_bf16(acc[nt], a, lds32(br + ks * 16), lds32(br + ks * 16 + 8));
    }
  }
}

// acc[dt] += A M over a depth of 64: A's bf16 fragments af (the packed C
// fragments of a 16 x 64 tile), M[k][n] read from the transposed
// sMt[n][k] = sMt[HD][kBK + 8].
template <int HD>
__device__ __forceinline__ void mma_frags_by_cols(
    float (&acc)[HD / 8][4], const uint32_t (&af)[kBK / 8][2],
    const __nv_bfloat16* sMt, int g, int t) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const __nv_bfloat16* mr = sMt + (dt * 8 + g) * (kBK + 8) + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {af[2 * kk][0], af[2 * kk][1],
                             af[2 * kk + 1][0], af[2 * kk + 1][1]};
      mma_bf16(acc[dt], a, lds32(mr + kk * 16), lds32(mr + kk * 16 + 8));
    }
  }
}

// The bf16 A fragments of a warp's 16 x 64 float32 C fragments, split
// into hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_frags(const float (&x)[kBK / 8][4],
                                            uint32_t (&hi)[kBK / 8][2],
                                            uint32_t (&lo)[kBK / 8][2]) {
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(x[nt][2 * j], x[nt][2 * j + 1]);
      const float2 hf = __bfloat1622float2(h);
      hi[nt][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[nt][j] = pack_bf16(x[nt][2 * j] - hf.x, x[nt][2 * j + 1] - hf.y);
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* x,
                                           long long row_stride,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int rows, int t) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (row0 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          x + static_cast<long long>(row0) * row_stride + d) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    }
    if (row0 + 8 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          x + static_cast<long long>(row0 + 8) * row_stride + d) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kBQ * (HD + 8);       // [kBQ][HD + 8]
  __nv_bfloat16* sK = sdO + kBQ * (HD + 8);       // [kBK][HD + 8]
  __nv_bfloat16* sV = sK + kBK * (HD + 8);        // [kBK][HD + 8]
  __nv_bfloat16* sKt = sV + kBK * (HD + 8);       // [HD][kBK + 8]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;

  const auto* q = static_cast<const __nv_bfloat16*>(p.q) +
                  b * p.q_strides[0] + h * p.q_strides[2];
  const auto* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                     b * p.do_strides[0] + h * p.do_strides[2];
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) +
                  b * p.k_strides[0] + kvh * p.k_strides[2];
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) +
                  b * p.v_strides[0] + kvh * p.v_strides[2];
  auto* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_strides[0] +
             h * p.dq_strides[2];

  stage_tile<HD, false>(sQ, q, p.q_strides[1], q0, p.sq);
  stage_tile<HD, false>(sdO, dout, p.do_strides[1], q0, p.sq);

  // rows g and g + 8 of this warp's 16, with their lse and delta
  const int qpos0 = q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
  const float lse0 = qpos0 < p.sq ? p.lse[row_base + qpos0] : 0.f;
  const float lse1 = qpos1 < p.sq ? p.lse[row_base + qpos1] : 0.f;
  const float dl0 = qpos0 < p.sq ? p.delta[row_base + qpos0] : 0.f;
  const float dl1 = qpos1 < p.sq ? p.delta[row_base + qpos1] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }

  const int n_tiles = bwd_key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // every warp is done with the last tile
    stage_tile<HD, false>(sK, k, p.k_strides[1], k0, p.sk);
    stage_tile<HD, false>(sV, v, p.v_strides[1], k0, p.sk);
    stage_tile<HD, true>(sKt, k, p.k_strides[1], k0, p.sk);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
    mma_rows_by_rows<HD>(s, sQ, sK, warp, g, t);     // q k^T
    mma_rows_by_rows<HD>(dp, sdO, sV, warp, g, t);   // do v^T

    // ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + nt * 8 + 2 * t + (i & 1);
        const int qpos = i < 2 ? qpos0 : qpos1;
        const float pr = bwd_valid(p, qpos, kpos)
            ? expf(s[nt][i] * p.scale - (i < 2 ? lse0 : lse1)) : 0.f;
        s[nt][i] = pr * (dp[nt][i] - (i < 2 ? dl0 : dl1)) * p.scale;
      }
    }
    uint32_t ds_hi[kBK / 8][2], ds_lo[kBK / 8][2];
    split_frags(s, ds_hi, ds_lo);
    mma_frags_by_cols<HD>(acc, ds_hi, sKt, g, t);    // dq += ds k
    mma_frags_by_cols<HD>(acc, ds_lo, sKt, g, t);
  }
  store_rows<HD>(dq, p.dq_strides[1], acc, qpos0, p.sq, t);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBK * (HD + 8);        // [kBK][HD + 8]
  __nv_bfloat16* sQ = sV + kBK * (HD + 8);        // [kBQ][HD + 8]
  __nv_bfloat16* sdO = sQ + kBQ * (HD + 8);       // [kBQ][HD + 8]
  __nv_bfloat16* sQt = sdO + kBQ * (HD + 8);      // [HD][kBQ + 8]
  __nv_bfloat16* sdOt = sQt + HD * (kBQ + 8);     // [HD][kBQ + 8]
  float* sL = reinterpret_cast<float*>(sdOt + HD * (kBQ + 8));  // [kBQ]
  float* sD = sL + kBQ;                                          // [kBQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  const auto* k = static_cast<const __nv_bfloat16*>(p.k) +
                  b * p.k_strides[0] + kvh * p.k_strides[2];
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) +
                  b * p.v_strides[0] + kvh * p.v_strides[2];
  auto* dk = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_strides[0] +
             kvh * p.dk_strides[2];
  auto* dv = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_strides[0] +
             kvh * p.dv_strides[2];

  stage_tile<HD, false>(sK, k, p.k_strides[1], k0, p.sk);
  stage_tile<HD, false>(sV, v, p.v_strides[1], k0, p.sk);

  // keys g and g + 8 of this warp's 16
  const int kpos0 = k0 + warp * 16 + g;
  const int kpos1 = kpos0 + 8;
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dt][i] = dv_acc[dt][i] = 0.f;
  }

  const int n_q_tiles = (p.sq + kBQ - 1) / kBQ;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const auto* q = static_cast<const __nv_bfloat16*>(p.q) +
                    b * p.q_strides[0] + h * p.q_strides[2];
    const auto* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                       b * p.do_strides[0] + h * p.do_strides[2];
    const long long row_base =
        (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int qt = bwd_first_q_tile(p, k0); qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();                // every warp is done with the last tile
      stage_tile<HD, false>(sQ, q, p.q_strides[1], q0, p.sq);
      stage_tile<HD, false>(sdO, dout, p.do_strides[1], q0, p.sq);
      stage_tile<HD, true>(sQt, q, p.q_strides[1], q0, p.sq);
      stage_tile<HD, true>(sdOt, dout, p.do_strides[1], q0, p.sq);
      if (threadIdx.x < kBQ) {
        const int qpos = q0 + threadIdx.x;
        sL[threadIdx.x] = qpos < p.sq ? p.lse[row_base + qpos] : 0.f;
        sD[threadIdx.x] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T: rows are this warp's keys, columns the tile's queries
      float st[kBQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = 0.f;
      }
      mma_rows_by_rows<HD>(st, sK, sQ, warp, g, t);
      // p^T in place of s^T (float32), then dv += p^T do
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + 2 * t + (i & 1);
          const int kpos = i < 2 ? kpos0 : kpos1;
          st[nt][i] = bwd_valid(p, q0 + col, kpos)
              ? expf(st[nt][i] * p.scale - sL[col]) : 0.f;
        }
      }
      {
        uint32_t p_hi[kBQ / 8][2], p_lo[kBQ / 8][2];
        split_frags(st, p_hi, p_lo);
        mma_frags_by_cols<HD>(dv_acc, p_hi, sdOt, g, t);
        mma_frags_by_cols<HD>(dv_acc, p_lo, sdOt, g, t);
      }

      // dp^T = v do^T, then ds^T = p^T (dp^T - delta) scale
      float dpt[kBQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dpt[nt][i] = 0.f;
      }
      mma_rows_by_rows<HD>(dpt, sV, sdO, warp, g, t);
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + 2 * t + (i & 1);
          st[nt][i] = st[nt][i] * (dpt[nt][i] - sD[col]) * p.scale;
        }
      }
      uint32_t ds_hi[kBQ / 8][2], ds_lo[kBQ / 8][2];
      split_frags(st, ds_hi, ds_lo);
      mma_frags_by_cols<HD>(dk_acc, ds_hi, sQt, g, t);  // dk += ds^T q
      mma_frags_by_cols<HD>(dk_acc, ds_lo, sQt, g, t);
    }
  }
  store_rows<HD>(dk, p.dk_strides[1], dk_acc, kpos0, p.sk, t);
  store_rows<HD>(dv, p.dv_strides[1], dv_acc, kpos0, p.sk, t);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

// Rows [r0, r0 + 64) of one head of x into dst[64][HD + 1]; rows past
// `rows` are zero.
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, const float* x,
                                          long long row_stride, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < kBK * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] =
        r0 + r < rows ? x[static_cast<long long>(r0 + r) * row_stride + d]
                      : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dq_simt_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [kBQ][HD + 1]
  float* sdO = sQ + kBQ * (HD + 1);                 // [kBQ][HD + 1]
  float* sK = sdO + kBQ * (HD + 1);                 // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);                  // [kBK][HD + 1]
  float* sS = sV + kBK * (HD + 1);                  // [kBQ][kBK + 1] ds
  float* sL = sS + kBQ * (kBK + 1);                 // [kBQ] lse
  float* sD = sL + kBQ;                             // [kBQ] delta

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;

  const float* q = static_cast<const float*>(p.q) + b * p.q_strides[0] +
                   h * p.q_strides[2];
  const float* dout = static_cast<const float*>(p.dout) +
                      b * p.do_strides[0] + h * p.do_strides[2];
  const float* k = static_cast<const float*>(p.k) + b * p.k_strides[0] +
                   kvh * p.k_strides[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_strides[0] +
                   kvh * p.v_strides[2];
  float* dq = static_cast<float*>(p.dq) + b * p.dq_strides[0] +
              h * p.dq_strides[2];

  stage_f32<HD>(sQ, q, p.q_strides[1], q0, p.sq);
  stage_f32<HD>(sdO, dout, p.do_strides[1], q0, p.sq);
  if (tid < kBQ) {
    const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq +
                          q0 + tid;
    sL[tid] = q0 + tid < p.sq ? p.lse[row] : 0.f;
    sD[tid] = q0 + tid < p.sq ? p.delta[row] : 0.f;
  }
  float acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = bwd_key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    stage_f32<HD>(sK, k, p.k_strides[1], k0, p.sk);
    stage_f32<HD>(sV, v, p.v_strides[1], k0, p.sk);
    __syncthreads();

    // s and dp of rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * (HD + 1) + d];
        ov[i] = sdO[(ty + 16 * i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * (HD + 1) + d];
        vv[j] = sV[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float pr = bwd_valid(p, q0 + r, k0 + c)
            ? expf(s[i][j] * p.scale - sL[r]) : 0.f;
        sS[r * (kBK + 1) + c] = pr * (dp[i][j] - sD[r]) * p.scale;
      }
    }
    __syncthreads();

    // dq += ds k for rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < kBK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const float kk = sK[c * (HD + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      dq[static_cast<long long>(q0 + r) * p.dq_strides[1] + tx + 16 * j] =
          acc[i][j];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_simt_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);                  // [kBK][HD + 1]
  float* sQ = sV + kBK * (HD + 1);                  // [kBQ][HD + 1]
  float* sdO = sQ + kBQ * (HD + 1);                 // [kBQ][HD + 1]
  float* sP = sdO + kBQ * (HD + 1);                 // [kBK][kBQ + 1] p^T
  float* sS = sP + kBK * (kBQ + 1);                 // [kBK][kBQ + 1] ds^T
  float* sL = sS + kBK * (kBQ + 1);                 // [kBQ] lse
  float* sD = sL + kBQ;                             // [kBQ] delta

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  const float* k = static_cast<const float*>(p.k) + b * p.k_strides[0] +
                   kvh * p.k_strides[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_strides[0] +
                   kvh * p.v_strides[2];
  float* dk = static_cast<float*>(p.dk) + b * p.dk_strides[0] +
              kvh * p.dk_strides[2];
  float* dv = static_cast<float*>(p.dv) + b * p.dv_strides[0] +
              kvh * p.dv_strides[2];

  stage_f32<HD>(sK, k, p.k_strides[1], k0, p.sk);
  stage_f32<HD>(sV, v, p.v_strides[1], k0, p.sk);
  // keys ty + 16 i, columns tx + 16 j
  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  const int n_q_tiles = (p.sq + kBQ - 1) / kBQ;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const float* q = static_cast<const float*>(p.q) + b * p.q_strides[0] +
                     h * p.q_strides[2];
    const float* dout = static_cast<const float*>(p.dout) +
                        b * p.do_strides[0] + h * p.do_strides[2];
    const long long row_base =
        (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int qt = bwd_first_q_tile(p, k0); qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      stage_f32<HD>(sQ, q, p.q_strides[1], q0, p.sq);
      stage_f32<HD>(sdO, dout, p.do_strides[1], q0, p.sq);
      if (tid < kBQ) {
        const int qpos = q0 + tid;
        sL[tid] = qpos < p.sq ? p.lse[row_base + qpos] : 0.f;
        sD[tid] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T of keys ty + 16 i, queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      }
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty + 16 * i) * (HD + 1) + d];
          vv[i] = sV[(ty + 16 * i) * (HD + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * (HD + 1) + d];
          ov[j] = sdO[(tx + 16 * j) * (HD + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float pr = bwd_valid(p, q0 + c, k0 + r)
              ? expf(st[i][j] * p.scale - sL[c]) : 0.f;
          sP[r * (kBQ + 1) + c] = pr;
          sS[r * (kBQ + 1) + c] = pr * (dpt[i][j] - sD[c]) * p.scale;
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q for keys ty + 16 i, columns tx + 16 j
      for (int c = 0; c < kBQ; ++c) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty + 16 * i) * (kBQ + 1) + c];
          sv[i] = sS[(ty + 16 * i) * (kBQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          const float ov = sdO[c * (HD + 1) + tx + 16 * j];
          const float qv = sQ[c * (HD + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], ov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (k0 + r >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const long long row = static_cast<long long>(k0 + r);
      dk[row * p.dk_strides[1] + tx + 16 * j] = dk_acc[i][j];
      dv[row * p.dv_strides[1] + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const BwdParams& p, int batch,
                      int kv_heads, cudaStream_t stream) {
  const dim3 dq_grid((p.sq + kBQ - 1) / kBQ, p.heads, batch);
  const dim3 dkv_grid((p.sk + kBK - 1) / kBK, kv_heads, batch);
  cudaError_t err;
  if (dtype == 1) {
    const size_t rows = sizeof(__nv_bfloat16) * kBK * (HD + 8);
    const size_t cols = sizeof(__nv_bfloat16) * HD * (kBK + 8);
    err = launch(flash_bwd_dq_mma_kernel<HD>, kMmaThreads, 4 * rows + cols,
                 dq_grid, p, stream);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dkv_mma_kernel<HD>, kMmaThreads,
                  4 * rows + 2 * cols + 2 * kBQ * sizeof(float), dkv_grid, p,
                  stream);
  }
  const size_t rows = sizeof(float) * kBK * (HD + 1);
  const size_t tile = sizeof(float) * kBQ * (kBK + 1);
  err = launch(flash_bwd_dq_simt_kernel<HD>, 256,
               4 * rows + tile + 2 * kBQ * sizeof(float), dq_grid, p, stream);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_simt_kernel<HD>, 256,
                4 * rows + 2 * tile + 2 * kBQ * sizeof(float), dkv_grid, p,
                stream);
}

}  // namespace

// q: (B, Sq, H, hd), k / v: (B, Sk, KV, hd), dout: (B, Sq, H, hd), dq:
// (B, Sq, H, hd), dk / dv: (B, Sk, KV, hd), each given by its base pointer
// and (batch, sequence, head) strides in elements, hd contiguous; lse and
// delta: contiguous (B, H, Sq) float32. dtype: 0 float32, 1 bfloat16 (every
// tensor but lse and delta alike). For bfloat16 every pointer must be
// 16-byte aligned and every stride of q, k, v and dout a multiple of 8
// elements (dq / dk / dv: of 2). Launches the dq kernel, then the dk / dv
// kernel, on `stream`. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides,
    const long long* dq_strides, const long long* dk_strides,
    const long long* dv_strides, int batch, int sq, int sk, int heads,
    int kv_heads, int head_dim, int causal, float scale, int dtype,
    void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || kv_heads < 1 || heads < 1 ||
      heads % kv_heads != 0 || heads > 65535 || batch > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.q_strides[i] = q_strides[i];
    p.k_strides[i] = k_strides[i];
    p.v_strides[i] = v_strides[i];
    p.do_strides[i] = do_strides[i];
    p.dq_strides[i] = dq_strides[i];
    p.dk_strides[i] = dk_strides[i];
    p.dv_strides[i] = dv_strides[i];
  }
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.group = heads / kv_heads;
  p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kv = kv_heads;
  switch (head_dim) {
    case 16: return static_cast<int>(launch_hd<16>(dtype, p, batch, kv, s));
    case 32: return static_cast<int>(launch_hd<32>(dtype, p, batch, kv, s));
    case 64: return static_cast<int>(launch_hd<64>(dtype, p, batch, kv, s));
    case 128:
      return static_cast<int>(launch_hd<128>(dtype, p, batch, kv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
