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
// What bounds it on this card: operations (the H100 SXM's peaks, as
// src/repro_torch/hw.py holds them). At the training path's shape
// (microbatch B = 2, H = 16, KV = 8, S = 4096, hd = 128, causal, bf16) the
// five products over the unmasked pairs are 10 B H hd S (S + 1) / 2 =
// 3.4e11 FLOP, 0.348 ms at 989 TFLOP/s, against q, k, v, o, do, lse, dq,
// dk, dv = 0.20 GB, 0.060 ms at 3.35 TB/s. Zamba2's shared attention (hd
// 80, B 2, 32 heads, causal 4,096) is bound at 0.434 ms, SeamlessM4T's
// hd-64 launches (B 2, 16 heads) at 0.022-0.174 ms, Kimi K2's (hd 112, B
// 1, 64 heads over 8, causal 4,096) at 0.608 ms.
//
// Design. Blocks run in no order, so each output gets the CTA that owns
// it and a loop takes the place of the TPU's sequential grid axis:
//   dq: one CTA per (query tile, head, batch) walks the key tiles up to
//   the diagonal, recomputes s = q k^T, p = exp(s * scale - lse) and
//   dp = do v^T, and accumulates dq += ds k with ds = p (dp - delta) scale.
//   dk / dv: one CTA per (key tile, key/value head, batch) walks the G
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
// +inf lse padding gives) and never stored; lse and delta are never read
// past Sq (the next head's rows lie there). The masks, exp, p and ds are
// float32, as in the reference. Rounded once to bf16, ds = p (dp - delta),
// which cancels within a row, moves small dq elements of the first causal
// rows by 2-4% of dq's RMS, and p moves dv of the first keys (which every
// query sees) as far (measured on the card). So in bf16 both go in as two
// parts, hi = bf16(x) and lo = bf16(x - hi), two products each for dq, dk
// and dv, which keeps about 16 bits of p and ds. The launcher's switch on
// the head dim and dtype picks the kernels; none falls back on another:
//
//   bf16, head dims 64, 80, 112 and 128 (every dense config the port
//   trains at 128; SeamlessM4T at 64, Zamba2's shared attention at 80,
//   Kimi K2 at 112): flash_bwd_dq_sm90_kernel<HD, true>, then
//   flash_bwd_dkv_sm90_kernel<HD, true>. Against the operation bound they
//   keep the tensor cores fed: each CTA has two consumer warpgroups on
//   wgmma and a producer that streams tiles by TMA (tensor maps over the
//   model's layout, 128-byte swizzle) through a ring of full / empty
//   mbarriers, and setmaxnreg gives the producer's registers to the
//   consumers. A tile row is ceil(HD / 64) boxes of 64 columns: one at hd
//   64, two at 80, 112 and 128; at 80 and 112 TMA fills the second box's
//   columns past the head dim (80-127, 112-127) with zeros. The products
//   over the head dim (S, dP; S^T, dP^T) read both operands from shared
//   memory, K-major, in HD / 16 k-steps (those from the fifth on read the
//   second box: one at hd 80, three at 112); the products over keys or
//   queries (dQ += dS K, dV += P^T dO, dK += dS^T Q) take dS, P^T, dS^T
//   from registers (their accumulators are the A fragments) and read K,
//   dO, Q in their natural [row][hd] layout through the descriptor's
//   transpose bit, one m64nHDk16 wgmma a 16-deep step (at hd 80 and 112
//   across both boxes, LBO = the second box's distance), which writes
//   exactly the HD / 2 accumulator floats a thread; nothing is staged
//   transposed, the lo part of the split is one more product on the same
//   descriptor, and the epilogue stores the HD real columns. dq: 128
//   query rows a CTA, 64-key tiles. dk / dv: 128 keys a CTA, K and V
//   loaded once, 64-query tiles with their lse and delta rows. At hd 112
//   and 128 in two passes (dV, then dK), so that one accumulator of 56 or
//   64 registers a thread is live beside S^T and dP^T; with both live
//   ptxas spilled (at hd 112 272 bytes, and it serialized the wgmmas). At
//   hd 64 and 80 in one pass: dK and dV (32 + 32 or 40 + 40 floats a
//   thread) stay live, S^T is computed once and Q, dO stream once; a tile
//   runs S^T, p^T and its fragments, dV += P^T dO, dP^T, ds^T, dK += dS^T
//   Q, each product waited for before the next. p is 2^(s scale log2(e) -
//   lse log2(e)). The ring has three stages at hd 80, 112 and 128 and six
//   at 64. The variants timed while choosing, each in turns in one call on
//   an H100 80GB HBM3 at 700 W (ms a launch; only the chosen ones were
//   kept): at hd 64, B 2, 16 heads, over 1,024 x 1,024 / causal 4,096 /
//   4,096 x 1,024 keys, a ring of six 0.150 / 0.893 / 0.519, of eight
//   0.155 / 0.908 / 0.537, of four 0.156 / 0.915 / 0.538, of three 0.154 /
//   0.908 / 0.536, of two 0.156 / 0.917 / 0.546; at hd 80, B 2, 32 heads,
//   causal 4,096, rings of two, three and four 2.004, 2.040 and 2.051 (two
//   builds of three: 1.993 and 2.040); at hd 112, B 1, 64 heads over 8,
//   causal 4,096, two passes with a ring of three 2.903 and of four 2.942,
//   one pass (spilling) with three 3.013 and four 3.271 (the first design
//   on mma.sync: 10.063). Tried and not kept: dP^T issued with dV in one
//   batch (ptxas spilled 12 bytes at hd 64 and serialized the wgmmas at
//   80: 2.15 against 2.02); dQ's product left in flight while the next
//   tile's S and dP are issued (2.05-2.15 against 1.97-2.02 at hd 80); 288
//   threads, one producer warp and no setmaxnreg (the consumers then
//   report 127-164 registers): no faster, and sharing a batch still spills
//   or serializes.
//   bf16, head dims 16 and 32 (test shapes, off every main path): the
//   first design, flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel:
//   four warps on mma.sync.m16n8k16 with float32 accumulation, 64 x 64
//   tiles staged in shared memory (row-major where they are an A operand
//   or the B operand of a product over hd, transposed where they are the
//   B operand of a product over keys or queries), the same hi + lo split.
//   float32, every head dim: scalar FP32 FMAs, 256 threads, each owning a
//   4 x 4 block of the 64 x 64 score tile and a 4 x (hd / 16) block of its
//   accumulators.
#include "flash_tiles.cuh"
#include "flash_sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16, head dims 64, 80, 112, 128: TMA ring + wgmma (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;     // consumers: warpgroups 0, 1; producer: 2

// The backward's shape at head dim HD: a tile row is ceil(HD / 64) halves
// of 64 columns (128 bytes a row each; at hd 80 and 112 TMA zero-fills the
// second's columns past the head dim); a warpgroup's 64 x HD accumulator
// is HD / 2 floats a thread. At hd 64 and 80 the dk / dv kernel makes one
// pass (dK and dV live together), at 112 and 128 two (one pass spilled).
// The ring is as deep as was measured fastest (times in the header).
template <int HD>
struct Bwd {
  static constexpr int kHalves = (HD + 63) / 64;
  static constexpr int kRows128 = 128 * 128 * kHalves;  // bytes of 128 rows
  static constexpr int kRows64 = 64 * 128 * kHalves;    // bytes of 64 rows
  static constexpr int kStages = HD == 64 ? 6 : 3;
  static constexpr bool kOnePass = HD < 112;
  static constexpr int kAcc = HD / 2;
  static constexpr int kBars = 1 + 2 * kStages;  // loaded once; full, empty
  static constexpr int kDqSmem =
      1024 + 2 * kRows128 + 2 * kStages * kRows64 + 8 * kBars;
  static constexpr int kDkvSmem = kDqSmem + 2 * kStages * 64 * 4;
  static_assert(HD == 64 || HD == 80 || HD == 112 || HD == 128, "head dim");
  static_assert(kDkvSmem <= 232448, "shared memory");
};

struct DqParams {
  CUtensorMap q_map, do_map;        // boxes of 128 rows
  CUtensorMap k_map, v_map;         // boxes of 64 rows
  const float* lse;                 // (B, H, Sq)
  const float* delta;               // (B, H, Sq)
  void* dq;
  long long dq_strides[3];
  int sq, sk, heads, group, batch, n_q_tiles;
  int causal;
  float scale, scale_log2;
};

struct DkvParams {
  CUtensorMap k_map, v_map;         // boxes of 128 rows
  CUtensorMap q_map, do_map;        // boxes of 64 rows
  const float* lse;
  const float* delta;
  void* dk;
  void* dv;
  long long dk_strides[3];
  long long dv_strides[3];
  int sq, sk, heads, group, batch, kv_heads;
  int causal;
  float scale, scale_log2;
};

// Store a warpgroup's 64 x HD float32 accumulator as bf16 rows row0 (and
// row0 + 8) of x, those below `rows` only, HD real columns.
template <int HD>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* x,
                                               long long row_stride,
                                               const float (&acc)[HD / 2],
                                               int row0, int rows, int t) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int d = 8 * (i / 4) + 2 * t;
    if (row0 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          x + static_cast<long long>(row0) * row_stride + d) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
    if (row0 + 8 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          x + static_cast<long long>(row0 + 8) * row_stride + d) =
          __floats2bfloat162_rn(acc[i + 2], acc[i + 3]);
    }
  }
}

// acc (64 x HD) += A B over a depth of 64 rows: A's bf16 fragments (hi,
// and lo after it where kSplit), B N-major from the 64-row tile at `tile`
// (its halves 64 x 128 bytes apart).
template <int HD, bool kSplit>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2],
                                           const uint32_t (&hi)[16],
                                           const uint32_t (&lo)[16],
                                           const unsigned char* tile) {
  const uint64_t bn = desc_n(tile, 64 * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = kstep_n(bn, kk);
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                            hi[4 * kk + 3]};
    wgmma_rs_hd<HD>(acc, ah, bd);
    if constexpr (kSplit) {
      const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                              lo[4 * kk + 3]};
      wgmma_rs_hd<HD>(acc, al, bd);
    }
  }
}

// d (64 x 64) = A B^T over the head dim's HD / 16 k-steps: A's 64 rows
// (K-major, in a tile of `a_rows` rows) and B's 64 rows (K-major, a
// 64-row tile).
template <int HD>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t da,
                                           int a_rows, uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    wgmma_ss_n64(d, kstep_k(da, a_rows, ks), kstep_k(db, 64, ks), ks > 0);
  }
}

// The bf16 A fragments of x: hi (+ lo where kSplit).
template <bool kSplit>
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&hi)[16],
                                         uint32_t (&lo)[16]) {
  if constexpr (kSplit) {
    acc_to_split_frags(x, hi, lo);
  } else {
    acc_to_frags(x, hi);
  }
}

// dq: a CTA per (128-row query tile, head, batch), the heaviest (last,
// when causal) first. Q and dO are loaded once; K and V tiles of 64 keys
// stream through the ring up to the diagonal. Each consumer warpgroup
// owns 64 query rows: S = Q K^T and dP = dO V^T from shared memory,
// dS = P (dP - delta) scale in registers, dQ += dS K with K read N-major.
// kSplit: dS enters as hi + lo bf16 parts (two products), else rounded
// once.
template <int HD, bool kSplit>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ DqParams p) {
  using T = Bwd<HD>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + T::kRows128;
  unsigned char* sK = sdO + T::kRows128;                // [stage]
  unsigned char* sV = sK + kStages * T::kRows64;        // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * T::kRows64);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;                         // [stage]
  uint64_t* empty = kv_full + kStages;                  // [stage]

  const int bh = p.heads * p.batch;
  const int qt = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % p.heads;
  const int b = static_cast<int>(blockIdx.x) % bh / p.heads;
  const int q0 = qt * 128;
  int n_tiles = (p.sk + 63) / 64;
  if (p.causal) n_tiles = min(n_tiles, (q0 + 127) / 64 + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_release<40>();
    if (threadIdx.x == 256) {
      const int kvh = h / p.group;
      mbar_arrive_expect_tx(q_full, 2 * T::kRows128);
      tma_load_rows<T::kHalves>(sQ, &p.q_map, q_full, 128, q0, h, b);
      tma_load_rows<T::kHalves>(sdO, &p.do_map, q_full, 128, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * T::kRows64);
        tma_load_rows<T::kHalves>(sK + s * T::kRows64, &p.k_map,
                                  &kv_full[s], 64, j * 64, kvh, b);
        tma_load_rows<T::kHalves>(sV + s * T::kRows64, &p.v_map,
                                  &kv_full[s], 64, j * 64, kvh, b);
      }
    }
  } else {
    regs_claim<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_row = q0 + 64 * wg;
    const int row0 = wg_row + 16 * warp + g;          // and row0 + 8
    const long long row_base =
        (static_cast<long long>(b) * p.heads + h) * p.sq;
    const float l0 = row0 < p.sq ? p.lse[row_base + row0] * kLog2e : 0.f;
    const float l1 =
        row0 + 8 < p.sq ? p.lse[row_base + row0 + 8] * kLog2e : 0.f;
    const float d0 = row0 < p.sq ? p.delta[row_base + row0] : 0.f;
    const float d1 = row0 + 8 < p.sq ? p.delta[row_base + row0 + 8] : 0.f;
    const uint64_t q_desc = desc_k(sQ + wg * 64 * 128);
    const uint64_t do_desc = desc_k(sdO + wg * 64 * 128);
    const float c = p.scale_log2;

    float dq[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int k0 = j * 64;
      const unsigned char* k_tile = sK + s * T::kRows64;
      const unsigned char* v_tile = sV + s * T::kRows64;
      mbar_wait(&kv_full[s], (j / kStages) & 1);
      if (!p.causal || k0 <= wg_row + 63) {   // else wholly masked here
        float sc[32], dp[32];
        wgmma_fence();
        ss_product<HD>(sc, opaque(q_desc), 128, desc_k(k_tile));
        ss_product<HD>(dp, opaque(do_desc), 128, desc_k(v_tile));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // ds = p (dp - delta) scale with p = 2^(s c - lse log2 e), 0 where
        // masked, in place of s
        const bool mask = k0 + 64 > p.sk || (p.causal && k0 + 63 > wg_row);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lower = (i & 2) != 0;
          float pr = exp2f(fmaf(sc[i], c, -(lower ? l1 : l0)));
          if (mask) {
            const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int qpos = row0 + (lower ? 8 : 0);
            if (kpos >= p.sk || (p.causal && kpos > qpos)) pr = 0.f;
          }
          sc[i] = pr * (dp[i] - (lower ? d1 : d0)) * p.scale;
        }
        uint32_t hi[16], lo[16];
        to_frags<kSplit>(sc, hi, lo);
        // dQ += dS K: K read N-major in its [key][head dim] layout
        wgmma_fence();
        rs_product<HD, kSplit>(dq, hi, lo, k_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    auto* out = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_strides[0] +
                h * p.dq_strides[2];
    store_acc_rows<HD>(out, p.dq_strides[1], dq, row0, p.sq, t);
  }
}

// p^T = 2^(s^T c - lse log2 e) in place of a warpgroup's S^T tile (rows:
// keys key0 and key0 + 8 of this thread; columns: the tile's 64 queries
// from q0, whose lse log2 e is lrow[]), 0 above the diagonal where `mask`.
__device__ __forceinline__ void st_to_p(float (&st)[32], const float* lrow,
                                        float c, bool mask, int key0, int q0,
                                        int t) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int col = 8 * jb + 2 * t;
    const float2 lv = *reinterpret_cast<const float2*>(lrow + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * jb + e;
      float pr = exp2f(fmaf(st[x], c, -((e & 1) ? lv.y : lv.x)));
      if (mask && key0 + ((e & 2) ? 8 : 0) > q0 + col + (e & 1)) pr = 0.f;
      st[x] = pr;
    }
  }
}

// ds^T = p^T (dp^T - delta) scale in place of p^T (delta of the tile's
// queries in drow[]).
__device__ __forceinline__ void p_to_ds(float (&pt)[32],
                                        const float (&dpt)[32],
                                        const float* drow, float scale,
                                        int t) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const float2 dl = *reinterpret_cast<const float2*>(drow + 8 * jb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * jb + e;
      pt[x] = pt[x] * (dpt[x] - ((e & 1) ? dl.y : dl.x)) * scale;
    }
  }
}

// dk / dv: a CTA per (128-key tile, key/value head, batch), the heaviest
// (first, when causal) first. K and V are loaded once; the Q and dO tiles
// of 64 query rows of every head in the GQA group, from the diagonal on,
// stream through the ring with their lse and delta rows. Each consumer
// warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T from shared
// memory, p^T and ds^T in registers, dV += P^T dO and dK += dS^T Q with dO
// and Q read N-major. At head dims 64 and 80 one pass keeps dK and dV (2 x
// HD / 2 floats a thread) beside S^T and dP^T: per tile S^T, then p^T and
// its fragments, dV += P^T dO, dP^T, ds^T and its fragments, dK += dS^T Q.
// At 112 and 128 the two accumulators (112 or 128 floats a thread) beside
// S^T and dP^T spill, so the tiles stream twice: a first pass accumulates
// dV, a second dK, computing S^T again. The group's sum stays in registers: no
// atomics, and the result is deterministic. kSplit: p and ds enter as hi
// + lo bf16 parts.
template <int HD, bool kSplit>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ DkvParams p) {
  using T = Bwd<HD>;
  constexpr int kStages = T::kStages;
  constexpr int kPasses = T::kOnePass ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = sK + T::kRows128;
  unsigned char* sQ = sV + T::kRows128;                 // [stage]
  unsigned char* sdO = sQ + kStages * T::kRows64;       // [stage]
  float* sL = reinterpret_cast<float*>(sdO + kStages * T::kRows64);
  float* sD = sL + kStages * 64;                        // [stage][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + kStages * 64);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                            // [stage]
  uint64_t* empty = full + kStages;                     // [stage]

  const int bkv = p.kv_heads * p.batch;
  const int k0 = static_cast<int>(blockIdx.x) / bkv * 128;
  const int kvh = static_cast<int>(blockIdx.x) % bkv % p.kv_heads;
  const int b = static_cast<int>(blockIdx.x) % bkv / p.kv_heads;
  const int n_q = (p.sq + 63) / 64;
  const int first = p.causal ? min(k0 / 64, n_q) : 0;
  const int per_head = n_q - first;
  const int n_iter = p.group * per_head;                // tiles a pass

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);        // the producer warp's lanes
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_release<40>();
    if (threadIdx.x < 288) {          // one warp: TMA, lse and delta rows
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * T::kRows128);
        tma_load_rows<T::kHalves>(sK, &p.k_map, kv_full, 128, k0, kvh, b);
        tma_load_rows<T::kHalves>(sV, &p.v_map, kv_full, 128, k0, kvh, b);
      }
      for (int i = 0; i < kPasses * n_iter; ++i) {
        const int s = i % kStages;
        const int j = i < n_iter ? i : i - n_iter;
        const int h = kvh * p.group + j / per_head;
        const int q0 = (first + j % per_head) * 64;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const long long row_base =
            (static_cast<long long>(b) * p.heads + h) * p.sq;
#pragma unroll
        for (int r = lane; r < 64; r += 32) {
          const int qpos = q0 + r;
          // rows past the end: lse = +inf, so p = 0
          sL[s * 64 + r] = qpos < p.sq ? p.lse[row_base + qpos] * kLog2e
                                       : __int_as_float(0x7f800000);
          sD[s * 64 + r] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * T::kRows64);
          tma_load_rows<T::kHalves>(sQ + s * T::kRows64, &p.q_map, &full[s],
                                    64, q0, h, b);
          tma_load_rows<T::kHalves>(sdO + s * T::kRows64, &p.do_map,
                                    &full[s], 64, q0, h, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    regs_claim<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * wg;                     // the group's first key
    const int key0 = kw0 + 16 * warp + g;             // and key0 + 8
    const uint64_t k_desc = desc_k(sK + wg * 64 * 128);
    const uint64_t v_desc = desc_k(sV + wg * 64 * 128);
    const float c = p.scale_log2;

    mbar_wait(kv_full, 0);
    if constexpr (T::kOnePass) {
      float dk[T::kAcc], dv[T::kAcc];
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) dk[i] = dv[i] = 0.f;
      for (int j = 0; j < n_iter; ++j) {
        const int s = j % kStages;
        const int q0 = (first + j % per_head) * 64;
        const unsigned char* q_tile = sQ + s * T::kRows64;
        const unsigned char* do_tile = sdO + s * T::kRows64;
        mbar_wait(&full[s], (j / kStages) & 1);
        if (!p.causal || q0 + 63 >= kw0) {    // else wholly masked here
          float st[32], dpt[32];
          uint32_t hi[16], lo[16];
          wgmma_fence();
          ss_product<HD>(st, opaque(k_desc), 128, desc_k(q_tile));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          st_to_p(st, sL + s * 64, c, p.causal && q0 < kw0 + 63, key0, q0,
                  t);
          to_frags<kSplit>(st, hi, lo);
          // dV += P^T dO, then dP^T = V dO^T (issued as one batch, ptxas
          // spills at hd 64 and serializes the wgmmas at 80)
          wgmma_fence();
          rs_product<HD, kSplit>(dv, hi, lo, do_tile);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          wgmma_fence();
          ss_product<HD>(dpt, opaque(v_desc), 128, desc_k(do_tile));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dpt);
          p_to_ds(st, dpt, sD + s * 64, p.scale, t);
          to_frags<kSplit>(st, hi, lo);
          // dK += dS^T Q
          wgmma_fence();
          rs_product<HD, kSplit>(dk, hi, lo, q_tile);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      auto* out_k = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_strides[0] +
                    kvh * p.dk_strides[2];
      auto* out_v = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_strides[0] +
                    kvh * p.dv_strides[2];
      store_acc_rows<HD>(out_k, p.dk_strides[1], dk, key0, p.sk, t);
      store_acc_rows<HD>(out_v, p.dv_strides[1], dv, key0, p.sk, t);
    } else {
      // unrolled, so that each pass is compiled on its own: dP^T exists in
      // the second only
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {          // 0: dV, 1: dK
        float acc[T::kAcc];
#pragma unroll
        for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
        for (int j = 0; j < n_iter; ++j) {
          const int i = pass * n_iter + j;            // position in the ring
          const int s = i % kStages;
          const int q0 = (first + j % per_head) * 64;
          const unsigned char* q_tile = sQ + s * T::kRows64;
          const unsigned char* do_tile = sdO + s * T::kRows64;
          mbar_wait(&full[s], (i / kStages) & 1);
          if (!p.causal || q0 + 63 >= kw0) {  // else wholly masked here
            float st[32], dpt[32];
            wgmma_fence();
            ss_product<HD>(st, opaque(k_desc), 128, desc_k(q_tile));
            if (pass == 1) {
              ss_product<HD>(dpt, opaque(v_desc), 128, desc_k(do_tile));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            if (pass == 1) fence_regs(dpt);
            st_to_p(st, sL + s * 64, c, p.causal && q0 < kw0 + 63, key0,
                    q0, t);
            if (pass == 1) p_to_ds(st, dpt, sD + s * 64, p.scale, t);
            uint32_t hi[16], lo[16];
            to_frags<kSplit>(st, hi, lo);
            // acc += P^T dO (pass 0) or dS^T Q (pass 1)
            wgmma_fence();
            rs_product<HD, kSplit>(acc, hi, lo,
                                   pass == 0 ? do_tile : q_tile);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        const long long* strides = pass == 0 ? p.dv_strides : p.dk_strides;
        auto* out = static_cast<__nv_bfloat16*>(pass == 0 ? p.dv : p.dk) +
                    b * strides[0] + kvh * strides[2];
        store_acc_rows<HD>(out, strides[1], acc, key0, p.sk, t);
      }
    }
  }
}

template <typename Kernel, typename P>
cudaError_t launch_sm90(Kernel kernel, int smem, long long blocks,
                        const P& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int HD, bool kSplit>
cudaError_t launch_sm90_pair(const DqParams& dq, long long dq_blocks,
                             const DkvParams& dkv, long long dkv_blocks,
                             cudaStream_t stream) {
  const cudaError_t err =
      launch_sm90(flash_bwd_dq_sm90_kernel<HD, kSplit>, Bwd<HD>::kDqSmem,
                  dq_blocks, dq, stream);
  if (err != cudaSuccess) return err;
  return launch_sm90(flash_bwd_dkv_sm90_kernel<HD, kSplit>,
                     Bwd<HD>::kDkvSmem, dkv_blocks, dkv, stream);
}

// The bf16 launch at head dims 64, 80, 112 and 128: a tensor map per operand
// and tile height, then the dq kernel and the dk / dv kernel on `stream`.
// A refused map or launch returns its error; nothing retries on another
// kernel. `split` = false (p and ds rounded once) exists at 128 only.
template <int HD>
cudaError_t launch_bwd_sm90(const BwdParams& p, int batch, int kv_heads,
                            bool split, cudaStream_t stream) {
  DqParams dq;
  DkvParams dkv;
  const bool mapped =
      make_tile_map(&dq.q_map, p.q, batch, p.sq, p.heads, HD, p.q_strides,
                    128) &&
      make_tile_map(&dq.do_map, p.dout, batch, p.sq, p.heads, HD,
                    p.do_strides, 128) &&
      make_tile_map(&dq.k_map, p.k, batch, p.sk, kv_heads, HD, p.k_strides,
                    64) &&
      make_tile_map(&dq.v_map, p.v, batch, p.sk, kv_heads, HD, p.v_strides,
                    64) &&
      make_tile_map(&dkv.k_map, p.k, batch, p.sk, kv_heads, HD,
                    p.k_strides, 128) &&
      make_tile_map(&dkv.v_map, p.v, batch, p.sk, kv_heads, HD,
                    p.v_strides, 128) &&
      make_tile_map(&dkv.q_map, p.q, batch, p.sq, p.heads, HD, p.q_strides,
                    64) &&
      make_tile_map(&dkv.do_map, p.dout, batch, p.sq, p.heads, HD,
                    p.do_strides, 64);
  if (!mapped) return cudaErrorInvalidValue;
  const float scale_log2 = p.scale * kLog2e;
  dq.lse = dkv.lse = p.lse;
  dq.delta = dkv.delta = p.delta;
  dq.dq = p.dq;
  dkv.dk = p.dk;
  dkv.dv = p.dv;
  for (int i = 0; i < 3; ++i) {
    dq.dq_strides[i] = p.dq_strides[i];
    dkv.dk_strides[i] = p.dk_strides[i];
    dkv.dv_strides[i] = p.dv_strides[i];
  }
  dq.sq = dkv.sq = p.sq;
  dq.sk = dkv.sk = p.sk;
  dq.heads = dkv.heads = p.heads;
  dq.group = dkv.group = p.group;
  dq.batch = dkv.batch = batch;
  dq.causal = dkv.causal = p.causal;
  dq.scale = dkv.scale = p.scale;
  dq.scale_log2 = dkv.scale_log2 = scale_log2;
  dq.n_q_tiles = (p.sq + 127) / 128;
  dkv.kv_heads = kv_heads;
  const long long dq_blocks =
      static_cast<long long>(dq.n_q_tiles) * p.heads * batch;
  const long long dkv_blocks =
      static_cast<long long>((p.sk + 127) / 128) * kv_heads * batch;
  if constexpr (HD == 128) {
    if (!split) {
      return launch_sm90_pair<HD, false>(dq, dq_blocks, dkv, dkv_blocks,
                                         stream);
    }
  }
  return launch_sm90_pair<HD, true>(dq, dq_blocks, dkv, dkv_blocks, stream);
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
                      int kv_heads, bool split, cudaStream_t stream) {
  const dim3 dq_grid((p.sq + kBQ - 1) / kBQ, p.heads, batch);
  const dim3 dkv_grid((p.sk + kBK - 1) / kBK, kv_heads, batch);
  cudaError_t err;
  if (dtype == 1) {
    // head dims 64, 80, 112, 128: the Hopper kernels; 16, 32 (test
    // shapes): the mma.sync kernels
    if constexpr (HD >= 64) {
      return launch_bwd_sm90<HD>(p, batch, kv_heads, split, stream);
    } else {
      const size_t rows = sizeof(__nv_bfloat16) * kBK * (HD + 8);
      const size_t cols = sizeof(__nv_bfloat16) * HD * (kBK + 8);
      err = launch(flash_bwd_dq_mma_kernel<HD>, kMmaThreads,
                   4 * rows + cols, dq_grid, p, stream);
      if (err != cudaSuccess) return err;
      return launch(flash_bwd_dkv_mma_kernel<HD>, kMmaThreads,
                    4 * rows + 2 * cols + 2 * kBQ * sizeof(float), dkv_grid,
                    p, stream);
    }
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
// elements (dq / dk / dv: of 2). split: bf16 at head dim 128 only, 1 to
// enter p and ds as hi + lo bf16 parts (what the port runs), 0 to round
// each once (to measure what the split costs); the other kernels always
// split. Launches the dq kernel, then the dk / dv kernel, on `stream`.
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides,
    const long long* dq_strides, const long long* dk_strides,
    const long long* dv_strides, int batch, int sq, int sk, int heads,
    int kv_heads, int head_dim, int causal, float scale, int dtype,
    int split, void* stream) {
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
  const bool sp = split != 0;
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_hd<16>(dtype, p, batch, kv, sp, s); break;
    case 32: err = launch_hd<32>(dtype, p, batch, kv, sp, s); break;
    case 64: err = launch_hd<64>(dtype, p, batch, kv, sp, s); break;
    case 80: err = launch_hd<80>(dtype, p, batch, kv, sp, s); break;
    case 112: err = launch_hd<112>(dtype, p, batch, kv, sp, s); break;
    case 128: err = launch_hd<128>(dtype, p, batch, kv, sp, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
