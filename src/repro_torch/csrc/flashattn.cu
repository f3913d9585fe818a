// Flash attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(hd) +
// mask) v per query head, with an online softmax over key tiles.
//
// Replaces: src/repro/kernels/flashattn.py::flash_attention_kernel (Pallas:
// grid (B, H, nq, nk) with the key axis sequential, the running max /
// denominator / accumulator in VMEM scratch across it, 512 x 512 tiles),
// reached through models/layers.py::chunked_attention in every prefill
// layer, and src/repro/kernels/flashattn.py::flash_attention_fwd_kernel
// (the same forward that also emits the logsumexp rows, lse (B, H, Sq),
// which the backward recomputes p from), reached through the custom VJP in
// every training layer. Plain versions: src/repro_torch/kernels/
// flashattn.py::flash_attention_plain and flash_attention_fwd_plain. One
// kernel serves both: the lse pointer is null for the serving path.
//
// What bounds it on this card: operations (the H100 SXM's peaks, as
// src/repro_torch/hw.py holds them). At the serving path's prefill
// (B = 8, H = 16, KV = 8, S = 2048, hd = 128, causal, bf16) the two
// products are 4 B H hd S (S + 1) / 2 = 1.37e11 FLOP, 0.139 ms at 989
// TFLOP/s (dense bf16), against q + k + v + o = 201 MB, 0.060 ms at 3.35
// TB/s; the training path's lse forward (B = 2, S = 4096) has the same
// 0.139 ms bound. Zamba2's shared attention (hd 80, B = 8, H = 32, S =
// 2048, causal) is bound at 0.174 ms, SeamlessM4T's hd-64 launches (B =
// 8, H = 16) at 0.035-0.070 ms, Kimi K2's (hd 112, 64 query heads over 8,
// causal) at 0.487 ms served (B 8, S 2,048) and 0.243 ms trained (B 1, S
// 4,096). In float32 (phase 3s of chip_smoke.py serves and trains
// Qwen3-0.6B so) the least time for float32-grade products on the tensor
// cores is three TF32 products at 494.7 TFLOP/s: 0.834 ms at the
// serving prefill's shape (2.052 ms on the 67 TFLOP/s FP32-FMA peak).
//
// Design. Blocks run in no order, so the TPU's sequential key axis becomes
// a loop inside the block: a CTA per (query tile, head, batch) walks the
// key tiles, skipping those wholly above the diagonal when causal (the
// Pallas kernel's pl.when(run)), and keeps its row max, denominator and
// output accumulator on chip for the whole loop. The tiles are
// Hopper-sized, not the TPU's 512 x 512; the wrapper's block_q / block_k
// only shape the plain version. q, k, v and o are read and written in the
// model's (B, S, heads, hd) layout through their strides (unit stride on
// hd), so the wrapper makes no transposed copies (float32 reads the split
// copies of its pre-pass, below). The GQA group maps query
// head h to key/value head h / (H / KV). Masked scores are -1e30 and the
// denominator is clamped at 1e-30, as in the reference; keys past the
// sequence's end are masked and query rows past the end are not stored.
// The launcher's switch on the head dim and dtype picks the kernel; none
// falls back on another:
//
//   bf16, head dims 64, 80, 112 and 128 (every dense config the port
//   serves and trains at 128; SeamlessM4T at 64, Zamba2's shared attention
//   at 80, Kimi K2 at 112): flash_fwd_sm90_kernel<HD>. Against the
//   operation bound it keeps the tensor cores fed: a CTA of 128 query
//   rows, two consumer warpgroups of 64 rows on wgmma and one producer
//   thread that streams 128-key K and V tiles by TMA (a tensor map per
//   operand, built on the host over the model's layout; 128-byte swizzle)
//   through a ring of full / empty mbarriers (two stages at hd 112 and
//   128, three at 80, four at 64: as deep as shared memory allows at 80,
//   and elsewhere the fastest measured; times below); setmaxnreg gives the
//   producer's registers to the consumers. S = Q K^T reads both operands
//   from shared memory, K-major, in HD / 16 k-steps; O += P V takes P from
//   registers (the S accumulator rounded to bf16 is the A fragment) and
//   reads V in its [key][hd] layout through the descriptor's transpose
//   bit, so nothing is staged transposed. A tile row is ceil(HD / 64)
//   64-column boxes: one at hd 64 (16 KB tiles), two at 80, 112 and 128
//   (32 KB). At hd 80 and 112 the second box's columns past the head dim
//   (80-127, 112-127) lie past the tensor and TMA fills them with zeros;
//   S's k-steps from the fifth on (one at 80, three at 112) read the
//   second box, and P V is one m64nHDk16 wgmma across both boxes (LBO =
//   the second box's distance), which writes exactly the HD / 2
//   accumulator floats a thread that the output has. The variants timed
//   while choosing, each in turns in one call on an H100 80GB HBM3 at
//   700 W (ms a launch; only the chosen ones were kept): at hd 80, B 8,
//   32 heads, causal 2,048, P V as one n80 0.608, as n64 + n16 0.613, as
//   n128 over the zeros 0.627, and a ring of three 0.608 against two
//   0.625; at hd 64, B 8, 16 heads, over 1,024 x 1,024 / causal 2,048 /
//   2,048 x 1,024 keys, a ring of four 0.118 / 0.238 / 0.223, of three
//   0.123 / 0.247 / 0.230, of two 0.118 / 0.250 / 0.223; at hd 112, 64
//   heads over 8, causal, a ring of two 1.147 (B 8, S 2,048) and 0.510
//   (lse, B 1, S 4,096) against three 1.208 and 0.519 (the first design
//   on mma.sync: 3.833 and 2.011). The epilogue stores the HD real
//   columns only. The online softmax runs in exp2 with scale
//   log2(e) folded in; p enters P V in bf16 while the denominator sums it
//   in float32; lse is written in natural log. Masking runs only on
//   tiles that cross the diagonal or the keys' end, and the heaviest
//   (last) query tiles launch first. A refused tensor map or launch
//   returns its error. Not done yet: the two consumer warpgroups wait on
//   the same barriers and so run in lockstep, and the softmax's exp2
//   work is never hidden under the other warpgroup's wgmma
//   (FlashAttention-3's ping-pong would order them).
//   bf16, head dims 16 and 32 (test shapes, off every main path): the
//   first design, flash_mma_kernel: four warps, 16 query rows each, on
//   mma.sync.m16n8k16 with float32 accumulation; Q's fragments stay in
//   registers, each 64-key tile is staged in shared memory (K row-major,
//   V transposed), S = Q K^T in HD / 16 k-steps. It beats the library
//   there (0.035 against 0.040 ms over phase 2's four launches, PR 25)
//   and is left as it is.
//   float32, every head dim (Qwen3-0.6B in float32 at 128, phase 3s;
//   test shapes at the others): flash_fwd_tf32_sm90_kernel<HD>, the
//   structure of the bf16 kernel on 3xTF32 wgmma (flash_tf32.cuh): hi =
//   tf32(x) and lo = tf32(x - hi), three products a_lo b_hi + a_hi b_lo +
//   a_hi b_hi each. wgmma has no transpose bit for tf32, so both
//   shared-memory operands are K-major: S = Q K^T reads Q and K as the
//   model lays them out, and P V reads V^T ([hd][key]) from a copy that
//   a pre-pass (tf32_split_kernel, one launch for q, k and v) writes
//   into a workspace the wrapper allocates, split into hi and lo, keys
//   in each group of 8 in the order the S accumulator's registers hold
//   them, so that P's tf32 A fragments come from the accumulator without
//   a shuffle; the same pass writes q's and k's hi / lo copies. A
//   transpose in shared memory by the loading warps was the other
//   choice; the pre-pass keeps the kernel a plain TMA ring and costs
//   bytes only (each operand read once, its copies written once). The
//   tiles are halved against bf16: hi and lo double a float32 tile, which
//   is twice bf16's, so a CTA is one consumer warpgroup of 64 query rows
//   and a producer warp (160 threads; every thread may keep 255
//   registers, so setmaxnreg has nothing to hand over: ptxas gives the
//   consumers 120-164), with 64-key K and V^T tiles in rings of their
//   own (a K tile is free once S is computed, a V^T tile once P V is),
//   two stages deep at hd 16-80 and one at 112 and 128, where Q, K and
//   V^T take 192 KB. Each tile's P V is computed into fresh registers
//   and added to O in float32 (fmaf with the rescale): the tensor
//   cores' float32 sums do not round to nearest, and an accumulator that
//   took every tile's products drifts with the length of the row.
#include "flash_tiles.cuh"
#include "flash_tf32.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                     // (B, H, Sq) float32, or null
  long long q_strides[3];         // batch, sequence, head (elements)
  long long k_strides[3];
  long long v_strides[3];
  long long o_strides[3];
  int sq, sk, heads, group;       // group = H / KV
  int causal;
  float scale;
};

// The number of key tiles the q tile starting at q0 reads.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int n = (p.sk + kBK - 1) / kBK;
  if (p.causal) {
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n = last < n ? last : n;
  }
  return n;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sVt = sK + kBK * (HD + 8);     // [HD][kBK + 8]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                         // fragment row group
  const int t = lane % 4;                         // thread in group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;

  const auto* q = static_cast<const __nv_bfloat16*>(p.q) +
                  b * p.q_strides[0] + h * p.q_strides[2];
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) +
                  b * p.k_strides[0] + kvh * p.k_strides[2];
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) +
                  b * p.v_strides[0] + kvh * p.v_strides[2];
  auto* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_strides[0] +
            h * p.o_strides[2];

  // Q's A fragments, staged through the K buffer once.
  stage_tile<HD, false>(sK, q, p.q_strides[1], q0, p.sq);
  __syncthreads();
  uint32_t qf[HD / 16][4];
  {
    const __nv_bfloat16* r_lo = sK + (warp * 16 + g) * (HD + 8) + 2 * t;
    const __nv_bfloat16* r_hi = r_lo + 8 * (HD + 8);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      qf[ks][0] = lds32(r_lo + ks * 16);
      qf[ks][1] = lds32(r_hi + ks * 16);
      qf[ks][2] = lds32(r_lo + ks * 16 + 8);
      qf[ks][3] = lds32(r_hi + ks * 16 + 8);
    }
  }

  // rows g and g + 8 of this warp's 16
  const int qpos0 = q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }

  const int n_tiles = key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // every warp is done with the last tile
    stage_tile<HD, false>(sK, k, p.k_strides[1], k0, p.sk);
    stage_tile<HD, true>(sVt, v, p.v_strides[1], k0, p.sk);
    __syncthreads();

    // S = Q K^T: 8 column tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * (HD + 8) + 2 * t;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        mma_bf16(s[nt], qf[ks], lds32(kr + ks * 16), lds32(kr + ks * 16 + 8));
      }
    }

    // scale, mask, and the tile's row max
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + nt * 8 + 2 * t + (i & 1);
        const int qpos = i < 2 ? qpos0 : qpos1;
        const bool valid = kpos < p.sk && (!p.causal || qpos >= kpos);
        const float x = valid ? s[nt][i] * p.scale : kNegInf;
        s[nt][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = exp(s - m): float32 into the denominator, bf16 into the product
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[kBK / 8][2];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn0), p1 = expf(s[nt][1] - mn0);
      const float p2 = expf(s[nt][2] - mn1), p3 = expf(s[nt][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[nt][0] = pack_bf16(p0, p1);
      pf[nt][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // acc = acc * alpha + P V: P's C fragments are A fragments of k = 16
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
      const __nv_bfloat16* vr = sVt + (dt * 8 + g) * (kBK + 8) + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                               pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
        mma_bf16(acc[dt], a, lds32(vr + kk * 16), lds32(vr + kk * 16 + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    if (qpos0 < p.sq) lse[qpos0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (qpos1 < p.sq) lse[qpos1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (qpos0 < p.sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          o + static_cast<long long>(qpos0) * p.o_strides[1] + d) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (qpos1 < p.sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          o + static_cast<long long>(qpos1) * p.o_strides[1] + d) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64, 80, 112, 128: TMA ring + wgmma (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kFwdBM = 128;          // query rows per CTA (two warpgroups)
constexpr int kFwdBN = 128;          // keys per tile
constexpr int kFwdThreads = 384;     // consumers: warpgroups 0, 1; producer: 2

// The forward's shape at head dim HD: a tile of 128 rows is ceil(HD / 64)
// halves of 128 x 128 bytes (two at hd 80, 112 and 128); O's accumulator
// is HD / 2 floats a thread (56 at hd 112). The ring is as deep as was
// measured fastest (times in the header).
template <int HD>
struct Fwd {
  static constexpr int kHalves = (HD + 63) / 64;
  static constexpr int kTile = 128 * 128 * kHalves;
  static constexpr int kStages = HD == 64 ? 4 : HD == 80 ? 3 : 2;
  static constexpr int kBars = 1 + 3 * kStages;    // q, k / v full, empty
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kTile + 8 * kBars;
  static_assert(HD == 64 || HD == 80 || HD == 112 || HD == 128, "head dim");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Sm90Params {
  CUtensorMap q_map, k_map, v_map;
  void* o;
  float* lse;                     // (B, H, Sq) float32, or null
  long long o_strides[3];
  int sq, sk, heads, group, batch, n_q_tiles;
  int causal;
  float scale;                    // 1 / sqrt(hd)
  float scale_log2;               // scale * log2(e)
};

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ Sm90Params p) {
  using F = Fwd<HD>;
  constexpr int kStages = F::kStages, kTile = F::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + kTile;                       // [stage]
  unsigned char* sV = sK + kStages * kTile;               // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                            // [stage]
  uint64_t* v_full = k_full + kStages;                    // [stage]
  uint64_t* empty = v_full + kStages;                     // [stage]

  // the heaviest (last, when causal) query tiles first
  const int bh = p.heads * p.batch;
  const int qt = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % p.heads;
  const int b = static_cast<int>(blockIdx.x) % bh / p.heads;
  const int q0 = qt * kFwdBM;
  int n_tiles = (p.sk + kFwdBN - 1) / kFwdBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kFwdBM - 1) / kFwdBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    regs_release<40>();
    if (threadIdx.x == 256) {
      const int kvh = h / p.group;
      mbar_arrive_expect_tx(q_full, kTile);
      tma_load_rows<F::kHalves>(sQ, &p.q_map, q_full, kFwdBM, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], kTile);
        tma_load_rows<F::kHalves>(sK + s * kTile, &p.k_map, &k_full[s],
                                  kFwdBN, j * kFwdBN, kvh, b);
        mbar_arrive_expect_tx(&v_full[s], kTile);
        tma_load_rows<F::kHalves>(sV + s * kTile, &p.v_map, &v_full[s],
                                  kFwdBN, j * kFwdBN, kvh, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    regs_claim<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;   // and row0 + 8
    const int wg_row = q0 + 64 * wg;                 // the group's first row
    const uint64_t q_desc = desc_k(sQ + wg * 64 * 128);
    const float c = p.scale_log2;

    constexpr int kO = HD / 2;
    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;   // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;           // this thread's part of the sums

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const unsigned char* k_tile = sK + s * kTile;
      const unsigned char* v_tile = sV + s * kTile;
      const int k0 = j * kFwdBN;

      // S = Q K^T over the head dim's HD / 16 k-steps (k-step 4 onwards in
      // the second half: one at hd 80, three at 112, four at 128)
      float sc[64];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
      const uint64_t qd = opaque(q_desc), kd = desc_k(k_tile);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        wgmma_ss_n128(sc, kstep_k(qd, kFwdBM, ks), kstep_k(kd, kFwdBN, ks),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // the mask, only where the tile reaches past a row's position or
      // the keys' end
      if (k0 + kFwdBN > p.sk || (p.causal && k0 + kFwdBN - 1 > wg_row)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qpos = row0 + ((i & 2) ? 8 : 0);
          if (kpos >= p.sk || (p.causal && kpos > qpos)) sc[i] = kNegInf;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2f((m0 - mx0) * c);
      const float alpha1 = exp2f((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      // (a row with every key masked so far takes p = 0, not 2^(huge))
      const float mc0 = mx0 == kNegInf ? 0.f : mx0 * c;
      const float mc1 = mx1 == kNegInf ? 0.f : mx1 * c;

      // p = 2^(s c - m c): float32 into the sums, bf16 into P V
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        sc[i] = exp2f(fmaf(sc[i], c, -mc0));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], c, -mc0));
        sc[i + 2] = exp2f(fmaf(sc[i + 2], c, -mc1));
        sc[i + 3] = exp2f(fmaf(sc[i + 3], c, -mc1));
        sum0 += sc[i] + sc[i + 1];
        sum1 += sc[i + 2] + sc[i + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      uint32_t pf[32];
      acc_to_frags(sc, pf);
#pragma unroll
      for (int i = 0; i < kO; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }

      // O += P V: V read N-major in its [key][head dim] layout
      mbar_wait(&v_full[s], parity);
      const uint64_t vd = desc_n(v_tile, kFwdBN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdBN / 16; ++kk) {
        const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                               pf[4 * kk + 3]};
        wgmma_rs_hd<HD>(o, a, kstep_n(vd, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (p.lse != nullptr && t == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
      if (row0 < p.sq) lse[row0] = m0 * p.scale + logf(fmaxf(l0, 1e-30f));
      if (row0 + 8 < p.sq) {
        lse[row0 + 8] = m1 * p.scale + logf(fmaxf(l1, 1e-30f));
      }
    }
    // only the HD real columns: the output's rows are HD wide
    auto* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_strides[0] +
                h * p.o_strides[2];
#pragma unroll
    for (int i = 0; i < HD / 2; i += 4) {
      const int d = 8 * (i / 4) + 2 * t;
      if (row0 < p.sq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(row0) * p.o_strides[1] + d) =
            __floats2bfloat162_rn(o[i] * inv0, o[i + 1] * inv0);
      }
      if (row0 + 8 < p.sq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(row0 + 8) * p.o_strides[1] + d) =
            __floats2bfloat162_rn(o[i + 2] * inv1, o[i + 3] * inv1);
      }
    }
  }
}

// The bf16 launch at head dims 64, 80, 112 and 128: a tensor map per operand,
// a CTA per (query tile, head, batch). A refused map or launch returns its
// error; nothing retries on another kernel.
template <int HD>
cudaError_t launch_sm90(const Params& p, int batch, int kv_heads,
                        cudaStream_t stream) {
  Sm90Params s;
  const bool mapped =
      make_tile_map(&s.q_map, p.q, batch, p.sq, p.heads, HD, p.q_strides,
                    kFwdBM) &&
      make_tile_map(&s.k_map, p.k, batch, p.sk, kv_heads, HD, p.k_strides,
                    kFwdBN) &&
      make_tile_map(&s.v_map, p.v, batch, p.sk, kv_heads, HD, p.v_strides,
                    kFwdBN);
  if (!mapped) return cudaErrorInvalidValue;
  s.o = p.o;
  s.lse = p.lse;
  for (int i = 0; i < 3; ++i) s.o_strides[i] = p.o_strides[i];
  s.sq = p.sq;
  s.sk = p.sk;
  s.heads = p.heads;
  s.group = p.group;
  s.batch = batch;
  s.n_q_tiles = (p.sq + kFwdBM - 1) / kFwdBM;
  s.causal = p.causal;
  s.scale = p.scale;
  s.scale_log2 = p.scale * kLog2e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fwd<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(s.n_q_tiles) * p.heads *
                           batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_sm90_kernel<HD><<<static_cast<unsigned>(blocks), kFwdThreads,
                              Fwd<HD>::kSmem, stream>>>(s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32, every head dim: 3xTF32 on wgmma, TMA ring (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kT32Threads = 160;     // consumer: warpgroup 0; producer: warp 4

// The float32 forward's shape at head dim HD: one consumer warpgroup of 64
// query rows, 64-key tiles. Q, K and V^T are each a hi and a lo tile:
// Q and K ceil(HD / 32) boxes of 64 rows x 128 bytes, V^T (HD rows by 64
// keys) two boxes of HD x 128 bytes. K and V^T have rings of their own
// (a K tile is free once S is computed, a V^T tile once P V is), two deep
// where shared memory holds it (hd 16-80) and one deep at 112 and 128,
// where Q alone takes 64 KB: 192 KB at hd 128.
template <int HD>
struct FwdT32 {
  static constexpr int kBoxes = (HD + 31) / 32;
  static constexpr int kQ = 64 * 128 * kBoxes;          // one part of Q
  static constexpr int kK = 64 * 128 * kBoxes;          // one part of K
  static constexpr int kV = HD * 128 * 2;               // one part of V^T
  static constexpr int kFixed = 1024 + 2 * kQ;
  static constexpr int kStage = 2 * kK + 2 * kV;
  static constexpr int kStages =
      kFixed + 2 * kStage + 8 * 9 <= 232448 ? 2 : 1;
  static constexpr int kBars = 1 + 4 * kStages;   // q; k, v full and empty
  static constexpr int kSmem = kFixed + kStages * kStage + 8 * kBars;
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 80 || HD == 112 ||
                HD == 128, "head dim");
  static_assert(kSmem <= 232448, "shared memory");
};

struct T32Params {
  CUtensorMap q_map[2], k_map[2];   // hi, lo row copies: boxes of 64 rows
  CUtensorMap v_map[2];             // hi, lo transposed copies of v
  float* o;
  float* lse;                       // (B, H, Sq) float32, or null
  long long o_strides[3];
  int sq, sk, heads, group, batch, n_q_tiles;
  int causal;
  float scale;                      // 1 / sqrt(hd)
  float scale_log2;                 // scale * log2(e)
};

template <int HD>
__global__ void __launch_bounds__(kT32Threads, 1)
flash_fwd_tf32_sm90_kernel(const __grid_constant__ T32Params p) {
  using F = FwdT32<HD>;
  constexpr int kStages = F::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;                                 // hi, lo
  unsigned char* sK = sQ + 2 * F::kQ;                       // [stage] hi, lo
  unsigned char* sV = sK + kStages * 2 * F::kK;             // [stage] hi, lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * 2 * F::kV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                              // [stage]
  uint64_t* k_empty = k_full + kStages;                     // [stage]
  uint64_t* v_full = k_empty + kStages;                     // [stage]
  uint64_t* v_empty = v_full + kStages;                     // [stage]

  // the heaviest (last, when causal) query tiles first
  const int bh = p.heads * p.batch;
  const int qt = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % p.heads;
  const int b = static_cast<int>(blockIdx.x) % bh / p.heads;
  const int q0 = qt * 64;
  int n_tiles = (p.sk + 63) / 64;
  if (p.causal) n_tiles = min(n_tiles, q0 / 64 + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4);      // one arrival per consumer warp
      mbar_init(&v_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread keeps both rings full
    if (threadIdx.x == 128) {
      const int kvh = h / p.group;
      mbar_arrive_expect_tx(q_full, 2 * F::kQ);
      for (int part = 0; part < 2; ++part) {
        for (int x = 0; x < F::kBoxes; ++x) {
          tma_load(sQ + part * F::kQ + x * 64 * 128, &p.q_map[part], q_full,
                   32 * x, q0, h, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t reuse = (j / kStages - 1) & 1;
        if (j >= kStages) mbar_wait(&k_empty[s], reuse);
        mbar_arrive_expect_tx(&k_full[s], 2 * F::kK);
        for (int part = 0; part < 2; ++part) {
          for (int x = 0; x < F::kBoxes; ++x) {
            tma_load(sK + (2 * s + part) * F::kK + x * 64 * 128,
                     &p.k_map[part], &k_full[s], 32 * x, 64 * j, kvh, b);
          }
        }
        if (j >= kStages) mbar_wait(&v_empty[s], reuse);
        mbar_arrive_expect_tx(&v_full[s], 2 * F::kV);
        for (int part = 0; part < 2; ++part) {
          for (int x = 0; x < 2; ++x) {
            tma_load(sV + (2 * s + part) * F::kV + x * HD * 128,
                     &p.v_map[part], &v_full[s], 64 * j + 32 * x, 0, kvh, b);
          }
        }
      }
    }
  } else {
    // consumer: the warpgroup owns query rows q0 .. q0 + 63
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 16 * warp + g;             // and row0 + 8
    const uint64_t q_hi = desc_k(sQ), q_lo = desc_k(sQ + F::kQ);
    const float c = p.scale_log2;

    constexpr int kO = HD / 2;
    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;   // running max of the raw scores
    float l0 = 0.f, l1 = 0.f;           // this thread's part of the sums

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const unsigned char* k_tile = sK + 2 * s * F::kK;
      const unsigned char* v_tile = sV + 2 * s * F::kV;
      const int k0 = j * 64;

      // S = Q K^T, 3xTF32 over the head dim's HD / 8 k-steps
      float sc[32];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
      ss3_product<HD, 64>(sc, opaque(q_hi), opaque(q_lo), 64,
                          desc_k(k_tile), desc_k(k_tile + F::kK));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[s]);

      // the mask, only where the tile reaches past a row's position or
      // the keys' end
      if (k0 + 64 > p.sk || (p.causal && k0 + 63 > q0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qpos = row0 + ((i & 2) ? 8 : 0);
          if (kpos >= p.sk || (p.causal && kpos > qpos)) sc[i] = kNegInf;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2f((m0 - mx0) * c);
      const float alpha1 = exp2f((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      // (a row with every key masked so far takes p = 0, not 2^(huge))
      const float mc0 = mx0 == kNegInf ? 0.f : mx0 * c;
      const float mc1 = mx1 == kNegInf ? 0.f : mx1 * c;

      // p = 2^(s c - m c): float32 into the sums, split into P V
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        sc[i] = exp2f(fmaf(sc[i], c, -mc0));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], c, -mc0));
        sc[i + 2] = exp2f(fmaf(sc[i + 2], c, -mc1));
        sc[i + 3] = exp2f(fmaf(sc[i + 3], c, -mc1));
        sum0 += sc[i] + sc[i + 1];
        sum1 += sc[i + 2] + sc[i + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      uint32_t ph[32], pl[32];
      acc_to_tf32_frags(sc, ph, pl);

      // O = O alpha + P V: the tile's P V, 3xTF32, V^T read K-major from
      // its transposed copy, then added in float32 (rs3_product)
      float pv[kO];
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
      rs3_product<HD, 64>(pv, ph, pl, desc_k(v_tile),
                          desc_k(v_tile + F::kV));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[s]);
#pragma unroll
      for (int i = 0; i < kO; i += 4) {
        o[i] = fmaf(o[i], alpha0, pv[i]);
        o[i + 1] = fmaf(o[i + 1], alpha0, pv[i + 1]);
        o[i + 2] = fmaf(o[i + 2], alpha1, pv[i + 2]);
        o[i + 3] = fmaf(o[i + 3], alpha1, pv[i + 3]);
      }
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (p.lse != nullptr && t == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
      if (row0 < p.sq) lse[row0] = m0 * p.scale + logf(fmaxf(l0, 1e-30f));
      if (row0 + 8 < p.sq) {
        lse[row0 + 8] = m1 * p.scale + logf(fmaxf(l1, 1e-30f));
      }
    }
    float* out = p.o + b * p.o_strides[0] + h * p.o_strides[2];
#pragma unroll
    for (int i = 0; i < kO; i += 4) {
      const int d = 8 * (i / 4) + 2 * t;
      if (row0 < p.sq) {
        *reinterpret_cast<float2*>(
            out + static_cast<long long>(row0) * p.o_strides[1] + d) =
            make_float2(o[i] * inv0, o[i + 1] * inv0);
      }
      if (row0 + 8 < p.sq) {
        *reinterpret_cast<float2*>(
            out + static_cast<long long>(row0 + 8) * p.o_strides[1] + d) =
            make_float2(o[i + 2] * inv1, o[i + 3] * inv1);
      }
    }
  }
}

// The float32 workspace's floats: q's and k's row copies, v's transposed
// copy, each hi then lo.
long long tf32_fwd_floats(int batch, int sq, int sk, int heads, int kv_heads,
                          int hd) {
  return rows_floats(batch, sq, heads, hd) +
         rows_floats(batch, sk, kv_heads, hd) +
         cols_floats(batch, sk, kv_heads, hd);
}

// The float32 launch: the pre-pass writes the split copies into `ws`,
// then a tensor map per copy and a CTA per (64-row query tile, head,
// batch). A refused map or launch returns its error; nothing retries on
// another kernel.
template <int HD>
cudaError_t launch_tf32(const Params& p, int batch, int kv_heads, float* ws,
                        cudaStream_t stream) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  float* q_rows = ws;
  float* k_rows = q_rows + rows_floats(batch, p.sq, p.heads, HD);
  float* v_cols = k_rows + rows_floats(batch, p.sk, kv_heads, HD);
  Split split(batch, HD);
  split.add(p.q, p.q_strides, p.sq, p.heads, q_rows, nullptr);
  split.add(p.k, p.k_strides, p.sk, kv_heads, k_rows, nullptr);
  split.add(p.v, p.v_strides, p.sk, kv_heads, nullptr, v_cols);
  cudaError_t err = split.launch(stream);
  if (err != cudaSuccess) return err;
  T32Params s;
  const long long q_part = rows_floats(batch, p.sq, p.heads, HD) / 2;
  const long long k_part = rows_floats(batch, p.sk, kv_heads, HD) / 2;
  const long long v_part = cols_floats(batch, p.sk, kv_heads, HD) / 2;
  bool mapped = true;
  for (int part = 0; part < 2; ++part) {
    mapped = mapped &&
             make_rows_map(&s.q_map[part], q_rows + part * q_part, batch,
                           p.sq, p.heads, HD, 64) &&
             make_rows_map(&s.k_map[part], k_rows + part * k_part, batch,
                           p.sk, kv_heads, HD, 64) &&
             make_cols_map(&s.v_map[part], v_cols + part * v_part, batch,
                           seq8(p.sk), kv_heads, HD);
  }
  if (!mapped) return cudaErrorInvalidValue;
  s.o = static_cast<float*>(p.o);
  s.lse = p.lse;
  for (int i = 0; i < 3; ++i) s.o_strides[i] = p.o_strides[i];
  s.sq = p.sq;
  s.sk = p.sk;
  s.heads = p.heads;
  s.group = p.group;
  s.batch = batch;
  s.n_q_tiles = (p.sq + 63) / 64;
  s.causal = p.causal;
  s.scale = p.scale;
  s.scale_log2 = p.scale * kLog2e;
  err = cudaFuncSetAttribute(flash_fwd_tf32_sm90_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FwdT32<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(s.n_q_tiles) * p.heads *
                           batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tf32_sm90_kernel<HD><<<static_cast<unsigned>(blocks),
                                   kT32Threads, FwdT32<HD>::kSmem,
                                   stream>>>(s);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Params& p,
                   int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int batch, float* ws,
                      cudaStream_t stream) {
  if (dtype == 0) {
    return launch_tf32<HD>(p, batch, p.heads / p.group, ws, stream);
  }
  // head dims 64, 80, 112, 128: the Hopper kernel; 16, 32 (test shapes):
  // the mma.sync kernel
  if constexpr (HD >= 64) {
    return launch_sm90<HD>(p, batch, p.heads / p.group, stream);
  } else {
    const size_t smem = sizeof(__nv_bfloat16) *
                        (kBK * (HD + 8) + HD * (kBK + 8));
    return launch(flash_mma_kernel<HD>, kMmaThreads, smem, p, batch, stream);
  }
}

}  // namespace

// The bytes of workspace flash_attention_launch needs: float32's split
// copies of q, k and v; 0 for bfloat16.
extern "C" long long flash_attention_workspace(int batch, int sq, int sk,
                                               int heads, int kv_heads,
                                               int head_dim, int dtype) {
  return dtype == 0 ? 4 * tf32_fwd_floats(batch, sq, sk, heads, kv_heads,
                                          head_dim)
                    : 0;
}

// q: (B, Sq, H, hd), k / v: (B, Sk, KV, hd), o: (B, Sq, H, hd), each given
// by its base pointer and (batch, sequence, head) strides in elements; hd
// is contiguous. lse: null, or a contiguous (B, H, Sq) float32 buffer that
// receives each row's logsumexp m + log(max(l, 1e-30)) of the scaled,
// masked scores (the backward's saved statistic); a null lse runs exactly
// the lse-free kernel. dtype: 0 float32, 1 bfloat16 (q, k, v and o alike). For
// bfloat16 every pointer must be 16-byte aligned and every k / v / q
// stride a multiple of 8 elements. workspace: float32 only,
// flash_attention_workspace's bytes, 16-byte aligned. Returns a
// cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, int batch,
    int sq, int sk, int heads, int kv_heads, int head_dim, int causal,
    float scale, int dtype, void* workspace, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || kv_heads < 1 || heads < 1 ||
      heads % kv_heads != 0 || heads > 65535 || batch > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  for (int i = 0; i < 3; ++i) {
    p.q_strides[i] = q_strides[i];
    p.k_strides[i] = k_strides[i];
    p.v_strides[i] = v_strides[i];
    p.o_strides[i] = o_strides[i];
  }
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.group = heads / kv_heads;
  p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_hd<16>(dtype, p, batch, ws, s); break;
    case 32: err = launch_hd<32>(dtype, p, batch, ws, s); break;
    case 64: err = launch_hd<64>(dtype, p, batch, ws, s); break;
    case 80: err = launch_hd<80>(dtype, p, batch, ws, s); break;
    case 112: err = launch_hd<112>(dtype, p, batch, ws, s); break;
    case 128: err = launch_hd<128>(dtype, p, batch, ws, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
