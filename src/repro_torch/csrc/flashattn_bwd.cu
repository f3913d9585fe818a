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
// 1, 64 heads over 8, causal 4,096) at 0.608 ms. In float32 (phase 3s of
// chip_smoke.py trains Qwen3-0.6B so, B 4 a microbatch) three TF32
// products at 494.7 TFLOP/s bound the launch at 4.168 ms (10.26 ms on the
// 67 TFLOP/s FP32-FMA peak).
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
//   bf16, every head dim (every dense config the port trains at 128;
//   SeamlessM4T at 64, Zamba2's shared attention at 80, Kimi K2 at 112;
//   16 and 32 are test shapes, off every main path, whose first design on
//   mma.sync this replaced): flash_bwd_dq_sm90_kernel<HD, true>, then
//   flash_bwd_dkv_sm90_kernel<HD, true>. Against the operation bound they
//   keep the tensor cores fed: each CTA has two consumer warpgroups on
//   wgmma and a producer that streams tiles by TMA (tensor maps over the
//   model's layout, 128-byte swizzle) through a ring of full / empty
//   mbarriers, and setmaxnreg gives the producer's registers to the
//   consumers. A tile row is ceil(HD / 64) boxes of 64 columns: one at hd
//   16, 32 and 64, two at 80, 112 and 128; TMA fills the columns past the
//   head dim (16-63, 32-63, 80-127, 112-127) with zeros. The products
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
//   hd 16-80 in one pass: dK and dV (32 + 32 or 40 + 40 floats a
//   thread) stay live, S^T is computed once and Q, dO stream once; a tile
//   runs S^T, p^T and its fragments, dV += P^T dO, dP^T, ds^T, dK += dS^T
//   Q, each product waited for before the next. p is 2^(s scale log2(e) -
//   lse log2(e)). The ring has three stages at hd 80, 112 and 128 and six
//   at 16-64. The variants timed while choosing, each in turns in one call on
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
//   float32, every head dim (Qwen3-0.6B in float32 at 128, phase 3s;
//   test shapes at the others): flash_bwd_dq_tf32_sm90_kernel<HD>, then
//   flash_bwd_dkv_tf32_sm90_kernel<HD>, with every product as three TF32
//   products on wgmma (flash_tf32.cuh), so the float32 backward stays
//   float32-grade throughout, as the plain version is. wgmma has no
//   transpose bit for tf32, so both shared-memory operands are K-major:
//   the products over the head dim (S, dP; S^T, dP^T) read their
//   operands as laid out, and the products over keys or queries read K^T
//   (dQ += dS K), dO^T (dV += P^T dO) and Q^T (dK += dS^T Q) from
//   transposed copies. A pre-pass (tf32_split_kernel, one launch) writes
//   every copy once per launch into a workspace the wrapper allocates:
//   the hi / lo rows of q, k, v and do, the hi / lo transposes of k, q
//   and do (rows of each aligned group of 8 in the order the
//   accumulators' registers hold them, so that dS, P^T and dS^T become
//   tf32 A fragments without a shuffle). Hi and lo double each tile
//   against a float32 one, so each CTA is one consumer warpgroup owning
//   64 rows and a producer warp (160 threads, up to 255 registers a
//   thread, no setmaxnreg), the other side streaming in tiles of 32: dq
//   holds Q and dO (128 KB at hd 128) and a stage of K, V and K^T; dk /
//   dv holds K and V and a stage of Q, dO and one transposed tile, dO^T
//   in a first pass (dV) and Q^T in a second (dK, S^T computed again),
//   225 KB at hd 128; each ring (the rows, free once the products over
//   the head dim are done; the transposed tile, free once its product
//   is) has its own barriers, two stages deep at hd 16-64 and one at
//   80-128. The group's sum stays in registers, as in bf16: no atomics,
//   and two runs give the same bits. Each tile's dQ, dV or dK product is
//   computed into fresh registers and added to the total in float32:
//   the tensor cores' float32 sums do not round to nearest, and when
//   each accumulator took every tile's products (some 12,000 for dk / dv
//   at a GQA group of 8 over 4,096 queries) the float32 backward used
//   0.65 of the card's gate against the plain version, and 0.058 with
//   the tile totals (phase 2 of chip_smoke.py on an H100 80GB HBM3 at
//   700 W); Qwen3-0.6B's gradients in float32 moved by 3.0e-4 and 8.0e-6
//   of a leaf's RMS.
#include "flash_tf32.cuh"

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

// ---------------------------------------------------------------------------
// bf16, every head dim: TMA ring + wgmma (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;     // consumers: warpgroups 0, 1; producer: 2

// The backward's shape at head dim HD: a tile row is ceil(HD / 64) halves
// of 64 columns (128 bytes a row each; at hd 16, 32, 80 and 112 TMA
// zero-fills the columns past the head dim); a warpgroup's 64 x HD
// accumulator is HD / 2 floats a thread. At hd 16-80 the dk / dv kernel
// makes one pass (dK and dV live together), at 112 and 128 two (one pass
// spilled).
// The ring is as deep as was measured fastest (times in the header).
template <int HD>
struct Bwd {
  static constexpr int kHalves = (HD + 63) / 64;
  static constexpr int kRows128 = 128 * 128 * kHalves;  // bytes of 128 rows
  static constexpr int kRows64 = 64 * 128 * kHalves;    // bytes of 64 rows
  static constexpr int kStages = HD <= 64 ? 6 : 3;
  static constexpr bool kOnePass = HD < 112;
  static constexpr int kAcc = HD / 2;
  static constexpr int kBars = 1 + 2 * kStages;  // loaded once; full, empty
  static constexpr int kDqSmem =
      1024 + 2 * kRows128 + 2 * kStages * kRows64 + 8 * kBars;
  static constexpr int kDkvSmem = kDqSmem + 2 * kStages * 64 * 4;
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 80 || HD == 112 ||
                HD == 128, "head dim");
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
                        const P& p, cudaStream_t stream,
                        int threads = kBwdThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p);
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

// The bf16 launch at every head dim: a tensor map per operand
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

// ---------------------------------------------------------------------------
// float32, every head dim: 3xTF32 on wgmma, TMA ring (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kT32Threads = 160;     // consumer: warpgroup 0; producer: warp 4

// The float32 backward's shape at head dim HD. Every operand is a hi and a
// lo tile (flash_tf32.cuh): a row tile is ceil(HD / 32) boxes of 32
// columns, a transposed tile (HD rows by 32 rows of the sequence) one box
// of HD x 128 bytes. One consumer warpgroup owns 64 rows (queries in dq,
// keys in dk / dv) and streams tiles of 32 of the other side. dq: Q and dO
// once; a stage holds K, V and K^T, with a ring for K and V (free once S
// and dP are computed) and one for K^T (free once dQ += dS K is). dk /
// dv: K and V once; a stage holds Q, dO (with their lse and delta rows)
// and one transposed tile, dO^T in the first pass (dV += P^T dO) and Q^T
// in the second (dK += dS^T Q), so that four row tiles and one transposed
// one fit: 225 KB at hd 128. Two stages where they fit (hd 16-64).
template <int HD>
struct BwdT32 {
  static constexpr int kBoxes = (HD + 31) / 32;
  static constexpr int kRows64 = 64 * 128 * kBoxes;     // one part, 64 rows
  static constexpr int kRows32 = 32 * 128 * kBoxes;     // one part, 32 rows
  static constexpr int kCols32 = HD * 128;              // one transposed part
  static constexpr int kFixed = 1024 + 4 * kRows64;
  static constexpr int kStage = 4 * kRows32 + 2 * kCols32;
  static constexpr int kRowsBytes = 2 * 32 * 4;         // lse, delta rows
  static constexpr int kStages =
      kFixed + 2 * (kStage + kRowsBytes) + 8 * 9 <= 232448 ? 2 : 1;
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kDqSmem = kFixed + kStages * kStage + 8 * kBars;
  static constexpr int kDkvSmem = kDqSmem + kStages * kRowsBytes;
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 80 || HD == 112 ||
                HD == 128, "head dim");
  static_assert(kDkvSmem <= 232448, "shared memory");
};

struct T32DqParams {
  CUtensorMap q_map[2], do_map[2];  // hi, lo row copies: boxes of 64 rows
  CUtensorMap k_map[2], v_map[2];   // boxes of 32 rows
  CUtensorMap kt_map[2];            // k's transposed copies
  const float* lse;                 // (B, H, Sq)
  const float* delta;               // (B, H, Sq)
  float* dq;
  long long dq_strides[3];
  int sq, sk, heads, group, batch, n_q_tiles;
  int causal;
  float scale, scale_log2;
};

struct T32DkvParams {
  CUtensorMap k_map[2], v_map[2];   // boxes of 64 rows
  CUtensorMap q_map[2], do_map[2];  // boxes of 32 rows
  CUtensorMap qt_map[2], dot_map[2];  // q's and do's transposed copies
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  long long dk_strides[3];
  long long dv_strides[3];
  int sq, sk, heads, group, batch, kv_heads;
  int causal;
  float scale, scale_log2;
};

// The `Boxes` 32-column boxes of hi and lo row tiles of `rows` rows
// (parts `part_bytes` apart) into dst.
template <int Boxes>
__device__ __forceinline__ void tma_split_rows(unsigned char* dst,
                                               const CUtensorMap* maps,
                                               uint64_t* bar, int rows,
                                               int part_bytes, int row,
                                               int head, int batch) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int x = 0; x < Boxes; ++x) {
      tma_load(dst + part * part_bytes + x * rows * 128, &maps[part], bar,
               32 * x, row, head, batch);
    }
  }
}

// Store a warpgroup's 64 x HD float32 accumulator as rows row0 (and
// row0 + 8) of x, those below `rows` only.
template <int HD>
__device__ __forceinline__ void store_acc_f32(float* x, long long row_stride,
                                              const float (&acc)[HD / 2],
                                              int row0, int rows, int t) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 4) {
    const int d = 8 * (i / 4) + 2 * t;
    if (row0 < rows) {
      *reinterpret_cast<float2*>(
          x + static_cast<long long>(row0) * row_stride + d) =
          make_float2(acc[i], acc[i + 1]);
    }
    if (row0 + 8 < rows) {
      *reinterpret_cast<float2*>(
          x + static_cast<long long>(row0 + 8) * row_stride + d) =
          make_float2(acc[i + 2], acc[i + 3]);
    }
  }
}

// dq: a CTA per (64-row query tile, head, batch), the heaviest (last,
// when causal) first. Q and dO are loaded once; K, V and K^T tiles of 32
// keys stream up to the diagonal. S = Q K^T and dP = dO V^T from shared
// memory, dS = P (dP - delta) scale in registers, dQ += dS K with K^T
// from its transposed copy; every product 3xTF32.
template <int HD>
__global__ void __launch_bounds__(kT32Threads, 1)
flash_bwd_dq_tf32_sm90_kernel(const __grid_constant__ T32DqParams p) {
  using T = BwdT32<HD>;
  constexpr int kSt = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem;                             // hi, lo
  unsigned char* sdO = sQ + 2 * T::kRows64;             // hi, lo
  unsigned char* sKV = sdO + 2 * T::kRows64;            // [stage] K, V
  unsigned char* sKt = sKV + kSt * 4 * T::kRows32;      // [stage] hi, lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKt + kSt * 2 * T::kCols32);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;                         // [stage]
  uint64_t* kv_empty = kv_full + kSt;                   // [stage]
  uint64_t* kt_full = kv_empty + kSt;                   // [stage]
  uint64_t* kt_empty = kt_full + kSt;                   // [stage]

  const int bh = p.heads * p.batch;
  const int qt = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % p.heads;
  const int b = static_cast<int>(blockIdx.x) % bh / p.heads;
  const int q0 = qt * 64;
  int n_tiles = (p.sk + 31) / 32;
  if (p.causal) n_tiles = min(n_tiles, (q0 + 63) / 32 + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kt_full[s], 1);
      mbar_init(&kv_empty[s], 4);     // one arrival per consumer warp
      mbar_init(&kt_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      const int kvh = h / p.group;
      mbar_arrive_expect_tx(q_full, 4 * T::kRows64);
      tma_split_rows<T::kBoxes>(sQ, p.q_map, q_full, 64, T::kRows64, q0, h,
                                b);
      tma_split_rows<T::kBoxes>(sdO, p.do_map, q_full, 64, T::kRows64, q0,
                                h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kSt;
        const uint32_t reuse = (j / kSt - 1) & 1;
        unsigned char* kv = sKV + s * 4 * T::kRows32;
        if (j >= kSt) mbar_wait(&kv_empty[s], reuse);
        mbar_arrive_expect_tx(&kv_full[s], 4 * T::kRows32);
        tma_split_rows<T::kBoxes>(kv, p.k_map, &kv_full[s], 32, T::kRows32,
                                  32 * j, kvh, b);
        tma_split_rows<T::kBoxes>(kv + 2 * T::kRows32, p.v_map, &kv_full[s],
                                  32, T::kRows32, 32 * j, kvh, b);
        if (j >= kSt) mbar_wait(&kt_empty[s], reuse);
        mbar_arrive_expect_tx(&kt_full[s], 2 * T::kCols32);
        for (int part = 0; part < 2; ++part) {
          tma_load(sKt + (2 * s + part) * T::kCols32, &p.kt_map[part],
                   &kt_full[s], 32 * j, 0, kvh, b);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 16 * warp + g;              // and row0 + 8
    const long long row_base =
        (static_cast<long long>(b) * p.heads + h) * p.sq;
    const float l0 = row0 < p.sq ? p.lse[row_base + row0] * kLog2e : 0.f;
    const float l1 =
        row0 + 8 < p.sq ? p.lse[row_base + row0 + 8] * kLog2e : 0.f;
    const float d0 = row0 < p.sq ? p.delta[row_base + row0] : 0.f;
    const float d1 = row0 + 8 < p.sq ? p.delta[row_base + row0 + 8] : 0.f;
    const uint64_t q_hi = desc_k(sQ), q_lo = desc_k(sQ + T::kRows64);
    const uint64_t do_hi = desc_k(sdO), do_lo = desc_k(sdO + T::kRows64);
    const float c = p.scale_log2;

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kSt;
      const uint32_t parity = (j / kSt) & 1;
      const int k0 = j * 32;
      const unsigned char* kv = sKV + s * 4 * T::kRows32;
      const unsigned char* kt = sKt + 2 * s * T::kCols32;
      float sc[16], dp[16];
      mbar_wait(&kv_full[s], parity);
      wgmma_fence();
      ss3_product<HD, 32>(sc, opaque(q_hi), opaque(q_lo), 64, desc_k(kv),
                          desc_k(kv + T::kRows32));
      ss3_product<HD, 32>(dp, opaque(do_hi), opaque(do_lo), 64,
                          desc_k(kv + 2 * T::kRows32),
                          desc_k(kv + 3 * T::kRows32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);

      // ds = p (dp - delta) scale with p = 2^(s c - lse log2 e), 0 where
      // masked, in place of s
      const bool mask = k0 + 32 > p.sk || (p.causal && k0 + 31 > q0);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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
      acc_to_tf32_frags(sc, hi, lo);
      // dQ += dS K: K^T read K-major from its transposed copy, the tile's
      // product added in float32 (rs3_product)
      float part[HD / 2];
      mbar_wait(&kt_full[s], parity);
      wgmma_fence();
      rs3_product<HD, 32>(part, hi, lo, desc_k(kt),
                          desc_k(kt + T::kCols32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kt_empty[s]);
      add_into(dq, part);
    }
    store_acc_f32<HD>(p.dq + b * p.dq_strides[0] + h * p.dq_strides[2],
                      p.dq_strides[1], dq, row0, p.sq, t);
  }
}

// dk / dv: a CTA per (64-key tile, key/value head, batch), the heaviest
// (first, when causal) first. K and V are loaded once; the tiles of 32
// query rows of every head in the GQA group, from the diagonal on, stream
// twice: the first pass accumulates dV += P^T dO (S^T = K Q^T, p^T; dO^T
// from its transposed copy), the second dK += dS^T Q (S^T and dP^T = V
// dO^T again, ds^T; Q^T from its transposed copy). The group's sum stays
// in registers: no atomics, and the result is deterministic.
template <int HD>
__global__ void __launch_bounds__(kT32Threads, 1)
flash_bwd_dkv_tf32_sm90_kernel(const __grid_constant__ T32DkvParams p) {
  using T = BwdT32<HD>;
  constexpr int kSt = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem;                             // hi, lo
  unsigned char* sV = sK + 2 * T::kRows64;              // hi, lo
  unsigned char* sQ = sV + 2 * T::kRows64;              // [stage] Q, dO, T
  float* sL = reinterpret_cast<float*>(sQ + kSt * T::kStage);  // [stage][32]
  float* sD = sL + kSt * 32;                            // [stage][32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + kSt * 32);
  uint64_t* kv_full = bars;
  uint64_t* ab_full = bars + 1;                         // [stage]
  uint64_t* ab_empty = ab_full + kSt;                   // [stage]
  uint64_t* c_full = ab_empty + kSt;                    // [stage]
  uint64_t* c_empty = c_full + kSt;                     // [stage]

  const int bkv = p.kv_heads * p.batch;
  const int k0 = static_cast<int>(blockIdx.x) / bkv * 64;
  const int kvh = static_cast<int>(blockIdx.x) % bkv % p.kv_heads;
  const int b = static_cast<int>(blockIdx.x) % bkv / p.kv_heads;
  const int n_q = (p.sq + 31) / 32;
  const int first = p.causal ? min(k0 / 32, n_q) : 0;
  const int per_head = n_q - first;
  const int n_iter = p.group * per_head;                // tiles a pass

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&ab_full[s], 32);     // the producer warp's lanes
      mbar_init(&c_full[s], 1);
      mbar_init(&ab_empty[s], 4);     // one arrival per consumer warp
      mbar_init(&c_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // one warp: TMA, lse and delta rows
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 4 * T::kRows64);
      tma_split_rows<T::kBoxes>(sK, p.k_map, kv_full, 64, T::kRows64, k0,
                                kvh, b);
      tma_split_rows<T::kBoxes>(sV, p.v_map, kv_full, 64, T::kRows64, k0,
                                kvh, b);
    }
    for (int i = 0; i < 2 * n_iter; ++i) {
      const int pass = i < n_iter ? 0 : 1;
      const int j = i - pass * n_iter;
      const int h = kvh * p.group + j / per_head;
      const int q0 = (first + j % per_head) * 32;
      const int s = i % kSt;
      const uint32_t reuse = (i / kSt - 1) & 1;
      unsigned char* stage = sQ + s * T::kStage;
      if (i >= kSt) mbar_wait(&ab_empty[s], reuse);
      const long long row_base =
          (static_cast<long long>(b) * p.heads + h) * p.sq;
      const int qpos = q0 + lane;
      // rows past the end: lse = +inf, so p = 0
      sL[s * 32 + lane] = qpos < p.sq ? p.lse[row_base + qpos] * kLog2e
                                      : __int_as_float(0x7f800000);
      sD[s * 32 + lane] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
      if (lane == 0) {
        mbar_arrive_expect_tx(&ab_full[s], (2 + 2 * pass) * T::kRows32);
        tma_split_rows<T::kBoxes>(stage, p.q_map, &ab_full[s], 32,
                                  T::kRows32, q0, h, b);
        if (pass == 1) {
          tma_split_rows<T::kBoxes>(stage + 2 * T::kRows32, p.do_map,
                                    &ab_full[s], 32, T::kRows32, q0, h, b);
        }
        if (i >= kSt) mbar_wait(&c_empty[s], reuse);
        mbar_arrive_expect_tx(&c_full[s], 2 * T::kCols32);
        const CUtensorMap* maps = pass == 0 ? p.dot_map : p.qt_map;
        for (int part = 0; part < 2; ++part) {
          tma_load(stage + 4 * T::kRows32 + part * T::kCols32, &maps[part],
                   &c_full[s], q0, 0, h, b);
        }
      } else {
        mbar_arrive(&ab_full[s]);
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + 16 * warp + g;              // and key0 + 8
    const uint64_t k_hi = desc_k(sK), k_lo = desc_k(sK + T::kRows64);
    const uint64_t v_hi = desc_k(sV), v_lo = desc_k(sV + T::kRows64);
    const float c = p.scale_log2;

    mbar_wait(kv_full, 0);
    // unrolled, so that each pass is compiled on its own: dP^T exists in
    // the second only
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {            // 0: dV, 1: dK
      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      for (int j = 0; j < n_iter; ++j) {
        const int i = pass * n_iter + j;              // position in the ring
        const int s = i % kSt;
        const uint32_t parity = (i / kSt) & 1;
        const int q0 = (first + j % per_head) * 32;
        const unsigned char* stage = sQ + s * T::kStage;
        const float* lrow = sL + s * 32;
        const float* drow = sD + s * 32;
        float st[16], dpt[16];
        mbar_wait(&ab_full[s], parity);
        wgmma_fence();
        ss3_product<HD, 32>(st, opaque(k_hi), opaque(k_lo), 64,
                            desc_k(stage), desc_k(stage + T::kRows32));
        if (pass == 1) {
          ss3_product<HD, 32>(dpt, opaque(v_hi), opaque(v_lo), 64,
                              desc_k(stage + 2 * T::kRows32),
                              desc_k(stage + 3 * T::kRows32));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        if (pass == 1) fence_regs(dpt);
        // p^T = 2^(s^T c - lse log2 e), 0 above the diagonal; in the
        // second pass ds^T = p^T (dp^T - delta) scale, in place
        const bool mask = p.causal && q0 < k0 + 63;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int col = 8 * (x / 4) + 2 * t + (x & 1);
          const int key = key0 + ((x & 2) ? 8 : 0);
          float pr = exp2f(fmaf(st[x], c, -lrow[col]));
          if (mask && key > q0 + col) pr = 0.f;
          st[x] = pass == 0 ? pr : pr * (dpt[x] - drow[col]) * p.scale;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&ab_empty[s]);
        uint32_t hi[16], lo[16];
        acc_to_tf32_frags(st, hi, lo);
        // acc += P^T dO (pass 0) or dS^T Q (pass 1), the transposed copy
        // read K-major, the tile's product added in float32 (rs3_product)
        const unsigned char* tt = stage + 4 * T::kRows32;
        float part[HD / 2];
        mbar_wait(&c_full[s], parity);
        wgmma_fence();
        rs3_product<HD, 32>(part, hi, lo, desc_k(tt),
                            desc_k(tt + T::kCols32));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        __syncwarp();
        if (lane == 0) mbar_arrive(&c_empty[s]);
        add_into(acc, part);
      }
      float* out = pass == 0 ? p.dv : p.dk;
      const long long* strides = pass == 0 ? p.dv_strides : p.dk_strides;
      store_acc_f32<HD>(out + b * strides[0] + kvh * strides[2], strides[1],
                        acc, key0, p.sk, t);
    }
  }
}

// The float32 workspace's floats: the row copies of q, k, v and do (hi,
// lo) and the transposed copies of q, k and do.
long long tf32_bwd_floats(int batch, int sq, int sk, int heads, int kv_heads,
                          int hd) {
  return 2 * (rows_floats(batch, sq, heads, hd) +
              cols_floats(batch, sq, heads, hd) +
              rows_floats(batch, sk, kv_heads, hd)) +
         cols_floats(batch, sk, kv_heads, hd);
}

// The float32 launch: the pre-pass writes the split copies into `ws`,
// then a tensor map per copy and tile height, the dq kernel and the dk /
// dv kernel on `stream`. A refused map or launch returns its error;
// nothing retries on another kernel.
template <int HD>
cudaError_t launch_bwd_tf32(const BwdParams& p, int batch, int kv_heads,
                            float* ws, cudaStream_t stream) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  const long long qr = rows_floats(batch, p.sq, p.heads, HD);
  const long long qc = cols_floats(batch, p.sq, p.heads, HD);
  const long long kr = rows_floats(batch, p.sk, kv_heads, HD);
  const long long kc = cols_floats(batch, p.sk, kv_heads, HD);
  float* q_rows = ws;
  float* q_cols = q_rows + qr;
  float* k_rows = q_cols + qc;
  float* k_cols = k_rows + kr;
  float* v_rows = k_cols + kc;
  float* do_rows = v_rows + kr;
  float* do_cols = do_rows + qr;
  Split split(batch, HD);
  split.add(p.q, p.q_strides, p.sq, p.heads, q_rows, q_cols);
  split.add(p.k, p.k_strides, p.sk, kv_heads, k_rows, k_cols);
  split.add(p.v, p.v_strides, p.sk, kv_heads, v_rows, nullptr);
  split.add(p.dout, p.do_strides, p.sq, p.heads, do_rows, do_cols);
  cudaError_t err = split.launch(stream);
  if (err != cudaSuccess) return err;
  T32DqParams dq;
  T32DkvParams dkv;
  bool mapped = true;
  for (int part = 0; part < 2; ++part) {
    const long long r = part * qr / 2, c = part * qc / 2;
    const long long r2 = part * kr / 2, c2 = part * kc / 2;
    mapped = mapped &&
             make_rows_map(&dq.q_map[part], q_rows + r, batch, p.sq,
                           p.heads, HD, 64) &&
             make_rows_map(&dq.do_map[part], do_rows + r, batch, p.sq,
                           p.heads, HD, 64) &&
             make_rows_map(&dq.k_map[part], k_rows + r2, batch, p.sk,
                           kv_heads, HD, 32) &&
             make_rows_map(&dq.v_map[part], v_rows + r2, batch, p.sk,
                           kv_heads, HD, 32) &&
             make_cols_map(&dq.kt_map[part], k_cols + c2, batch,
                           seq8(p.sk), kv_heads, HD) &&
             make_rows_map(&dkv.k_map[part], k_rows + r2, batch, p.sk,
                           kv_heads, HD, 64) &&
             make_rows_map(&dkv.v_map[part], v_rows + r2, batch, p.sk,
                           kv_heads, HD, 64) &&
             make_rows_map(&dkv.q_map[part], q_rows + r, batch, p.sq,
                           p.heads, HD, 32) &&
             make_rows_map(&dkv.do_map[part], do_rows + r, batch, p.sq,
                           p.heads, HD, 32) &&
             make_cols_map(&dkv.qt_map[part], q_cols + c, batch,
                           seq8(p.sq), p.heads, HD) &&
             make_cols_map(&dkv.dot_map[part], do_cols + c, batch,
                           seq8(p.sq), p.heads, HD);
  }
  if (!mapped) return cudaErrorInvalidValue;
  const float scale_log2 = p.scale * kLog2e;
  dq.lse = dkv.lse = p.lse;
  dq.delta = dkv.delta = p.delta;
  dq.dq = static_cast<float*>(p.dq);
  dkv.dk = static_cast<float*>(p.dk);
  dkv.dv = static_cast<float*>(p.dv);
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
  dq.n_q_tiles = (p.sq + 63) / 64;
  dkv.kv_heads = kv_heads;
  const long long dq_blocks =
      static_cast<long long>(dq.n_q_tiles) * p.heads * batch;
  const long long dkv_blocks =
      static_cast<long long>((p.sk + 63) / 64) * kv_heads * batch;
  err = launch_sm90(flash_bwd_dq_tf32_sm90_kernel<HD>, BwdT32<HD>::kDqSmem,
                    dq_blocks, dq, stream, kT32Threads);
  if (err != cudaSuccess) return err;
  return launch_sm90(flash_bwd_dkv_tf32_sm90_kernel<HD>,
                     BwdT32<HD>::kDkvSmem, dkv_blocks, dkv, stream,
                     kT32Threads);
}

template <int HD>
cudaError_t launch_hd(int dtype, const BwdParams& p, int batch,
                      int kv_heads, bool split, float* ws,
                      cudaStream_t stream) {
  if (dtype == 0) {
    return launch_bwd_tf32<HD>(p, batch, kv_heads, ws, stream);
  }
  return launch_bwd_sm90<HD>(p, batch, kv_heads, split, stream);
}

}  // namespace

// The bytes of workspace flash_attention_bwd_launch needs: float32's split
// copies of q, k, v and dout; 0 for bfloat16.
extern "C" long long flash_attention_bwd_workspace(int batch, int sq, int sk,
                                                   int heads, int kv_heads,
                                                   int head_dim, int dtype) {
  return dtype == 0 ? 4 * tf32_bwd_floats(batch, sq, sk, heads, kv_heads,
                                          head_dim)
                    : 0;
}

// q: (B, Sq, H, hd), k / v: (B, Sk, KV, hd), dout: (B, Sq, H, hd), dq:
// (B, Sq, H, hd), dk / dv: (B, Sk, KV, hd), each given by its base pointer
// and (batch, sequence, head) strides in elements, hd contiguous; lse and
// delta: contiguous (B, H, Sq) float32. dtype: 0 float32, 1 bfloat16 (every
// tensor but lse and delta alike). For bfloat16 every pointer must be
// 16-byte aligned and every stride of q, k, v and dout a multiple of 8
// elements (dq / dk / dv: of 2). split: bf16 at head dim 128 only, 1 to
// enter p and ds as hi + lo bf16 parts (what the port runs), 0 to round
// each once (to measure what the split costs); the other kernels always
// split. workspace: float32 only, flash_attention_bwd_workspace's bytes,
// 16-byte aligned. Launches the dq kernel, then the dk / dv kernel, on
// `stream`. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides,
    const long long* dq_strides, const long long* dk_strides,
    const long long* dv_strides, int batch, int sq, int sk, int heads,
    int kv_heads, int head_dim, int causal, float scale, int dtype,
    int split, void* workspace, void* stream) {
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
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_hd<16>(dtype, p, batch, kv, sp, ws, s); break;
    case 32: err = launch_hd<32>(dtype, p, batch, kv, sp, ws, s); break;
    case 64: err = launch_hd<64>(dtype, p, batch, kv, sp, ws, s); break;
    case 80: err = launch_hd<80>(dtype, p, batch, kv, sp, ws, s); break;
    case 112: err = launch_hd<112>(dtype, p, batch, kv, sp, ws, s); break;
    case 128: err = launch_hd<128>(dtype, p, batch, kv, sp, ws, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
