#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out DIR]      # from the root of a checkout

Phases; the first failure exits non-zero:

1. build   — ``nvcc`` every kernel under ``src/repro_torch/csrc/`` into
   ``build/``, all at once; print each build's time and the ``-Xptxas -v``
   register / shared-memory report.
2. kernels — each kernel against its plain PyTorch version on the card, bit
   for bit: the VM on tables lowered from the §8 templates (weekly OR
   tree, ``sum(col + col2)``, range scan, ``col < K & male``) at batch 1
   and 16, a word count that is not a multiple of the column block,
   popcount with a shared and with per-batch masks, materialize, fault
   masks (add8 also at batch 16); random fused programs at word counts of
   1 and 3 mod 4, with plane, masks and fault masks one word into their
   storage (not 16-byte aligned), one slice narrower than a tile, 65,535
   slices, and a 1,009-row program that forces the narrowest block; the
   bit transpose on 2**24 values, at 1, 8, 13 and 32 planes, group counts
   that are not a multiple of 32 and a base one word into its storage; the
   nine bitwise ops flat (ragged, aligned and misaligned word runs) and
   banked (1, 3 and 8 banks over a ragged width); popcount at ragged,
   misaligned and all-ones inputs; the BitWeaving scan at 1, 7, 12 and 32
   bits with extra planes, ``lo > hi`` and ``hi >= 2**n_bits``; the
   majority at k in {1, 2, 3, 4, 5, 7, 15, 31} with the default, custom
   and edge (0, k + 1) thresholds over a ragged word count; bit-serial add,
   sub and lt at 1, 7, 8 and 32 bits, one and three rows of a ragged
   width; the bit untranspose with fewer than 32 planes, ragged group
   counts and a round trip through the bit transpose; ptxas's registers
   and spill bytes of the Hopper flash kernels (the bf16 forward's
   instances at head dims 64, 80, 112 and 128, the bf16 backward's and
   the float32 3xTF32 forward's and backward's at every head dim, and
   their pre-pass, each required; the first designs' instances that they
   replaced must be gone: bf16 ``mma.sync`` at 64-112 forward and every
   head dim backward, float32 scalar FMAs), the VM and the bit transpose
   (any spill fails); flash attention in float32 and
   bf16 at the JAX package's five test shapes, a cross-attention shape (64
   queries over 100 keys), B = 2,
   S = 1,000 causal at hd 128, and the hd-128 kernels' edges (100 queries
   over 1,000 keys without the mask, GQA groups of 1 and 8, S = 130 and
   1,000, B H = 144), each within the JAX package's own tolerance (2e-3
   float32, 2e-2 bf16) of its plain version, relative to each element and
   to the plain output's RMS, and the MoE configs' heads: Llama-4
   Maverick's 40 query heads over 8 (a group of 5) at S = 2,048 and Kimi
   K2's 64 over 8 at head dim 112; the serving families' shapes, also
   through the lse forward: Zamba2's head dim 80 (32 heads over 32,
   1,000 queries, causal and not), SeamlessM4T's non-causal head dim 64
   at 2,048 queries over 1,024 keys and 1,024 over 1,024, the VLM's
   cross-attention on the hd-128 Hopper kernel (2,048 queries over 1,600
   keys, 64 heads over 8), and the Hopper route's edges at head dims 64
   and 80 (100 keys, under one key tile, and 1,000; 130 and 300
   queries; GQA groups of 2; B H = 144 and 160; at head dim 112 100 keys
   under 130 queries at Kimi K2's group of 8, and 300 queries over 1,000
   keys at B H = 144); the training kernels at
   the same shapes and
   at B = 1, S = 4,096 causal, and the trained families' shapes (Zamba2's
   head dim 80: 32 heads over 32 at 1,000 queries causal and not, a GQA
   group of 2, 100 keys, B H = 160; SeamlessM4T's head dim 64 at B 2:
   1,024 x 1,024, causal 4,096 and 4,096 x 1,024; the VLM's cross
   attention, 4,096 x 1,600 at 64 / 8 heads of 128; the Hopper
   backward's edges at head dims 64 and 112: 100 keys, 130 and 300
   queries, GQA groups of 2 and 8, B H = 144 and 160, and at 112 Sq !=
   Sk causal both ways and not), both dtypes: the
   lse-emitting forward (its
   output equal to the serving kernel's, the lse within 1e-4) and the
   backward (dq, dk, dv; two runs bit-identical) against their plain
   versions within the same tolerance, the largest share of the
   tolerance printed per dtype; sign
   pack / unpack bit for bit in float32 and bf16, with +-0, +-inf and NaNs
   of either sign, on a ragged (3, 32,032) and a 2**26-lane input;
   ``moe_ffn`` in float32 at reduced widths (d_model 1,024, 16 experts,
   top-2, 2,048 tokens at a capacity that drops some) against the same
   call on the CPU: the same routing, the output within 1e-4 of its
   largest magnitude, the aux loss within 1e-5. The flash launches that
   no main path makes (float32 at head dims other than 128, and bf16 at
   16 and 32) are timed there too, the serving forward and the backward,
   beside their bound (float32: three TF32 products over the TF32 peak,
   and beside it the FP32-FMA figure) and
   ``scaled_dot_product_attention`` (its backward alone), and their
   totals by dtype and head dim printed ("off the main path").
3. slice   — (a) serve the §8 multi-tenant workload at full width (2**24-bit
   vectors) through ``build_service -> query_stream -> query_batch``, plus
   a batch of materialize queries. Every result must equal the unbatched
   micro-op interpreter (no VM, no kernel) on the card, and sum(col) and a
   weekly-OR count must equal numpy on the raw seeded data.
   (b) the paper's direct bulk-bitwise path at its sizes, data drawn on
   the card from a seeded `torch.Generator`: Fig. 9's nine ops through
   ``repro_torch.ops`` on 32 MiB operands at 1 and 8 banks, each output
   counted with ``kernels.ops.popcount``; §8.1's weekly-active query over
   2**24 users and 4 weeks, also through the query service; §8.2's scan
   over 2**25 - 7 values at 12 and 32 bits; §8.3's union, intersection
   and difference of 15 sets of 1,024 elements over 2**19 at 1 and 8
   banks and through the service; ``engine.execute(n_banks=8)`` against
   one bank. Every result must equal numpy on the raw data.
   (c) the §8 stream of (a), on (a)'s catalog vectors, under TRA
   reliability with seeded faults injected in the VM: ``mode="vote"``
   (k = 3) and ``mode="ecc"`` at a flip rate P chosen so that the
   expected number of output bits wrong in two replicas at once is below
   1e-3 (reckoned from the model's flip probabilities and the batches'
   plan groups, and printed), and ``mode="ecc"`` at rate 0. Every result
   must equal (a)'s bit for bit; faults must have landed (corrected bits
   > 0, one injected group alone differs from the clean run), ECC at P
   must break ties and ECC at 0 must not, every batch must run the parity
   probe, and a corrupted catalog word must make the ECC service raise.
   (d) bit-serial arithmetic on two columns of 2**25 - 7 values at 8 and
   32 bits: ``to_vertical``, ``add_columns``, ``sub_columns``,
   ``lt_columns``, ``lt_const``, ``sum_column`` and ``from_vertical`` of
   the sums and differences, each against numpy on the raw values, and
   at 8 bits the five in-DRAM twins at 1 and 8 banks against the fast
   path. (e) LM serving at Qwen3-0.6B's published widths and depth (28
   layers, d_model 1024, 16 / 8 heads of 128, vocab 153,600 padded) in
   bf16, weights from a seeded `torch.Generator` on the card: ``generate``
   on 8 prompts of 2,048 seeded ids, greedy, 32 new tokens; it must launch
   the flash kernel once per prefill layer. Checks: (i) the main path's
   prefill logits against the same prefill with the plain attention
   swapped in, (ii) prefill(S) + ``decode_step`` against prefill(S + 1),
   both within 0.05 of the largest logit, (iii) ids of shape (8, 32) in
   ``[0, padded_vocab)`` and every logit finite; it prints the cold
   generate's prefill wall and ms per decode step, tok/s and peak memory,
   then the warm generate's and each part's device time by kind
   (``torch.profiler``). (f) training at Qwen3-0.6B's published widths
   and depth in bf16 through ``build -> init -> make_train_step``: AdamW
   with ``warmup_cosine``, ``remat="block"``, the port's `SyntheticLM`,
   sequence 4,096 (train_4k's), global batch 8 in four microbatches of 2
   (the batch cut from train_4k's 256 for time; the microbatch halved
   from 4, whose float32 logits and their gradients ran the card out of
   memory). Checks: (i) the first loss finite and
   within 10% of ln 153,600; (ii) one step's loss and every gradient leaf
   against the same step with the plain attention forward and backward
   swapped in (loss within 1e-3 relative, each leaf's RMS difference
   within 0.05 of its RMS); (iii) six steps on one batch lower the loss;
   (iv) ``grad_accum`` 2 and 1 on the same batch agree in loss within
   5e-3; (v) ``make_train_step_compressed`` with signum on a one-rank
   NCCL group equals the local signum step with the same gradients on
   every element whose ``u`` is not +-0 or NaN (their count printed);
   (vi) exact launch counts: a step launches the lse forward twice per
   layer and microbatch (the forward and the checkpointed recompute) and
   the backward once, the compressed step also pack, unpack and the
   majority once each. It prints the cold and warm step, tokens/s, peak
   memory, and a warm step's device time by kind with the idle share.
   (g) MoE serving at Llama-4 Maverick's published widths (d_model 5,120,
   40 / 8 heads of 128, 128 experts of d_ff 8,192, top-1, one shared,
   dense d_ff 16,384, vocab 202,048) in bf16, its depth cut from 48 layers
   to 2 (one dense, one MoE: one super-layer; 37.4 GB of weights), and
   Kimi K2's (d_model 7,168, 64 / 8 heads of 112, 384 experts of d_ff
   2,048, top-8, one shared, dense d_ff 16,384, vocab 163,840) cut from 61
   layers to 2 (its leading dense layer and one MoE layer of all 384
   experts; 39.8 GB), each through ``build -> init -> generate`` with
   3e's traffic: 2 flash launches (Kimi K2's at head dim 112); the
   prefill's dropped slots (16,384 tokens at capacity 160 / 432) must
   equal a host recount from the router's ids, every logit finite, ids
   in vocab; each prints the cold and warm prefill wall, ms per decode
   step and tok/s, peak memory, the dropped share and the experts' max /
   mean load, and the warm prefill's device ms by kind and idle share.
   (h) the paper's §3, §6.2 and §8.4 at real sizes, each against numpy on the host: Table
   1 and ``monte_carlo_tra`` at 2**20 trials (sigma 0.06 and 0.25); five
   ``bop``s over 8 KiB rows taking the Buddy and the CPU path; masked init
   over 2**23 pixels; XOR encrypt / decrypt of 2**23 words; a 16-base read
   in a 2**24-base genome, exact and within 2 mismatches; 16 Bloom filters
   of 2**20 bits x 1,000 keys merged and queried; the bitmap filter over
   2**24 documents and a 4,096-id sample.
   (i) the SSM and hybrid families at their published widths and depth:
   Mamba2-1.3B (48 layers, d_model 2,048, 64 SSM heads of 64, state 128,
   chunk 256, vocab 50,280; no kernel: its mixer is plain PyTorch, as
   the reference's is plain jnp) and Zamba2-2.7B (54 layers as 9 groups
   of 6 SSM blocks and one shared attention block, d_model 2,560, 80 SSM
   heads of 64, state 64, attention 32 heads of 80, d_ff 10,240; 9 flash
   launches at head dim 80 a prefill); (j) SeamlessM4T-medium at its
   published widths and depth (12 encoder and 12 decoder layers, d_model
   1,024, 16 heads of 64, GELU d_ff 4,096, vocab 256,206, 1,024 stub
   frames a sample; 36 flash launches a prefill: 12 encoder non-causal,
   12 decoder causal, 12 cross); (k) Llama-3.2-Vision-90B at its
   published widths (d_model 8,192, 64 / 8 heads of 128, d_ff 28,672,
   vocab 128,256, 1,600 stub patches, cross-attention every 5th layer),
   its depth cut from 100 layers to 10 (two groups of 4 self-attention
   layers and one self + cross layer; 21.9 GB of weights): 12 flash
   launches a prefill, 2 of them cross-attention over 1,600 keys. Each of
   (i)-(k) serves 3e's traffic through ``build -> init -> generate`` and
   checks: every logit finite, ids in the vocabulary, the exact flash
   launches of a prefill and nothing else, and prefill(S) +
   ``decode_step`` against prefill(S + 1) within 0.05 of the largest
   logit; it prints the cold and warm prefill wall, ms per decode step,
   generated tok/s, peak memory, the cache's bytes and the warm
   prefill's device ms by kind with the idle share.
   (l)-(n) training the SSM, hybrid, enc-dec and VLM families in bf16
   through ``build -> init -> make_train_step`` (``remat="block"``,
   ``warmup_cosine``, the port's `SyntheticLM` at train_4k's sequence of
   4,096 with its stub frames / patches; the global batch cut from
   train_4k's 256 for time): (l) Mamba2-1.3B and Zamba2-2.7B and (m)
   SeamlessM4T-medium at their published widths and depth, AdamW, global
   batch 4 in two microbatches of 2; (n) Llama-3.2-Vision-90B at its
   published widths, its depth cut from 100 layers to 5 (one group of 4
   self-attention layers and one self + cross layer, 6.6 B parameters),
   Adafactor at global batch 2 in one microbatch (AdamW's float32 moments
   would add 52.9 GB to its 26.4 GB of bf16 weights and gradients, a
   second microbatch 26.4 GB of float32 sums). Checks, as (f)'s: the
   first loss within 10% of its value at the initial weights, ln(padded
   vocab) + 0.02^2 d_model / 2 (the logits' variance at init lifts it;
   at d_model 8,192 by 14% of ln V); the first step's loss (within 1e-3)
   and every gradient leaf (within 0.05 of its RMS, or twice the plain
   attention's own spread between 256- and 512-blocks on that leaf)
   against the plain attention swapped in (not Mamba2);
   three steps on one batch lower the loss; with two microbatches
   ``grad_accum`` 2 and 1 on one microbatch agree within 5e-3; per
   microbatch exactly 2 lse forwards and 1 backward per attention
   (Zamba2 18 and 9, SeamlessM4T 72 and 36, the VLM 12 and 6, Mamba2
   none) and nothing else. Each prints the cold and warm step, tok/s,
   peak memory, a warm step's device ms by kind with its idle share, and
   for the SSD families the scan's forward and backward at one layer's
   shape. (p) training the MoE family as (n) (Adafactor, global batch 1
   of 4,096 in one microbatch): Llama-4 Maverick and Kimi K2 at their
   published widths cut to 2 layers (one dense, one MoE) and half their
   experts (64 of 128: 10.63 B parameters; 192 of 384: 11.43 B; at all
   the experts weights, gradients and Adafactor's statistics take 96.8
   and 102.7 GB), with (n)'s checks: the first loss within 10% of ln V +
   0.02^2 d_model / 2 + 0.01 aux; every gradient leaf against the plain
   attention (that set held on the host); three steps lower the loss;
   per step 4 lse forwards and 2 backwards (hd 128 / 112), and no call of
   a plain flash function; each prints (n)'s numbers, the aux loss and
   each MoE layer's dropped slots.
   (o) the §8 stream of (a) through the chip cluster on the card:
   ``ServiceConfig(n_banks=8, n_chips=1, max_chips=8)`` (64 slots of
   8,192 words a 2 MiB vector), cold, warm and materialize, each answer
   equal to (a)'s bit for bit; the same service rescaled onto C chips of
   the one card (``rescale(C, devices=["cuda:0"] * C)``, a
   `ChipCluster.create` of ``["cuda:0"] * C`` attached to the catalog)
   for C in 2, 4 and 8, every count and word equal to (a)'s and exactly
   C VM launches per plan group (no chip runs the plain VM); a
   `FaultTolerance` whose injector raises a plain ``RuntimeError`` once in
   each of two plan groups, the batch equal to (a)'s and ``failures``
   equal to the injected two; ``serve_stream`` over the stream in three
   batches into a temporary directory with one injected failure, then a
   fresh service resuming there after the last checkpoint is removed,
   both runs' values equal to (a)'s. Each wall is printed beside the
   card's name and power limit.
   (q) the mesh-free launch stack, in three parts run where their inputs
   live: (c), right after (a), builds the plane of (a)'s first plan group
   with ``lowering.make_plane`` from the catalog's rows and runs it with
   ``kernels.ops.run_megakernel``, materialized and with
   ``reduce="popcount"`` under the tail mask, both equal to
   ``execute_lowered``'s bit for bit and both VM modes launched; (a),
   after (f)'s numbers, runs (f)'s training under ``remat="dots"``
   beside "block" from (f)'s seed and weights: the loss equal to
   "block"'s and every gradient leaf bit-equal, then one cold and two
   warm steps of "dots" with their walls and peak memory and a profiled
   warm step (device time by kind, idle share), beside (f)'s; (b),
   last, counts (e)'s prefill, (f)'s step and (g)'s two prefills on
   ``meta`` (``plan_for`` -> ``build`` -> ``abstract`` -> ``input_specs``
   -> ``hlocost.count`` -> ``roofline.analyze`` at one chip) and prints
   each count, its roofline terms, dominant term, the reference's model
   FLOPs and the useful FLOPs (``roofline.useful_flops``), the useful
   ratio and roofline fraction beside the phase's measured warm wall,
   device time and share of the card's bf16 peak (useful FLOPs over the
   wall, at most 1); the counts allocate nothing on the
   card, and the flash FLOPs charged to (f)'s step equal ``flash_cost``
   over (f)'s launches.
   (s) Qwen3-0.6B at its published widths and depth in float32
   (``dataclasses.replace(cfg, dtype="float32")``), after (q)(a): (a)
   ``generate`` on 3e's traffic, 28 flash launches a prefill on the
   float32 3xTF32 kernels, its greedy ids equal to those of the same
   model with the plain attention swapped in and its prefill logits
   within 1e-4 of theirs (of the largest magnitude); (b)
   ``make_train_step`` at 3f's sequence and global batch in the fewest
   microbatches that fit (two of 4), AdamW at rate 0 for its first
   step, 56 lse forwards and 28 backwards a sequence: the first loss
   within 10% of ln V + 0.02^2 d_model / 2, the loss and every gradient
   leaf within 1e-4 (relative; of the leaf's RMS) of the same step with
   the plain attention, then two warm steps. Each prints its cold and
   warm wall, tok/s, peak memory and a profiled run's device ms by kind
   (the pre-pass beside the flash kernels) with the idle share.
   (r) the mesh, last: Qwen3-0.6B at its published widths and depth
   through ``launch.mesh.make_host_mesh`` -> ``launch.cells.build_cell``
   -> ``Cell.run`` on a (data 1, model 1) mesh of one NCCL rank (two
   gloo ranks on one card hang in DTensor's all-gather of CUDA tensors;
   NCCL takes one rank a card), one sequence of 4,096, AdamW: every
   parameter a DTensor, the first loss and every gradient leaf against
   the unsharded step on the same card, seed and batch (3f's gate), the
   flash kernels launched from the ``local_map`` branch (twice forward
   and once backward a layer), a cold and two warm steps, the rank's
   peak memory and a profiled step's collective share; the compressed
   cell on the mesh's data axis, its voted words equal to the majority
   of the ranks' packed signs computed in numpy and its parameters to
   the signum step with them; one empty launch's time; and the dry run
   (``python -m repro_torch.launch.dryrun``) of qwen3_8b and
   kimi_k2_1t_a32b x train_4k on the 16x16 fake group, started after
   the build in subprocesses beside the other phases, their counted
   FLOPs, bytes and collective bytes printed. It prints its seconds.
   Each of (a)-(s) starts with every launch count at 0 and must launch
   each of its kernels.
4. numbers — replay every kernel launch of phase 3 with the same arguments
   (of (c), every majority launch and two VM launches with fault masks:
   the largest group and the first single-query one, their masks redrawn
   from the recorded key and held to the draw's fingerprint; keeping every
   launch's masks would take tens of GiB),
   hold each to its plain version again (bit for bit, at the main path's
   shapes), time both with CUDA events, and print each kernel's total
   beside its bound (bytes over 3.35 TB/s or int32 operations over the
   card's integer rate, whichever is larger, the rates of the card's row
   of ``repro_torch.hw``; for the VM also its design's
   shared-memory floor, the decoded program's LDS + STS bytes over 128 B a
   clock per SM, and its totals split into launches with and without
   fault masks) and, for the bitwise
   launches whose op is one PyTorch call (and, or, xor, not), that call's
   time on the same operands. Of (e), every flash launch: held to its plain
   version within the phase-2 tolerance, whose reach is shown on the
   first launch (a dense recomputation passes it; with one key tile
   dropped for the last queries it must fail), timed beside the plain version
   and ``scaled_dot_product_attention`` (the yardstick; the port never
   calls it), its bound the larger of q + k + v + o over 3.35 TB/s and the
   FLOPs of the unmasked (query, key) pairs over 989 TFLOP/s (dense bf16).
   Of (f), every lse forward and backward launch of the first training
   step and the compressed step's pack and unpack (the compressed step's
   flash launches are counted, not replayed: their arguments would hold
   another 21 GiB): the flash launches within the phase-2 gate, whose
   reach the backward shows too (the plain backward at other blocks
   passes; with one 64-query tile of one head dropped it must fail);
   the forward timed beside ``scaled_dot_product_attention``, the
   backward beside that call's backward alone, its bound the larger of
   ``10 B H hd`` FLOPs per unmasked pair (five products) over 989 TFLOP/s
   and q, k, v, o, do, lse, dq, dk, dv over 3.35 TB/s, and on the first
   training launch what its hi + lo split of p and ds costs (timed with
   and without it, each one's share of the gate printed); pack and unpack
   bit for bit, bound by their bytes. Of (g) and (i)-(k), every flash
   launch as (e)'s, with each stage's totals and per-launch times by
   shape beside the bound and scaled_dot_product_attention, and the
   totals by the launcher's route (Hopper at each head dim, first
   design); of (h), every
   launch; of (l)-(n), the first microbatch's lse forward and backward
   launches as (f)'s, with per-shape and per-route lines for both
   kernels; of (p) likewise, at head dims 128 and 112; of (s) two
   launches of each kind (the serving forward, the lse forward and the
   backward of the first microbatch: each run's launches share one
   shape), their bound three TF32 products over 494.7 TFLOP/s with the
   FP32-FMA figure beside it. Phase 4 runs for (a)-(e) before (f)
   starts, for (f) before (g), for (s) before (g), for (g)-(h) before
   (i), for (i)-(k) before (l) and for each trained model before the
   next, so their recorded arguments are freed first.

Output: the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as the last line ``{"ok": true, "device": {...}}``. ``--out DIR``
also writes every launch's numbers to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: the card's peaks: its row of ``repro_torch.hw`` (device-memory rate,
#: dense bf16 and float32 FLOP/s, int32 lanes and shared-memory bytes a
#: clock per SM), set by `main` once it has found a card
CARD = None

KERNELS = {
    "vm_popcount": ("src/repro_torch/csrc/vm.cu",
                    "src/repro/kernels/vm.py:166"),
    "vm_materialize": ("src/repro_torch/csrc/vm.cu",
                       "src/repro/kernels/vm.py:166"),
    "bit_transpose": ("src/repro_torch/csrc/bittranspose.cu",
                      "src/repro/kernels/bittranspose.py:54"),
    "bitwise": ("src/repro_torch/csrc/bitwise.cu",
                "src/repro/kernels/bitwise.py:82"),
    "bitwise_banked": ("src/repro_torch/csrc/bitwise.cu",
                       "src/repro/kernels/bitwise.py:51"),
    "popcount": ("src/repro_torch/csrc/popcount.cu",
                 "src/repro/kernels/popcount.py:33"),
    "bitweaving_scan": ("src/repro_torch/csrc/bitweaving.cu",
                        "src/repro/kernels/bitweaving.py:47"),
    "majority": ("src/repro_torch/csrc/majority.cu",
                 "src/repro/kernels/majority.py:62"),
    "bitserial_add": ("src/repro_torch/csrc/arith.cu",
                      "src/repro/kernels/arith.py:83"),
    "bitserial_lt": ("src/repro_torch/csrc/arith.cu",
                     "src/repro/kernels/arith.py:94"),
    "bit_untranspose": ("src/repro_torch/csrc/bittranspose.cu",
                        "src/repro/kernels/bittranspose.py:74"),
    "flash_attention": ("src/repro_torch/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn.py:103"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flashattn.cu",
                            "src/repro/kernels/flashattn.py:242"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flashattn_bwd.cu",
                            "src/repro/kernels/flashattn.py:294"),
    "pack_signs": ("src/repro_torch/csrc/signpack.cu",
                   "src/repro/kernels/signpack.py:51"),
    "unpack_signs": ("src/repro_torch/csrc/signpack.cu",
                     "src/repro/kernels/signpack.py:75"),
}
#: the kernels each main-path run of phase 3 must launch
SERVICE_KERNELS = ("vm_popcount", "vm_materialize", "bit_transpose")
DIRECT_KERNELS = ("bitwise", "bitwise_banked", "popcount", "bitweaving_scan")
RELIABILITY_KERNELS = ("majority", "vm_materialize")
ARITH_KERNELS = ("bitserial_add", "bitserial_lt", "bit_untranspose",
                 "bit_transpose", "bitweaving_scan", "vm_materialize")
CLUSTER_KERNELS = ("vm_popcount", "vm_materialize")
LM_KERNELS = ("flash_attention",)
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
COMPRESSED_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                      "pack_signs", "unpack_signs", "majority")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build(build_mod) -> None:
    names = sorted(p.stem for p in build_mod.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = build_mod.build(names)
    print(f"[build] {len(names)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name in names:
        print(f"[build] {name}.cu: " + (f"{seconds[name]:.1f} s"
                                       if name in seconds else "cached"))
        for line in build_mod.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "bytes stack" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        build_mod.load(name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _group(svc, texts):
    """Bound plans of one plan group and its per-query operand rows,
    exactly as the scheduler hands them to `lowering.vm_call`."""
    bound = [svc.scheduler.planner.plan(t, columns=svc.catalog.columns,
                                        names=svc.catalog) for t in texts]
    keys = {bp.plan.key for bp in bound}
    check(len(keys) == 1, f"templates {texts[:2]} do not share one plan")
    rows = [bp.input_map() for bp in bound]
    data = {n: [svc.catalog.get(r[n]).words for r in rows]
            for n in rows[0]}
    return bound[0].plan, data


def _compare(label, got, want, errs) -> None:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    errs.append(err)
    check(torch.equal(got, want), f"{label}: kernel != plain "
          f"(max abs err {err})")


def phase_kernels(torch, svc, spec) -> int:
    from repro_torch.apps.bitmap_index import week_or
    from repro_torch.core import lowering
    from repro_torch.kernels import ref, vm
    from repro_torch.kernels.bittranspose import bit_transpose_kernel

    rng = np.random.default_rng(1234)
    words = svc.catalog.mask().shape[0]
    threads, per_thread = vm.block_cols(35, 800, 8)
    cols = threads * per_thread
    check(words % cols != 0, f"{words} words is a multiple of {cols}")
    templates = {
        "week_or": lambda t: week_or(0, prefix=f"{t}/"),
        "add8": lambda t: f"sum({t}/col + {t}/col2)",
        "range_scan": lambda t: svc.range_scan_query(f"{t}/col", 37, 201),
        "lt_male": lambda t: f"{t}/col < 37 & {t}/male",
    }
    errs = []
    n_cases = 0
    for name, make in templates.items():
        for batch in (1, 16):
            tenants = [f"t{i % spec.n_tenants}" for i in range(batch)]
            plan, data = _group(svc, [make(t) for t in tenants])
            outs = list(plan.outputs)
            per_batch = torch.from_numpy(
                rng.integers(0, 1 << 32, (batch, words), dtype=np.uint32)
                .view(np.int32)).to(svc.device)
            cases = [("materialize", None, None),
                     ("popcount/shared-mask", "popcount", svc.catalog.mask()),
                     ("popcount/per-batch-mask", "popcount", per_batch)]
            for case, reduce, mask in cases:
                call = lowering.vm_call(plan.lowered, data, outputs=outs,
                                        mask=mask)
                got = call.run(vm.vm_megakernel, reduce)
                want = call.run(vm.vm_plain, reduce)
                _compare(f"vm {name} B={batch} {case}", got, want, errs)
                n_cases += 1
        # fault masks: the four TRA classes per command, per batch slice
        for batch in (2, 16) if name == "add8" else (2,):
            tenants = [f"t{i % spec.n_tenants}" for i in range(batch)]
            plan, data = _group(svc, [make(t) for t in tenants])
            n_cmds = plan.lowered.n_cmds
            e = (rng.integers(0, 1 << 32, (n_cmds, 4, batch, words),
                              dtype=np.uint32)
                 & rng.integers(0, 1 << 32, (n_cmds, 4, batch, words),
                                dtype=np.uint32))
            for reduce in (None, "popcount"):
                call = lowering.vm_call(
                    plan.lowered, data, outputs=list(plan.outputs),
                    errors=e,
                    mask=None if reduce is None else svc.catalog.mask())
                _compare(f"vm {name} B={batch} errors reduce={reduce}",
                         call.run(vm.vm_megakernel, reduce),
                         call.run(vm.vm_plain, reduce), errs)
                n_cases += 1
    n_cases += _vm_edge_cases(torch, svc.device, errs)
    # the transpose: every plane count the main paths ask for and the
    # extremes, group counts that leave a ragged last warp, and a base at
    # an odd word offset (a slice one word into its storage)
    for n, n_bits, offset in ((1 << 24, 8, 0), (1 << 24, 32, 0),
                              (32 * 1001, 8, 0), (32 * 1001, 13, 0),
                              (32 * 1001, 1, 0), (32 * 1001, 32, 0),
                              (32, 13, 0), (32 * 33, 32, 0),
                              (32 * 1001, 13, 1), (32 * 70, 1, 1)):
        store = torch.from_numpy(rng.integers(0, 1 << n_bits, n + offset,
                                              dtype=np.uint32)
                                 .view(np.int32)).to(svc.device)
        values = store[offset:]
        _compare(f"bit_transpose n={n} n_bits={n_bits} offset={offset}",
                 bit_transpose_kernel(values, n_bits),
                 ref.bit_transpose(values, n_bits), errs)
        n_cases += 1
    n_cases += _direct_kernel_cases(torch, svc.device, errs)
    n_cases += _vote_arith_kernel_cases(torch, svc.device, errs)
    torch.cuda.synchronize()
    print(f"[kernels] {n_cases} cases bit-identical to the plain versions "
          f"({words} words per row, {cols}-column blocks)")
    return max(errs)


def _random_lowered(seed: int):
    """A lowered random boolean program over D0..D5 (and, or, xor, not,
    maj3), fused as the planner fuses."""
    from repro_torch.core import compiler as tcomp
    from repro_torch.core import lowering

    r = np.random.default_rng(seed)
    leaves = [tcomp.Expr.of(f"D{i}") for i in range(6)]
    e = leaves[0]
    for _ in range(10):
        a = leaves[int(r.integers(6))]
        op = ("and", "or", "xor", "not", "maj3")[int(r.integers(5))]
        e = (~e if op == "not" else
             tcomp.maj(e, a, leaves[int(r.integers(6))]) if op == "maj3"
             else tcomp.Expr(op, (e, a)))
    return lowering.lower(tcomp.compile_expr_fused(e, "OUT").program)


def _misaligned(torch, t):
    """A contiguous copy of ``t`` one word into its storage, so its data
    pointer is 4 but not 16-byte aligned."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = store[1:].view(t.shape)
    out.copy_(t)
    return out


def _vm_edge_cases(torch, device, errs) -> int:
    """The VM at the shapes its tiles and block choice must take, each in
    both modes, with a shared and a per-batch mask and with fault masks:
    word counts of 1 and 3 mod 4, plane / masks / fault masks at an odd
    word offset, one batch slice narrower than a tile, 65,535 slices, and
    a 1,009-row program whose shared rows force the narrowest block (one
    word a thread, 32 threads) with and without fault masks."""
    from repro_torch.core import lowering
    from repro_torch.kernels import vm

    rng = np.random.default_rng(77)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, shape,
                                             dtype=np.uint32)
                                .view(np.int32)).to(device)

    cases = []
    for label, batch, width, odd in (("W%4=1", 3, 1001, False),
                                     ("W%4=3", 3, 1003, False),
                                     ("misaligned", 2, 1000, True),
                                     ("B=1 W<tile", 1, 100, False),
                                     ("B=65535", 65535, 3, False)):
        lp = _random_lowered(len(cases))
        call = lowering.vm_call(lp, {f"D{i}": words(batch, width)
                                     for i in range(6)}, outputs=["OUT"])
        plane = _misaligned(torch, call.plane) if odd else call.plane
        cases.append((label, call.lay.table, plane, call.lay.out_idx,
                      call.lay.n_rows, call.first_row, odd))
    # a chain of TRAs over 1,000 seeded rows, every row an output, so
    # every row holds a shared slot
    n = 1000
    rows = 9 + np.arange(n)
    table = np.stack([np.ones(n), rows, np.roll(rows, -1), np.roll(rows, -2),
                      rows << 16], 1).astype(np.int32)
    cases.append(("narrowest block", table, words(1, n, 1001),
                  tuple(rows.tolist()), 9 + n, 9, False))
    n_cases = 0
    for label, table, plane, out_idx, n_rows, first_row, odd in cases:
        batch, _, width = plane.shape
        shared, per_batch = words(1, width), words(batch, width)
        errors = words(batch, 4 * table.shape[0], width) \
            & words(batch, 4 * table.shape[0], width)
        if odd:
            shared, per_batch, errors = (_misaligned(torch, t) for t in
                                         (shared, per_batch, errors))
        if label == "narrowest block":
            for faulty in (False, True):
                prog = vm.program(table, out_idx, n_rows, first_row,
                                  plane.shape[1], faulty, False, device)
                check((prog.threads, prog.words) == (32, 1),
                      f"vm {label}: block shape {prog.threads} x "
                      f"{prog.words}, not the narrowest")
        for reduce, mask, err in ((None, None, None), (None, None, errors),
                                  ("popcount", shared, None),
                                  ("popcount", per_batch, None),
                                  ("popcount", shared, errors)):
            kw = dict(n_rows=n_rows, first_row=first_row, errors=err,
                      reduce=reduce, mask=mask)
            _compare(f"vm {label} B={batch} W={width} reduce={reduce} "
                     f"mask={None if mask is None else mask.shape[0]} "
                     f"errors={err is not None}",
                     vm.vm_megakernel(table, plane, out_idx, **kw),
                     vm.vm_plain(table, plane, out_idx, **kw), errs)
            n_cases += 1
    return n_cases


def _draw_words(torch, gen, *shape):
    """Uniform 32-bit words (int32 bit patterns) drawn on the card."""
    x = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=gen,
                      device=gen.device)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _direct_kernel_cases(torch, device, errs) -> int:
    """The direct path's kernels against their plain versions at ragged
    sizes: word runs that are not a multiple of 4 (word-at-a-time), runs
    4 bytes off a 16-byte boundary, bank counts that pad, extra planes
    and bounds past ``2**n_bits``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitweaving import bitweaving_scan_kernel
    from repro_torch.kernels.bitwise import bitwise_kernel
    from repro_torch.kernels.popcount import popcount_kernel

    gen = torch.Generator(device=device).manual_seed(4321)
    n_cases = 0
    for op, arity in ref.ARITY.items():
        for shape in ((3, 1001), (8, 1 << 16), "misaligned"):
            if shape == "misaligned":
                args = [_draw_words(torch, gen, 4097)[1:].reshape(1, -1)
                        for _ in range(arity)]
                check(args[0].data_ptr() % 16 == 4, "slice is 16B-aligned")
            else:
                args = [_draw_words(torch, gen, *shape)
                        for _ in range(arity)]
            _compare(f"bitwise {op} {shape}", bitwise_kernel(op, *args),
                     ref.bitwise(op, *args), errs)
            n_cases += 1
        for banks in (1, 3, 8):
            args = [_draw_words(torch, gen, 2, 1001) for _ in range(arity)]
            _compare(f"bitwise_banked {op} banks={banks}",
                     kops.bitwise_banked(op, *args, n_banks=banks),
                     ref.bitwise(op, *args), errs)
            n_cases += 1
    for shape in ((1, 1), (3, 1001), (64, 1 << 16), "misaligned", "ones"):
        if shape == "misaligned":
            words = _draw_words(torch, gen, 4099)[1:].reshape(1, -1)
        elif shape == "ones":
            words = torch.full((1, 1 << 22), -1, dtype=torch.int32,
                               device=device)
        else:
            words = _draw_words(torch, gen, *shape)
        _compare(f"popcount {shape}", popcount_kernel(words),
                 ref.popcount(words), errs)
        n_cases += 1
    for n_bits in (1, 7, 12, 32):
        top = 1 << n_bits
        for case, lo, hi, extra in (("inside", top // 5, 3 * top // 4, 0),
                                    ("lo > hi", top - 1, 0, 0),
                                    ("hi >= 2**n_bits", top // 3, top + 5,
                                     0),
                                    ("b > n_bits", top // 7, top // 2, 3)):
            planes = _draw_words(torch, gen, n_bits + extra, 1001)
            _compare(f"bitweaving_scan n_bits={n_bits} {case}",
                     bitweaving_scan_kernel(planes, lo, hi, n_bits),
                     ref.bitweaving_scan(planes, lo, hi, n_bits), errs)
            n_cases += 1
    return n_cases


def _vote_arith_kernel_cases(torch, device, errs) -> int:
    """The majority, bit-serial add / sub / lt and untranspose kernels
    against their plain versions: every k the vote and its tests use,
    thresholds past both edges, ragged word and group counts."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.arith import (bitserial_add_kernel,
                                           bitserial_lt_kernel)
    from repro_torch.kernels.bittranspose import bit_transpose_kernel
    from repro_torch.kernels.majority import majority_kernel

    gen = torch.Generator(device=device).manual_seed(2402)
    n_cases = 0
    for k in (1, 2, 3, 4, 5, 7, 15, 31):
        for words in (1001, 1 << 16):
            planes = _draw_words(torch, gen, k, 3, words)
            for t in (None, 1, (k + 1) // 2, k, 0, k + 1):
                _compare(f"majority k={k} threshold={t} words={words}",
                         majority_kernel(planes, t),
                         ref.majority_k(planes, t), errs)
                n_cases += 1
    for n_bits in (1, 7, 8, 32):
        for rows, words in ((1, 1001), (3, 1001), (1, 1 << 18)):
            a = _draw_words(torch, gen, n_bits, rows, words)
            b = _draw_words(torch, gen, n_bits, rows, words)
            b[..., :100] = a[..., :100]          # equal lanes for lt
            for sub in (False, True):
                _compare(f"bitserial_add n_bits={n_bits} sub={sub} "
                         f"rows={rows} words={words}",
                         bitserial_add_kernel(a, b, sub),
                         ref.bitserial_add(a, b, sub), errs)
                n_cases += 1
            _compare(f"bitserial_lt n_bits={n_bits} rows={rows} "
                     f"words={words}", bitserial_lt_kernel(a, b),
                     ref.bitserial_lt(a, b), errs)
            n_cases += 1
    for n_bits in (1, 8, 13, 32):
        for groups in (1, 1001, 1 << 18):
            planes = _draw_words(torch, gen, n_bits, groups)
            _compare(f"bit_untranspose n_bits={n_bits} groups={groups}",
                     kops.bit_untranspose(planes, n_bits),
                     ref.bit_untranspose(planes, n_bits), errs)
            values = torch.randint(0, 1 << n_bits, (32 * groups,),
                                   dtype=torch.int64, generator=gen,
                                   device=device)
            values = torch.where(values >= 1 << 31, values - (1 << 32),
                                 values).to(torch.int32)
            back = kops.bit_untranspose(
                bit_transpose_kernel(values, n_bits), n_bits)
            check(torch.equal(back, values),
                  f"bit_untranspose round trip n_bits={n_bits} "
                  f"groups={groups}")
            # the first n_bits of 32 planes: the kernel reads no others
            wide = _draw_words(torch, gen, 32, groups)
            _compare(f"bit_untranspose n_bits={n_bits} of 32 planes "
                     f"groups={groups}", kops.bit_untranspose(wide, n_bits),
                     ref.bit_untranspose(wide, n_bits), errs)
            n_cases += 3
    return n_cases


#: flash attention's phase-2 shapes: (B, Sq, Sk, H, KV, hd, causal,
#: block_q, block_k): the JAX package's five test cases, a cross-attention
#: shape, a ragged causal one at the serving path's head width, and the
#: edges of the head-dim-128 Hopper kernels: Sq != Sk without the mask
#: (cross attention), GQA groups of 1 and 8, lengths that are not a
#: multiple of their 128-row tiles (130, 1,000), and B H = 144 query heads,
#: more than the card's 132 SMs; then the MoE configs' heads: Llama-4
#: Maverick's (40 query heads over 8, a group of 5, at S 2,048) and Kimi
#: K2's (64 over 8 at head dim 112, on the Hopper route)
FLASH_CASES = (
    (2, 128, 128, 4, 2, 32, True, 32, 32),
    (2, 128, 128, 4, 2, 32, False, 32, 32),
    (1, 100, 100, 4, 4, 16, False, 32, 32),
    (1, 80, 80, 8, 2, 64, True, 32, 16),
    (2, 64, 64, 8, 8, 128, True, 64, 64),
    (1, 64, 100, 4, 4, 32, False, 32, 32),
    (2, 1000, 1000, 16, 8, 128, True, 512, 512),
    (2, 100, 1000, 8, 2, 128, False, 64, 128),
    (1, 130, 130, 16, 16, 128, True, 64, 64),
    (1, 1000, 1000, 16, 2, 128, True, 512, 512),
    (9, 256, 256, 16, 8, 128, True, 128, 128),
    (1, 2048, 2048, 40, 8, 128, True, 512, 512),
    (1, 1000, 1000, 64, 8, 112, True, 512, 512),
)
#: the serving families' new flash shapes, forward and lse forward only
#: (their backward comes with training them): Zamba2's shared attention at
#: head dim 80 (32 query heads over 32) with a ragged Sq, causal and not;
#: SeamlessM4T's head dim 64 non-causal,
#: its cross-attention (2,048 queries over 1,024 frames) and its encoder
#: (1,024 over 1,024); the VLM's cross-attention on the Hopper kernel at
#: head dim 128 (2,048 queries over 1,600 patches, not a multiple of the
#: key tile, a GQA group of 8); then the edges of the Hopper route at
#: head dims 64, 80 and 112: Sk 100 (under one 128-key tile) and 1,000, Sq
#: 130 and 300 (ragged query tiles), GQA groups of 2 and 8 (Kimi K2's),
#: Sq != Sk causal and not, and B H = 144 and 160 query heads, more than
#: the card's 132 SMs
SERVE_FLASH_CASES = (
    (2, 1000, 1000, 32, 32, 80, True, 512, 512),
    (2, 1000, 1000, 32, 32, 80, False, 512, 512),
    (2, 2048, 1024, 16, 16, 64, False, 512, 512),
    (2, 1024, 1024, 16, 16, 64, False, 512, 512),
    (1, 2048, 1600, 64, 8, 128, False, 512, 512),
    (1, 130, 100, 16, 8, 64, True, 64, 64),
    (9, 130, 1000, 16, 8, 64, False, 128, 512),
    (1, 130, 100, 16, 8, 80, True, 64, 64),
    (5, 300, 100, 32, 16, 80, False, 128, 128),
    (1, 130, 100, 64, 8, 112, True, 64, 64),
    (9, 300, 1000, 16, 8, 112, False, 128, 512),
)
#: the kernels redesigned for Hopper that `phase_sm90_report` holds to
#: zero spills, by source: the flash kernels (TMA ring + wgmma; each
#: instance required by name): the bf16 forward at head dims 64, 80, 112
#: and 128, the bf16 backward at every head dim (`<HD, true>` enter p and
#: ds as hi + lo parts, `<128, false>` rounds them once to time what the
#: split costs), the float32 forward and backward at every head dim on
#: 3xTF32 and their pre-pass; the VM (pre-decoded program, cp.async tile
#: ring) and the bit transpose (register butterfly)
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
SM90_KERNELS = {
    "flashattn": tuple(f"flash_fwd_sm90_kernel<{hd}>"
                       for hd in (64, 80, 112, 128))
    + tuple(f"flash_fwd_tf32_sm90_kernel<{hd}>" for hd in HEAD_DIMS)
    + ("tf32_split_kernel",),
    "flashattn_bwd": tuple(f"flash_bwd_{k}_sm90_kernel<{hd}, true>"
                           for k in ("dq", "dkv") for hd in HEAD_DIMS)
    + ("flash_bwd_dq_sm90_kernel<128, false>",
       "flash_bwd_dkv_sm90_kernel<128, false>")
    + tuple(f"flash_bwd_{k}_tf32_sm90_kernel<{hd}>"
            for k in ("dq", "dkv") for hd in HEAD_DIMS)
    + ("tf32_split_kernel",),
    "vm": ("vm_kernel",),
    "bittranspose": ("bit_transpose_kernel",)}
#: the first designs' instances that the Hopper kernels replaced (bf16 on
#: mma.sync, float32 on scalar FMAs): a build that still holds one fails
RETIRED_KERNELS = {
    "flashattn": ("flash_mma_kernel<64>", "flash_mma_kernel<80>",
                  "flash_mma_kernel<112>")
    + tuple(f"flash_simt_kernel<{hd}>" for hd in HEAD_DIMS),
    "flashattn_bwd": tuple(f"flash_bwd_{k}_{d}_kernel<{hd}>"
                           for k in ("dq", "dkv") for d in ("mma", "simt")
                           for hd in HEAD_DIMS)}
#: kernel vs plain version: the JAX package's own bounds against its
#: oracle (tests/test_flashattn.py), relative to each element and to the
#: plain output's RMS over the launch; the two sum in another order and
#: may round p or the output to bf16 the other way
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _gate(got, want, tol: float):
    """(share of the tolerance used, largest absolute difference) of a
    float result against its plain version: every element must lie within
    ``tol`` x (RMS of ``want`` + its own magnitude), so the share is at
    most 1. An absolute term scaled to the output keeps the gate as tight
    for a causal row over 2k keys (outputs near 0.02) as for short rows."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not diff.numel():
        return 0.0, 0.0
    bound = tol * (w.pow(2).mean().sqrt() + w.abs())
    share = float((diff / bound.clamp_min(1e-30)).max())
    if not bool(torch.isfinite(g).all()):
        share = float("inf")
    return share, float(diff.max())


def _close(label, got, want, tol: float):
    """Hold a float kernel result to its plain version with `_gate`;
    returns the largest absolute difference and the share of the tolerance
    used."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    share, err = _gate(got, want, tol)
    check(share <= 1.0, f"{label}: kernel differs from plain (max abs err "
          f"{err:.3g}, {share:.3g} of the tolerance: {tol:g} x (RMS of "
          f"the plain output + each element's magnitude))")
    return err, share


SETMAXNREG = " (its consumer warpgroups take more with setmaxnreg)"


def _ptxas_entries(log: str, bases) -> dict:
    """The entry functions of ptxas's report whose names are in ``bases``,
    with their registers and spill bytes: ``{"name<args>": {"registers":
    r, "spill_stores": s, "spill_loads": l}}`` (template instances by
    their arguments, as ``<true, 4>``)."""
    import re

    report, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m is not None:
            entry = None
            for name in bases:
                hit = re.search(r"\d" + name + r"(I(?:L[bi]\d+E)+E)?",
                                m.group(1))
                if hit is None:
                    continue
                args = [("true" if v == "1" else "false") if k == "b"
                        else v for k, v in
                        re.findall(r"L([bi])(\d+)E", hit.group(1) or "")]
                entry = name + (f"<{', '.join(args)}>" if args else "")
                report[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m is not None:
            report[entry]["spill_stores"] = int(m.group(1))
            report[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m is not None:
            report[entry]["registers"] = int(m.group(1))
    return report


def phase_sm90_report(build_mod) -> dict:
    """Each `SM90_KERNELS` kernel's registers and spill bytes from
    ptxas's report of its build; fails if any of them spills, if a named
    template instance is missing, or if a `RETIRED_KERNELS` instance was
    built. Returns `_ptxas_entries`' report."""
    report = {}
    for source, kernels in SM90_KERNELS.items():
        log = build_mod.build_log(source)
        report.update(_ptxas_entries(
            log, sorted({n.split("<")[0] for n in kernels})))
        for name in kernels:
            check(name in report if "<" in name
                  else any(k.startswith(name) for k in report),
                  f"ptxas reported nothing for {name} ({source}.cu)")
        retired = RETIRED_KERNELS.get(source, ())
        built = _ptxas_entries(log, sorted({n.split("<")[0]
                                            for n in retired}))
        for name in retired:
            check(name not in built, f"{source}.cu still builds {name}, "
                  "which the Hopper route replaced")
    for name, r in report.items():
        check(len(r) == 3, f"ptxas's report of {name} is incomplete: {r}")
        # the float32 kernels run one consumer warpgroup and no setmaxnreg
        hands_over = name.startswith("flash_") and "_tf32_" not in name
        print(f"[kernels] ptxas {name}: {r['registers']} registers at "
              f"entry{SETMAXNREG if hands_over else ''}, "
              f"{r['spill_stores']} bytes spill stores, "
              f"{r['spill_loads']} bytes spill loads")
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{name} spills ({r['spill_stores']} bytes stored, "
              f"{r['spill_loads']} loaded)")
    return report


def _hm(x):
    """Model layout (B, S, heads, hd) -> head-major (B, heads, S, hd)."""
    return x.transpose(1, 2)


def _flash_cost(kind: str, q, k, causal: bool):
    """(flops, bytes, bytes ms, ops ms) of one launch of flash kernel
    ``kind`` on model-layout q (B, Sq, H, hd) and k (B, Sk, KV, hd):
    `kernels.flashattn.flash_cost` (the formula `launch.hlocost` charges
    too); bytes over the card's memory rate, FLOPs over its dense bf16
    rate in bf16 and in float32 as three TF32 products over its TF32
    rate (the least time float32-grade products take on the tensor
    cores; `_fma_ms` is the earlier FP32-FMA figure)."""
    from repro_torch.kernels.flashattn import flash_cost

    flops, nbytes = flash_cost(kind, q, k, causal)
    ops_s = (3 * flops / CARD.tf32_flops_per_s
             if str(q.dtype) == "torch.float32"
             else flops / CARD.flops_per_s(q.dtype))
    return flops, nbytes, nbytes / CARD.hbm_bytes_per_s * 1e3, ops_s * 1e3


def _fma_ms(flops: float) -> float:
    """The float32 flash bound on the FP32-FMA peak (the bound PERF.md's
    rows before the 3xTF32 kernels were priced at)."""
    return flops / CARD.f32_flops_per_s * 1e3


def _off_path(dtype: str, hd: int) -> bool:
    """A flash launch that no main path makes: float32 at a head dim
    other than 128 (3s serves and trains Qwen3-0.6B in float32 at 128),
    or bf16 at a head dim no config uses (16, 32)."""
    return hd != 128 if dtype == "float32" else hd in (16, 32)


def _time_off_path(torch, kind, q, k, v, causal, clock_hz, into, bwd=None):
    """Phase 2's numbers for one off-path launch of flash kernel ``kind``
    (`_off_path`): the kernel's device ms beside its bound, the plain
    version's and the library call's (``scaled_dot_product_attention``,
    for the backward that call's backward alone), added into
    ``into[kind][group]``, the group being its dtype and head dim.
    ``bwd``: (o, lse, do) for the backward."""
    from repro_torch.kernels import flashattn

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qc, kc, vc = (_hm(x).contiguous() for x in (q, k, v))
    if kind == "flash_attention":
        _, k_ms, _ = _time_ms(torch, lambda: flashattn.
                              flash_attention_kernel(q, k, v, causal), 3,
                              clock_hz)
        _, p_ms, _ = _time_ms(torch, lambda: flashattn.
                              flash_attention_plain(_hm(q), _hm(k), _hm(v),
                                                    causal), 1, clock_hz)
        _, lib_ms, _ = _time_ms(torch, lambda: sdpa(
            qc, kc, vc, is_causal=causal, enable_gqa=True), 3, clock_hz)
    else:
        o, lse, do = bwd
        _, k_ms, _ = _time_ms(torch, lambda: flashattn.
                              flash_attention_bwd_kernel(
                                  q, k, v, o, lse, do, causal), 3, clock_hz)
        _, p_ms, _ = _time_ms(torch, lambda: flashattn.
                              flash_attention_bwd_plain(
                                  _hm(q), _hm(k), _hm(v), _hm(o), lse,
                                  _hm(do), causal), 1, clock_hz)
        qg, kg, vg = (x.requires_grad_() for x in (qc, kc, vc))
        with torch.enable_grad():
            lib_o = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
        doc = _hm(do).contiguous()
        _, lib_ms, _ = _time_ms(torch, lambda: torch.autograd.grad(
            lib_o, (qg, kg, vg), doc, retain_graph=True), 3, clock_hz)
        del lib_o, doc, qg, kg, vg
    del qc, kc, vc
    flops, _, b_ms, o_ms = _flash_cost(kind, q, k, causal)
    group = f"{str(q.dtype).split('.')[-1]} hd {q.shape[-1]}"
    row = into.setdefault(kind, {}).setdefault(group, {
        "cases": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bytes_ms": 0.0, "ops_ms": 0.0, "fma_ms": 0.0, "library_ms": 0.0})
    row["cases"] += 1
    for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                     ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                     ("ops_ms", o_ms), ("fma_ms", _fma_ms(flops)),
                     ("library_ms", lib_ms)):
        row[key] += val


def _print_off_path(off: dict) -> None:
    for kind, groups in off.items():
        for group, r in groups.items():
            fma = (f"; on the FP32-FMA peak {r['fma_ms']:.3f} ms"
                   if group.startswith("float32") else "")
            print(f"[kernels] off the main path, {kind} {group}: "
                  f"{r['cases']} phase-2 launches, kernel {r['ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.3f} ms ("
                  f"{'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}"
                  f"{fma}), plain {r['plain_ms']:.3f} ms, library "
                  f"{r['library_ms']:.3f} ms")


def phase_flash_kernels(torch, clock_hz, off, shares) -> float:
    """The flash kernel against its plain version in both dtypes, and on
    `SERVE_FLASH_CASES` also the lse forward (its output equal to the
    serving kernel's, the lse within 1e-4); returns the largest absolute
    difference and keeps the largest share of the tolerance per dtype in
    ``shares["flash_attention"]``. Each off-path launch (`_off_path`) is
    also timed beside its bound and the library call into ``off``
    (`_time_off_path`)."""
    from repro_torch.kernels.flashattn import (flash_attention_fwd_kernel,
                                               flash_attention_fwd_plain,
                                               flash_attention_kernel)

    gen = torch.Generator(device="cuda").manual_seed(103)
    worst, n_cases, n_lse = 0.0, 0, 0
    most = dict.fromkeys(FLASH_TOL, 0.0)
    for name, tol in FLASH_TOL.items():
        dt = getattr(torch, name)
        for case in FLASH_CASES + SERVE_FLASH_CASES:
            B, Sq, Sk, H, KV, hd, causal, bq, bk = case
            q, k, v = (torch.randn(B, n, h, hd, generator=gen,
                                   device="cuda").to(dt)
                       for n, h in ((Sq, H), (Sk, KV), (Sk, KV)))
            label = (f"flash_attention {name} B={B} Sq={Sq} Sk={Sk} H={H} "
                     f"KV={KV} hd={hd} causal={causal}")
            got = flash_attention_kernel(q, k, v, causal=causal, block_q=bq,
                                         block_k=bk)
            want, lse_want = flash_attention_fwd_plain(
                _hm(q), _hm(k), _hm(v), causal, bq, bk)
            err, share = _close(label, got, _hm(want), tol)
            if _off_path(name, hd):
                _time_off_path(torch, "flash_attention", q, k, v, causal,
                               clock_hz, off)
            if case in SERVE_FLASH_CASES:
                o, lse = flash_attention_fwd_kernel(q, k, v, causal)
                check(torch.equal(o, got), f"{label}: the lse forward's "
                      "output differs from the serving kernel's")
                share = max(share, _close(f"{label} lse", lse, lse_want,
                                          1e-4)[1])
                n_lse += 1
            worst, most[name] = max(worst, err), max(most[name], share)
            n_cases += 1
    torch.cuda.synchronize()
    print(f"[kernels] flash attention: {n_cases} cases within the "
          f"tolerance of the plain version (float32 {FLASH_TOL['float32']}, "
          f"bf16 {FLASH_TOL['bfloat16']}, of the output's RMS plus each "
          f"element's magnitude), {n_lse} of them (the serving families' "
          f"head dims 80, 64, 112 and 128 with Sq != Sk) also through the "
          f"lse forward (its output equal, the lse within 1e-4); largest "
          f"max abs err {worst:.3g}, largest share of the tolerance "
          + ", ".join(f"{n} {v:.3g}" for n, v in most.items()))
    shares["flash_attention"] = most
    return worst


#: the training kernels' phase-2 shapes: FLASH_CASES (the JAX package's
#: five, cross-attention, S = 1,000 causal at hd 128, the MoE configs'
#: heads: head dim 112 has an lse forward and a backward instantiation too)
#: and the training path's sequence length; then the trained families'
#: shapes: Zamba2's shared attention at head dim 80 (32 heads over 32,
#: 1,000 queries, causal and not; a GQA group of 2; 100 keys, under one
#: key tile of the Hopper forward; B H = 160 query heads, over the card's
#: 132 SMs), SeamlessM4T's at a training microbatch (B 2, 16 heads of 64:
#: the encoder's 1,024 frames, the decoder's causal 4,096, the cross
#: attention of 4,096 queries over 1,024 frames) and the VLM's cross
#: attention on the head-dim-128 Hopper backward (4,096 queries over
#: 1,600 patches, not a multiple of its key tile, 64 heads over 8); then
#: the Hopper backward's edges at head dims 64 and 112 (those at 80 are
#: above): 100 keys (under one 128-key tile of the dk / dv kernel), 130
#: and 300 queries (ragged query tiles), GQA groups of 2 and 8 (Kimi
#: K2's), B H = 144 and 160 query heads, more than the card's 132 SMs,
#: and at 112 Sq != Sk causal both ways (300 queries over 1,000 keys:
#: the keys past the last query take no gradient) and not
TRAIN_FLASH_CASES = FLASH_CASES + (
    (1, 4096, 4096, 16, 8, 128, True, 512, 512),
    (2, 1000, 1000, 32, 32, 80, True, 512, 512),
    (2, 1000, 1000, 32, 32, 80, False, 512, 512),
    (2, 300, 300, 8, 4, 80, True, 128, 128),
    (1, 130, 100, 16, 8, 80, True, 64, 64),
    (5, 300, 100, 32, 16, 80, False, 128, 128),
    (2, 1024, 1024, 16, 16, 64, False, 512, 512),
    (2, 4096, 4096, 16, 16, 64, True, 512, 512),
    (2, 4096, 1024, 16, 16, 64, False, 512, 512),
    (1, 4096, 1600, 64, 8, 128, False, 512, 512),
    (1, 130, 100, 16, 8, 64, True, 64, 64),
    (9, 130, 1000, 16, 8, 64, False, 128, 512),
    (2, 300, 300, 8, 4, 64, True, 128, 128),
    (5, 300, 100, 32, 16, 64, False, 128, 128),
    (1, 130, 100, 64, 8, 112, True, 64, 64),
    (9, 300, 1000, 16, 8, 112, False, 128, 512),
    (2, 300, 300, 16, 2, 112, True, 128, 128),
    (1, 300, 1000, 64, 8, 112, True, 128, 512),
    (5, 300, 100, 32, 16, 112, False, 128, 128),
)


def _close_all(label, got, want, tol):
    """`_close` over matching tuples of results; returns the largest
    absolute difference and share of the tolerance."""
    worst = most = 0.0
    for name, g, w in zip(("o / dq", "lse / dk", "dv"), got, want):
        err, share = _close(f"{label} {name}", g, w, tol)
        worst, most = max(worst, err), max(most, share)
    return worst, most


def phase_train_kernels(torch, clock_hz, off, shares) -> dict:
    """The lse-emitting forward and the backward against their plain
    versions in both dtypes (the lse to 1e-4 of its RMS plus each
    element), and the sign pack / unpack bit for bit; returns the largest
    absolute difference per kernel and keeps the largest share of the
    tolerance per dtype in ``shares["training"]``. Each off-path backward
    launch (`_off_path`) is also timed into ``off``
    (`_time_off_path`)."""
    from repro_torch.kernels import flashattn, ref, signpack

    gen = torch.Generator(device="cuda").manual_seed(107)
    worst = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    most, n_cases = dict.fromkeys(FLASH_TOL, 0.0), 0
    for name, tol in FLASH_TOL.items():
        dt = getattr(torch, name)
        for B, Sq, Sk, H, KV, hd, causal, bq, bk in TRAIN_FLASH_CASES:
            q, k, v = (torch.randn(B, n, h, hd, generator=gen,
                                   device="cuda").to(dt)
                       for n, h in ((Sq, H), (Sk, KV), (Sk, KV)))
            do = torch.randn(B, Sq, H, hd, generator=gen,
                             device="cuda").to(dt)
            label = (f"{name} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                     f"causal={causal}")
            o, lse = flashattn.flash_attention_fwd_kernel(q, k, v, causal)
            check(torch.equal(o, flashattn.flash_attention_kernel(
                q, k, v, causal)), f"flash_attention_fwd {label}: the "
                "output differs from the serving kernel's")
            po, plse = flashattn.flash_attention_fwd_plain(
                _hm(q), _hm(k), _hm(v), causal, bq, bk)
            err_o, share_o = _close(f"flash_attention_fwd {label} o", o,
                                    _hm(po), tol)
            err_l, share_l = _close(f"flash_attention_fwd {label} lse", lse,
                                    plse, 1e-4)
            grads = flashattn.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                         causal)
            again = flashattn.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                         causal)
            check(all(torch.equal(g, a) for g, a in zip(grads, again)),
                  f"flash_attention_bwd {label}: two runs on the same "
                  f"inputs differ")
            del again
            want = flashattn.flash_attention_bwd_plain(
                _hm(q), _hm(k), _hm(v), _hm(o), lse, _hm(do), causal, bq,
                bk)
            err_b, share_b = _close_all(f"flash_attention_bwd {label}",
                                        grads, [_hm(w) for w in want], tol)
            del grads, want
            if _off_path(name, hd):
                _time_off_path(torch, "flash_attention_bwd", q, k, v,
                               causal, clock_hz, off, bwd=(o, lse, do))
            worst["flash_attention_fwd"] = max(
                worst["flash_attention_fwd"], err_o, err_l)
            worst["flash_attention_bwd"] = max(
                worst["flash_attention_bwd"], err_b)
            most[name] = max(most[name], share_o, share_l, share_b)
            n_cases += 1
    # sign pack / unpack: the special lanes (+-0, +-inf, NaNs with and
    # without the sign bit) at the front of every row
    special = {torch.float32: [0x00000000, 0x80000000, 0x7F800000,
                               0xFF800000, 0x7FC00000, 0xFFC00000],
               torch.bfloat16: [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0,
                                0xFFC0]}
    n_sign = 0
    for shape in ((3, 32 * 1001), (1, 1 << 26)):
        for dt, bits in special.items():
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            wide = dt == torch.float32
            itype = torch.int32 if wide else torch.int16
            pattern = np.array(bits, np.uint32 if wide else np.uint16)
            x[:, :len(bits)] = torch.from_numpy(pattern.view(
                np.int32 if wide else np.int16)).to("cuda").view(dt)
            words = signpack.pack_signs_kernel(x)
            _compare(f"pack_signs {dt} {shape}", words, ref.pack_signs(x),
                     [])
            _compare(f"unpack_signs {dt} {shape}",
                     signpack.unpack_signs_kernel(words, dt).view(itype),
                     ref.unpack_signs(words, dt).view(itype), [])
            n_sign += 2
    torch.cuda.synchronize()
    print(f"[kernels] training flash attention: {n_cases} cases of the "
          f"lse forward (its output equal to the serving kernel's) and the "
          f"backward (bit-identical over two runs) within the tolerance of "
          f"the plain versions (largest share "
          + ", ".join(f"{n} {v:.3g}" for n, v in most.items())
          + f"; max abs err forward "
          f"{worst['flash_attention_fwd']:.3g}, backward "
          f"{worst['flash_attention_bwd']:.3g}); sign pack / unpack: "
          f"{n_sign} cases bit-identical")
    shares["training"] = most
    return dict(worst, pack_signs=0.0, unpack_signs=0.0)


#: phase 2's MoE case: reduced widths (d_model 1,024, 16 experts, top-2,
#: expert d_ff 2,048) in float32, capacity factor 1.0 so that a random
#: router drops tokens; the card's output within 1e-4 of the host's
#: largest magnitude (the CPU tests' float32 bound for the models), the
#: aux loss within 1e-5 relative, the routing equal
MOE_FFN_CFG = dict(d_model=1024, n_experts=16, top_k=2, d_ff=2048,
                   capacity_factor=1.0, dtype="float32")
MOE_FFN_TOL = 1e-4


def phase_moe_ffn(torch) -> float:
    """`moe_ffn` on the card against the same function on the CPU, at a
    batch that drops tokens; returns the output's largest relative
    difference."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import moe

    cfg = dataclasses.replace(reduced(get_config(MOE_ARCH)), **MOE_FFN_CFG)
    gen = torch.Generator(device="cuda").manual_seed(109)
    p = moe.moe_init(gen, cfg, "cuda")
    x = torch.randn(2, 1024, cfg.d_model, generator=gen, device="cuda")
    y, aux = moe.moe_ffn(p, x, cfg)
    host = copy.deepcopy(p).to("cpu")
    y_host, aux_host = moe.moe_ffn(host, x.cpu(), cfg)
    T = x.shape[0] * x.shape[1]
    C = moe.expert_capacity(cfg, T)
    probs, _, idx = moe.route(p.router, x.reshape(T, -1), cfg.top_k)
    _, _, idx_host = moe.route(host.router, x.cpu().reshape(T, -1),
                               cfg.top_k)
    top = probs.topk(cfg.top_k + 1, dim=-1).values
    gap = float((top[:, -2] - top[:, -1]).min())
    check(torch.equal(idx.cpu(), idx_host),
          f"moe_ffn: the card routes other experts than the host (the "
          f"smallest gap between the kept and the next probability is "
          f"{gap:.3g})")
    d = moe.dispatch(idx, cfg.n_experts, C)
    dropped = int((~d.keep).sum())
    check(dropped > 0, "moe_ffn: the case drops no token")
    err = float((y.cpu() - y_host).abs().max() / y_host.abs().max())
    check(err <= MOE_FFN_TOL, f"moe_ffn on the card vs the CPU: {err:.3g} "
          f"of the largest output (> {MOE_FFN_TOL})")
    err_aux = abs(float(aux) - float(aux_host)) / abs(float(aux_host))
    check(err_aux <= 1e-5, f"moe_ffn aux loss: {err_aux:.3g} relative")
    print(f"[kernels] moe_ffn float32 (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts, top-{cfg.top_k}, {T} tokens, capacity "
          f"{C}, {dropped} of {T * cfg.top_k} slots dropped) on the card vs "
          f"the CPU: output {err:.3g} of its largest magnitude (bound "
          f"{MOE_FFN_TOL}), aux {err_aux:.3g} relative, routing equal "
          f"(smallest kept-vs-next gap {gap:.3g})")
    return err



# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


class FaultDraw:
    """The key and arguments of one `core.errors.error_planes` draw, to
    redraw a VM launch's fault masks in phase 4 instead of keeping them,
    with a fingerprint (sum and count of the nonzero mask words) that the
    redraw must match."""

    def __init__(self, key, table, batch, row_words, model, device, masks):
        self.key, self.table, self.batch = key, table, batch
        self.row_words, self.model, self.device = row_words, model, device
        self.words = masks.numel()
        self.fingerprint = self._fingerprint(masks)

    @staticmethod
    def _fingerprint(masks):
        import torch

        return (int(masks.sum(dtype=torch.int64)),
                int(torch.count_nonzero(masks)))

    def redraw(self):
        """The masks again, in the VM's ``(B, 4 * n_cmds, W)`` layout."""
        from repro_torch.core import errors

        masks = errors.error_planes(
            self.table, errors.fault_generator(self.key, self.device),
            self.batch, self.row_words, self.model, self.device)
        check(self._fingerprint(masks) == self.fingerprint,
              f"the masks redrawn from key {self.key} differ from the "
              "main path's draw")
        return masks.movedim((0, 1), (-3, -2)).reshape(
            -1, 4 * masks.shape[0], self.row_words)


class Recorder:
    """Wraps the kernel wrappers the main path calls and keeps each call's
    arguments, so phase 4 can replay exactly the slice's launches. The
    wrappers themselves (and their launch counters) are untouched. Calls
    are kept only while ``stage`` names a stage of a main-path run (not
    None), so the checks after each run record nothing, and, while
    ``only`` is a set, only calls of the kinds it names, and while
    ``limit`` is set, at most that many of a kind in one stage. A VM
    launch with fault masks keeps the masks' `FaultDraw` in their place,
    and only while ``faulty`` is set: the largest such launch (batch x
    commands x words) and the first with a batch of one."""

    def __init__(self):
        import repro_torch.core.errors as errors
        import repro_torch.kernels.bittranspose as bt
        import repro_torch.kernels.vm as vm

        self.calls = []
        self.stage = None
        self.only = None
        self.limit = None
        self.faulty = False
        self._key = self._draw = None
        self._largest = self._single = None
        self._restore = [(vm, "vm_megakernel", vm.vm_megakernel),
                         (bt, "bit_transpose_kernel",
                          bt.bit_transpose_kernel),
                         (errors, "fault_generator", errors.fault_generator),
                         (errors, "error_planes", errors.error_planes)]
        orig_vm, orig_bt = vm.vm_megakernel, bt.bit_transpose_kernel
        orig_gen, orig_planes = errors.fault_generator, errors.error_planes

        def gen_rec(key, device):
            self._key = tuple(key)
            return orig_gen(key, device)

        def planes_rec(table, generator, batch, row_words, model,
                       device=None):
            masks = orig_planes(table, generator, batch, row_words, model,
                                device)
            self._draw = None
            if self.faulty and self.stage is not None:
                self._draw = (self._key, table, tuple(batch), row_words,
                              model, masks.device, masks)
            return masks

        def vm_rec(table, plane, out_idx, **kw):
            if kw.get("errors") is None:
                self._keep("vm", (table, plane, tuple(out_idx)), kw)
            else:
                self._keep_faulty(table, plane, tuple(out_idx), kw)
            return orig_vm(table, plane, out_idx, **kw)

        def bt_rec(values, n_bits):
            self._keep("bt", (values, n_bits), {})
            return orig_bt(values, n_bits)

        vm.vm_megakernel = vm_rec
        bt.bit_transpose_kernel = bt_rec
        errors.fault_generator = gen_rec
        errors.error_planes = planes_rec
        import repro_torch.kernels.arith as arith
        import repro_torch.kernels.bitwise as bitwise
        import repro_torch.kernels.bitweaving as bitweaving
        import repro_torch.kernels.flashattn as flashattn
        import repro_torch.kernels.majority as majority
        import repro_torch.kernels.popcount as popcount
        import repro_torch.kernels.signpack as signpack

        for mod, fn, name in ((bitwise, "bitwise_kernel", "bitwise"),
                              (bitwise, "banked_bitwise_kernel",
                               "bitwise_banked"),
                              (popcount, "popcount_kernel", "popcount"),
                              (bitweaving, "bitweaving_scan_kernel",
                               "bitweaving_scan"),
                              (majority, "majority_kernel", "majority"),
                              (arith, "bitserial_add_kernel",
                               "bitserial_add"),
                              (arith, "bitserial_lt_kernel", "bitserial_lt"),
                              (bt, "bit_untranspose_kernel",
                               "bit_untranspose"),
                              (flashattn, "flash_attention_kernel",
                               "flash_attention"),
                              (flashattn, "flash_attention_fwd_kernel",
                               "flash_attention_fwd"),
                              (flashattn, "flash_attention_bwd_kernel",
                               "flash_attention_bwd"),
                              (signpack, "pack_signs_kernel", "pack_signs"),
                              (signpack, "unpack_signs_kernel",
                               "unpack_signs")):
            self._wrap(mod, fn, name)

    def _wrap(self, mod, fn: str, name: str) -> None:
        """Record every call of ``mod.fn`` as a launch of kernel
        ``name``."""
        orig = getattr(mod, fn)

        def rec(*args, **kw):
            self._keep(name, args, kw)
            return orig(*args, **kw)

        self._restore.append((mod, fn, orig))
        setattr(mod, fn, rec)

    def _keep(self, kind: str, args, kw) -> None:
        if self.limit is not None and sum(
                c[0] == kind and c[3] == self.stage
                for c in self.calls) >= self.limit:
            return
        if self.stage is not None and (self.only is None
                                       or kind in self.only):
            # detached: a kept training activation must not keep its
            # autograd graph (and the tensors the graph saved) alive
            args = tuple(a.detach() if hasattr(a, "detach") else a
                         for a in args)
            self.calls.append((kind, args, kw, self.stage))

    def _keep_faulty(self, table, plane, out_idx, kw) -> None:
        """Keep a VM launch with fault masks if it is the largest so far
        (dropping the previous largest) or the first with a batch of one,
        its masks replaced by their draw."""
        draw, self._draw = self._draw, None
        if not self.faulty or self.stage is None or draw is None:
            return
        key, lp_table, batch, row_words, model, device, masks = draw
        check(kw["errors"].data_ptr() == masks.data_ptr(),
              "a VM launch's fault masks are not the last draw's")
        size = plane.shape[0] * table.shape[0] * plane.shape[2]
        single = self._single is None and plane.shape[0] == 1
        if not single and self._largest is not None \
                and size <= self._largest[0]:
            return
        call = ("vm", (table, plane, out_idx),
                dict(kw, errors=FaultDraw(key, lp_table, batch, row_words,
                                          model, device, masks)),
                self.stage)
        if single:
            self._single = call
        else:
            if self._largest is not None:
                old = self._largest[1]
                self.calls = [c for c in self.calls if c is not old]
            self._largest = (size, call)
        self.calls.append(call)

    def held_bytes(self) -> int:
        """Device bytes the recorded arguments keep alive."""
        import torch

        seen = {}
        for _, args, kw, _ in self.calls:
            for t in (*args, *kw.values()):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    st = t.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)

    def drop(self):
        """Forget every kept call (phase 4 has replayed them)."""
        self.calls.clear()
        self._largest = self._single = None


def _raw_tenant0(spec):
    """Tenant 0's raw seeded data, drawn in `build_service`'s order."""
    rng = np.random.default_rng(spec.seed)
    m = spec.domain_bits
    days = [[rng.random(m) < spec.p_active for _ in range(7)]
            for _ in range(spec.n_weeks)]
    rng.random(m)                                   # male
    for _ in range(spec.n_sets):
        rng.random(m)
    col = rng.integers(0, 1 << spec.col_bits, m, dtype=np.uint32)
    col2 = rng.integers(0, 1 << spec.col_bits, m, dtype=np.uint32)
    return days, col, col2


def phase_slice(torch, spec, rec):
    from repro_torch.apps.bitmap_index import week_or
    from repro_torch.kernels import LAUNCHES
    from repro_torch.service import (AGGREGATE, MATERIALIZE, Query,
                                     build_service, query_stream,
                                     run_queries_unbatched)

    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage = "ingest"
    t0 = time.perf_counter()
    svc = build_service(spec, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    queries = query_stream(spec, svc)
    mat = [Query(week_or(1, prefix="t1/"), MATERIALIZE, tenant="t1"),
           Query("t2/col + t2/col2", MATERIALIZE, tenant="t2"),
           Query(svc.range_scan_query("t3/col", 10, 200), MATERIALIZE,
                 tenant="t3"),
           Query("t0/s1 & ~t0/s2", MATERIALIZE, tenant="t0")]
    rec.stage = "batch"
    t0 = time.perf_counter()
    report = svc.query_batch(queries)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    # the same stream again, every plan cached
    rec.stage = "warm batch"
    t0 = time.perf_counter()
    warm = svc.query_batch(queries)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    rec.stage = "materialize batch"
    report_mat = svc.query_batch(mat)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    rec.stage = None
    peak = torch.cuda.max_memory_allocated()
    held = rec.held_bytes()
    print(f"[slice] domain {spec.domain_bits} bits, {len(svc.catalog)} "
          f"vectors; build_service {t_build:.2f} s; {len(queries)}-query "
          f"batch {t_batch:.3f} s wall, {t_warm:.3f} s with every plan "
          f"cached ({report.n_plan_groups} plan groups, "
          f"{report.n_cse_planes} shared planes); peak device memory "
          f"{peak / 2**30:.2f} GiB, of which the launch recorder holds "
          f"{held / 2**30:.2f} GiB of replay inputs")
    print(f"[slice] launches while the slice ran: {launches}")
    for name in SERVICE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the main path")

    check([r.scalar for r in warm.results] == [r.scalar for r in
                                                report.results],
          "the warm batch disagrees with the first")
    oracle = run_queries_unbatched(svc.catalog, queries)
    for got, want in zip(report.results, oracle.results):
        check(got.scalar == want.scalar,
              f"query {got.index}: served {got.scalar} != oracle "
              f"{want.scalar} ({queries[got.index].query})")
    oracle_mat = run_queries_unbatched(svc.catalog, mat)
    for got, want in zip(report_mat.results, oracle_mat.results):
        check(np.array_equal(got.value, want.value)
              and got.scalar == want.scalar,
              f"materialize query {got.index} differs from the oracle")
    days, col, col2 = _raw_tenant0(spec)
    want_sum = int(col.astype(np.int64).sum())
    got_sum = svc.query("sum(t0/col)", AGGREGATE).scalar
    check(got_sum == want_sum, f"sum(t0/col) {got_sum} != numpy {want_sum}")
    want_add = int(((col.astype(np.int64) + col2) % (1 << spec.col_bits))
                   .sum())
    got_add = svc.query("sum(t0/col + t0/col2)", AGGREGATE).scalar
    check(got_add == want_add,
          f"sum(t0/col + t0/col2) {got_add} != numpy {want_add}")
    want_week = int(np.logical_or.reduce(days[0]).sum())
    got_week = svc.query(week_or(0, prefix="t0/")).scalar
    check(got_week == want_week,
          f"weekly OR count {got_week} != numpy {want_week}")
    print(f"[slice] {len(queries)} scalars and {len(mat)} materialized "
          f"results equal the unbatched interpreter; sum(t0/col)="
          f"{got_sum}, sum(t0/col+t0/col2)={got_add}, weekly-OR "
          f"count={got_week} equal numpy")
    clean = {"svc": svc, "queries": queries, "mat": mat,
             "scalars": [r.scalar for r in report.results],
             "mat_values": [r.value for r in report_mat.results]}
    return launches, {"batch_wall_s": t_batch,
                      "warm_batch_wall_s": t_warm,
                      "build_service_s": t_build,
                      "peak_device_bytes": peak,
                      "recorder_held_bytes": held,
                      "n_plan_groups": report.n_plan_groups,
                      "n_cse_planes": report.n_cse_planes}, clean


_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)],
                           dtype=np.uint8)


def _np_popcount(x: np.ndarray) -> int:
    """Set bits of a numpy uint32 array, by byte lookup."""
    return int(_POPCOUNT_TABLE[np.ascontiguousarray(x).view(np.uint8)]
               .sum(dtype=np.int64))


def _np_bitwise(op: str, *a: np.ndarray) -> np.ndarray:
    """The nine ops in numpy on uint32 words (the independent oracle)."""
    if op == "not":
        return ~a[0]
    if op == "maj3":
        x, y, z = a
        return (x & y) | (y & z) | (z & x)
    x, y = a
    return {"and": x & y, "or": x | y, "xor": x ^ y, "nand": ~(x & y),
            "nor": ~(x | y), "xnor": ~(x ^ y), "andnot": x & ~y}[op]


def _packed(sel: np.ndarray) -> np.ndarray:
    """bool (n,) -> LSB-first uint32 words, the port's packing."""
    n_w = (sel.shape[0] + 31) // 32
    out = np.zeros(n_w * 4, dtype=np.uint8)
    b = np.packbits(sel, bitorder="little")
    out[:b.shape[0]] = b
    return out.view("<u4")


#: Fig. 9's operand: 32 MiB of words
FIG9_WORDS = 8_388_608
#: §8.1: the paper's 16 M users over 4 weeks
M_USERS, N_WEEKS = 1 << 24, 4
#: §8.2: Fig. 11's largest column, cut to a ragged count (sentinel + tail)
SCAN_VALUES = (1 << 25) - 7
SCANS = ((12, 500, 2500), (32, 1 << 30, 3 << 30))
#: §8.3: k sets of m elements over the paper's 2**19 domain
K_SETS, SET_SIZE, SET_DOMAIN = 15, 1024, 1 << 19


def phase_direct(torch, rec):
    """The paper's direct bulk-bitwise path (Fig. 9, §8.1-§8.3, the banked
    engine) through its public entry points on the card, every result
    against numpy on the raw data."""
    import functools

    from repro_torch import ops
    from repro_torch.apps import bitmap_index, bitset, bitweaving
    from repro_torch.core import compiler, engine
    from repro_torch.core.bitplane import to_uint32
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import ARITY

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2016)
    fig9 = [_draw_words(torch, gen, FIG9_WORDS) for _ in range(3)]
    fig9_host = [to_uint32(t) for t in fig9]
    fns = {"and": ops.bitwise_and, "or": ops.bitwise_or,
           "xor": ops.bitwise_xor, "nand": ops.bitwise_nand,
           "nor": ops.bitwise_nor, "xnor": ops.bitwise_xnor,
           "andnot": ops.andnot, "not": ops.bitwise_not,
           "maj3": ops.majority3}
    torch.cuda.synchronize()

    LAUNCHES.clear()
    t_start = time.perf_counter()
    fig9_out = {}
    for banks in (1, 8):
        rec.stage = f"fig9 banks={banks}"
        for op, k in ARITY.items():
            out = fns[op](*fig9[:k], banks=banks)
            fig9_out[(op, banks)] = (out, kops.popcount(out))
    rec.stage = "§8.1 bitmap index"
    db = bitmap_index.UserDatabase.synthetic(M_USERS, N_WEEKS, generator=gen,
                                             device=dev)
    n_every, male_counts, op_counts = bitmap_index.weekly_active_query(db)
    s_every, s_male, _ = bitmap_index.weekly_active_query_service(db)
    rec.stage = "§8.2 bitweaving"
    scans = []
    for n_bits, c1, c2 in SCANS:
        if n_bits == 32:
            values = _draw_words(torch, gen, SCAN_VALUES)
        else:
            values = torch.randint(0, 1 << n_bits, (SCAN_VALUES,),
                                   dtype=torch.int32, generator=gen,
                                   device=dev)
        count, bv = bitweaving.scan_query(values, n_bits, c1, c2)
        scans.append((n_bits, c1, c2, values, count, bv))
    rec.stage = "§8.3 bitset"
    elems = [torch.randint(0, SET_DOMAIN, (SET_SIZE,), generator=gen,
                           device=dev) for _ in range(K_SETS)]
    sets = [ops.BitSet.from_elements(e, SET_DOMAIN) for e in elems]
    merged = {(op, banks): getattr(sets[0], op)(*sets[1:], banks=banks)
              for op in ("union", "intersection", "difference")
              for banks in (1, 8)}
    served = {op: bitset.setop_via_service(elems, SET_DOMAIN, op)
              for op in ("union", "intersection", "difference")}
    rec.stage = "engine n_banks=8"
    E = compiler.Expr
    d = [E.of(f"D{i}") for i in range(6)]
    prog = compiler.compile_expr_fused(
        E("maj3", (d[0] ^ d[1], d[2] & ~d[3], d[4] | d[5])) ^ (d[1] & d[4]),
        "OUT").program
    rows = {f"D{i}": _draw_words(torch, gen, 1 << 20) for i in range(6)}
    one = engine.execute(prog, rows, outputs=["OUT"])["OUT"]
    eight = engine.execute(prog, rows, outputs=["OUT"], n_banks=8)["OUT"]
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_start
    launches = dict(LAUNCHES)
    rec.stage = None
    print(f"[direct] launches while the direct path ran: {launches}")
    for name in DIRECT_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the direct path")

    # Fig. 9 against numpy
    for (op, banks), (out, count) in fig9_out.items():
        want = _np_bitwise(op, *fig9_host[:ARITY[op]])
        check(np.array_equal(to_uint32(out), want),
              f"fig9 {op} banks={banks} differs from numpy")
        check(int(count) == _np_popcount(want),
              f"fig9 {op} banks={banks}: popcount {int(count)} != numpy")
    # §8.1 against numpy on the packed words, and against the service
    daily, male = to_uint32(db.daily), to_uint32(db.male)
    weekly = np.bitwise_or.reduce(daily, axis=1)
    want_every = _np_popcount(np.bitwise_and.reduce(weekly, axis=0))
    want_male = [_np_popcount(weekly[w] & male) for w in range(N_WEEKS)]
    check(int(n_every) == want_every == s_every,
          f"§8.1 every-week actives {int(n_every)} / service {s_every} "
          f"!= numpy {want_every}")
    check(male_counts.tolist() == want_male == s_male.tolist(),
          f"§8.1 male actives {male_counts.tolist()} / service "
          f"{s_male.tolist()} != numpy {want_male}")
    check(op_counts == {"or": 6 * N_WEEKS, "and": 2 * N_WEEKS - 1,
                        "bitcount": N_WEEKS + 1}, f"§8.1 ops {op_counts}")
    # §8.2 against numpy
    scan_counts = []
    for n_bits, c1, c2, values, count, bv in scans:
        v = to_uint32(values)
        sel = (v >= c1) & (v <= c2)
        check(int(count) == int(sel.sum()),
              f"§8.2 scan n_bits={n_bits}: {int(count)} != numpy "
              f"{int(sel.sum())}")
        check(np.array_equal(to_uint32(bv.words), _packed(sel)),
              f"§8.2 scan n_bits={n_bits}: result words differ from numpy")
        scan_counts.append(int(count))
    # §8.3 against numpy's set routines
    host = [e.cpu().numpy() for e in elems]
    want = {"union": functools.reduce(np.union1d, host),
            "intersection": functools.reduce(np.intersect1d, host),
            "difference": functools.reduce(np.setdiff1d, host)}
    for (op, banks), s in merged.items():
        check(np.array_equal(s.to_elements().cpu().numpy(), want[op]),
              f"§8.3 {op} banks={banks} differs from numpy")
    for op, (res, r, ref_set) in served.items():
        check(np.array_equal(res.to_elements().cpu().numpy(), want[op])
              and torch.equal(res.bits.words, ref_set.bits.words)
              and r.scalar == len(want[op]),
              f"§8.3 {op} through the service differs from numpy")
    check(torch.equal(one, eight), "engine n_banks=8 != n_banks=1")
    print(f"[direct] {len(fig9_out)} Fig. 9 ops on {FIG9_WORDS}-word "
          f"operands, §8.1 ({M_USERS} users x {N_WEEKS} weeks: "
          f"{want_every} active every week, male per week {want_male}), "
          f"§8.2 counts {scan_counts} over {SCAN_VALUES} values, §8.3 "
          f"|union|={len(want['union'])} |intersection|="
          f"{len(want['intersection'])} |difference|="
          f"{len(want['difference'])}, and the banked engine all equal "
          f"numpy; the path took {t_path:.2f} s wall")
    return launches, {"direct_wall_s": t_path}


#: phase 3c's flip rate: the first of these whose reckoned expectation of
#: output bits wrong in two replicas at once stays under the limit
RELIABILITY_P = (1e-8, 5e-9, 2e-9, 1e-9)
DOUBLE_FAULT_LIMIT = 1e-3


def _plan_groups(svc, queries):
    """The plan groups the scheduler dispatches for one batch (no CSE:
    mitigated batches share no planes), as lists of bound plans."""
    groups = {}
    for bp in svc.scheduler.plan_queries(queries):
        groups.setdefault(bp.plan.key, []).append(bp)
    return list(groups.values())


def _double_fault_bits(svc, batches, model):
    """(bound, flips): an upper bound on the expected number of output
    bits wrong in two of three replicas at once, and on the expected
    faults one replica of every group injects.

    A fault at a bit position reaches the outputs only at that position
    (the programs are bitwise and their carries ripple across planes of
    one lane), so in one replica an output bit is wrong with probability
    at most q = sum over the group's commands of the largest class flip
    probability, and in two of three at most 3 q**2; summed over every
    output plane bit of every group of every batch."""
    words = svc.catalog.mask().shape[0]
    bound = flips = 0.0
    for queries in batches:
        for members in _plan_groups(svc, queries):
            plan = members[0].plan
            if plan.lowered is None:
                continue
            q = float(model.flip_probs(plan.lowered.table)
                      .astype(np.float64).max(axis=1).sum())
            bits = len(members) * 32 * words
            bound += 3 * min(q, 1.0) ** 2 * bits * len(plan.outputs)
            flips += q * bits
    return bound, flips


def _service_like(base, rel):
    """A service on ``base``'s catalog vectors (the same tensors, groups,
    columns and placement order) under reliability ``rel``."""
    from repro_torch.service import QueryService, ServiceConfig

    svc = QueryService(ServiceConfig(n_banks=base.n_banks, device="cuda",
                                     reliability=rel))
    for name in base.catalog.names():
        e = base.catalog.get(name)
        svc.catalog.register(name, e.words, e.n_bits, group=e.group)
    svc.catalog.columns.update(base.catalog.columns)
    svc._columns.update(base._columns)     # range_scan_query's widths
    return svc


def phase_reliability(torch, clean, rec):
    """§8's stream under TRA reliability (vote; ECC at P and at 0), on
    phase 3a's catalog vectors, against 3a's clean results."""
    from repro_torch.core import errors, lowering
    from repro_torch.kernels import LAUNCHES

    base, queries, mat = clean["svc"], clean["queries"], clean["mat"]
    for p in RELIABILITY_P:
        model = errors.TRAErrorModel(p_flip=p)
        bound, flips = _double_fault_bits(base, (queries, mat), model)
        print(f"[reliability] P = {p:g}: expected output bits wrong in two "
              f"of three replicas <= {bound:.3e} (limit "
              f"{DOUBLE_FAULT_LIMIT:g}); faults injected per replica of "
              f"every group <= {flips:.1f}")
        if bound < DOUBLE_FAULT_LIMIT:
            break
    check(bound < DOUBLE_FAULT_LIMIT,
          f"no flip rate in {RELIABILITY_P} keeps double faults under "
          f"{DOUBLE_FAULT_LIMIT:g}")
    configs = {
        "vote": errors.ReliabilityConfig("vote", k=3, model=model, seed=13),
        "ecc": errors.ReliabilityConfig("ecc", model=model, seed=13),
        "ecc p=0": errors.ReliabilityConfig(
            "ecc", model=errors.TRAErrorModel(p_flip=0.0), seed=13)}
    services = {name: _service_like(base, rel)
                for name, rel in configs.items()}
    torch.cuda.synchronize()

    LAUNCHES.clear()
    rec.only, rec.faulty = {"majority"}, True
    t0 = time.perf_counter()
    reports, walls = {}, {}
    for name, svc in services.items():
        rec.stage = f"reliability {name}"
        t1 = time.perf_counter()
        reports[name] = (svc.query_batch(queries), svc.query_batch(mat))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
    t_path = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rec.stage = rec.only = None
    rec.faulty = False
    print(f"[reliability] launches while the mitigated stream ran: "
          f"{launches}")
    for name in RELIABILITY_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the mitigated path")

    stats = {}
    for name, (rep, rep_mat) in reports.items():
        check([r.scalar for r in rep.results] == clean["scalars"],
              f"{name}: a mitigated scalar differs from the clean run")
        for got, want in zip(rep_mat.results, clean["mat_values"]):
            check(np.array_equal(got.value, want),
                  f"{name}: materialize query {got.index} differs from "
                  "the clean run")
        st = services[name].stats()
        stats[name] = {k: st[k] for k in (
            "parity_checks", "reliability_replicas", "ecc_tiebreaks",
            "tra_corrected_bits", "batches")}
        stats[name]["wall_s"] = walls[name]
        stats[name]["modeled_ns"] = rep.makespan_ns
        stats[name]["plan_groups"] = rep.n_plan_groups + \
            rep_mat.n_plan_groups
        print(f"[reliability] {name}: {stats[name]}")
    vote, ecc, ecc0 = (stats[n] for n in configs)
    check(vote["tra_corrected_bits"] > 0 and vote["ecc_tiebreaks"] == 0,
          f"vote at P: {vote}")
    check(ecc["ecc_tiebreaks"] > 0 and ecc["tra_corrected_bits"] > 0,
          f"ecc at P broke no tie: {ecc}")
    check(ecc0["ecc_tiebreaks"] == 0 and ecc0["tra_corrected_bits"] == 0
          and ecc0["reliability_replicas"] == 2 * ecc0["plan_groups"],
          f"ecc at 0: {ecc0}")
    for name in ("ecc", "ecc p=0"):
        check(stats[name]["parity_checks"] == stats[name]["batches"] == 2,
              f"{name}: {stats[name]['parity_checks']} parity checks over "
              f"{stats[name]['batches']} batches")

    # faults really land: the group with the most expected faults, run
    # once with injection, differs from its clean run
    svc = services["vote"]
    members = max((m for m in _plan_groups(svc, queries)
                   if m[0].plan.lowered is not None),
                  key=lambda m: len(m) * float(model.flip_probs(
                      m[0].plan.lowered.table).max(axis=1).sum()))
    plan = members[0].plan
    rows = [bp.input_map() for bp in members]
    data = {n: [svc.catalog.get(r[n]).words for r in rows] for n in rows[0]}
    outs = list(plan.outputs)
    hit = errors.execute_injected(plan.lowered, data, outs, model=model,
                                  key=(13, 10 ** 6))
    ref = lowering.execute_lowered(plan.lowered, data, outputs=outs)
    differ = sum(int((hit[o] != ref[o]).sum()) for o in outs)
    check(differ > 0, "an injected group run equals its clean run")
    # a corrupted catalog word stops the ECC service
    svc = services["ecc"]
    entry = svc.catalog.get(svc.catalog.names()[0])
    saved = entry.words
    entry.words = saved.clone()
    entry.words[0] ^= 1
    try:
        svc.query_batch(queries[:1])
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        entry.words = saved
    check("parity" in raised, f"a corrupted catalog word gave {raised!r}")
    print(f"[reliability] {len(queries)} scalars and {len(mat)} "
          f"materialized results equal the clean run under vote, ECC at "
          f"P and ECC at 0; one injected {len(members)}-query group alone "
          f"differs from its clean run in {differ} words; a corrupted "
          f"catalog word raised ({raised[:40]}...); the mitigated runs "
          f"took {t_path:.2f} s wall")
    return launches, {"reliability_wall_s": t_path,
                      "reliability_p_flip": model.p_flip,
                      "double_fault_bound": bound,
                      "faults_per_replica_bound": flips,
                      "reliability": stats}


#: §8.2's scale: two columns, a ragged count (sentinel tail)
ARITH_VALUES = (1 << 25) - 7
#: the column widths (arith_throughput's 8 bits, and a full word), with
#: each width's lt_const bound
ARITH_LT_CONST = {8: 100, 32: 3 << 29}


def phase_arith(torch, rec):
    """Bit-serial arithmetic at §8.2's scale through `repro_torch.ops`,
    every result against numpy on the raw values; the in-DRAM twins at 8
    bits against the fast path."""
    from repro_torch import ops
    from repro_torch.core.bitplane import to_uint32
    from repro_torch.kernels import LAUNCHES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2012)
    raw = {}
    for n_bits in ARITH_LT_CONST:
        if n_bits == 32:
            raw[n_bits] = [_draw_words(torch, gen, ARITH_VALUES)
                           for _ in range(2)]
        else:
            raw[n_bits] = [torch.randint(0, 1 << n_bits, (ARITH_VALUES,),
                                         dtype=torch.int32, generator=gen,
                                         device=dev) for _ in range(2)]
    torch.cuda.synchronize()

    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = {}
    for n_bits, (a, b) in raw.items():
        rec.stage = f"arith {n_bits} bits"
        k = ARITH_LT_CONST[n_bits]
        ca = ops.VerticalColumn.encode(a, n_bits)
        cb = ops.VerticalColumn.encode(b, n_bits)
        s, d = ops.add_columns(ca, cb), ops.sub_columns(ca, cb)
        r = {"add": s, "sub": d,
             "add_values": ops.from_vertical(s.planes, n_bits),
             "sub_values": ops.from_vertical(d.planes, n_bits),
             "lt": ops.lt_columns(ca, cb), "lt_const": ops.lt_const(ca, k),
             "sum": ops.sum_column(ca)}
        if n_bits == 8:
            for banks in (1, 8):
                rec.stage = f"arith 8 bits in-DRAM n_banks={banks}"
                r[banks] = (ops.add_columns_dram(ca, cb, n_banks=banks),
                            ops.sub_columns_dram(ca, cb, n_banks=banks),
                            ops.lt_columns_dram(ca, cb, n_banks=banks),
                            ops.lt_const_dram(ca, k, n_banks=banks),
                            ops.sum_column_dram(ca, n_banks=banks))
        out[n_bits] = r
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rec.stage = None
    print(f"[arith] launches while the arithmetic path ran: {launches}")
    for name in ARITH_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the arithmetic path")

    n = ARITH_VALUES
    for n_bits, r in out.items():
        a, b = (to_uint32(x).astype(np.int64) for x in raw[n_bits])
        mod = 1 << n_bits
        k = ARITH_LT_CONST[n_bits]
        for op, want in (("add", (a + b) % mod), ("sub", (a - b) % mod)):
            got = to_uint32(r[f"{op}_values"])[:n]
            check(np.array_equal(got, want),
                  f"{n_bits}-bit {op}: from_vertical differs from numpy")
        check(np.array_equal(to_uint32(r["lt"].words), _packed(a < b)),
              f"{n_bits}-bit lt_columns differs from numpy")
        check(np.array_equal(to_uint32(r["lt_const"].words), _packed(a < k)),
              f"{n_bits}-bit lt_const({k}) differs from numpy")
        check(r["sum"] == int(a.sum()),
              f"{n_bits}-bit sum_column {r['sum']} != numpy {int(a.sum())}")
        for banks in (1, 8):
            if banks not in r:
                continue
            add, sub, lt, ltc, total = r[banks]
            check(torch.equal(add.planes, r["add"].planes)
                  and torch.equal(sub.planes, r["sub"].planes)
                  and torch.equal(lt.words, r["lt"].words)
                  and torch.equal(ltc.words, r["lt_const"].words)
                  and total == r["sum"],
                  f"in-DRAM twins at n_banks={banks} differ from the fast "
                  "path")
    print(f"[arith] add, sub (through from_vertical), lt_columns, lt_const "
          f"and sum_column over {n} values at {list(out)} bits equal "
          f"numpy (sum at 32 bits {out[32]['sum']}); the 8-bit in-DRAM "
          f"twins at 1 and 8 banks equal the fast path; the path took "
          f"{t_path:.2f} s wall")
    return launches, {"arith_wall_s": t_path}


#: phase 3e: the published architecture, batch, prompt and new tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW, LM_SEED = "qwen3_0p6b", 8, 2048, 32, 14
#: checks (i) and (ii): the largest logit difference as a share of the
#: largest logit, the bound the JAX package holds bf16 decode to prefill
#: with (tests/test_models.py); both sides are bf16 pipelines whose
#: roundings may land the other way at some cast point
LM_TOL = 0.05


def _max_rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-9))


def _device_ms_by_kind(prof, backward: bool = False):
    """(device ms by kind, device events) of a profiled run: the flash
    forward kernel, with ``backward`` the flash backward kernels, the
    float32 flash kernels' pre-pass (where it ran), cuBLAS GEMMs,
    everything else (elementwise passes, reductions, copies); the events
    count kernels and copies. The device rows that mirror the program's
    spans (profiler ranges, `repro_torch.obs`) are work, not device
    activity, and are left out."""
    from torch.autograd import DeviceType

    out = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    if backward:
        out["flash_attention_bwd"] = 0.0
    n_events = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        n_events += 1
        name = e.name
        if "flash_fwd_" in name or "flash_mma_kernel" in name:
            kind = "flash_attention"
        elif "tf32_split_kernel" in name:
            kind = "flash_tf32_split"
            out.setdefault(kind, 0.0)
        elif backward and "flash_bwd_" in name:
            kind = "flash_attention_bwd"
        elif "gemm" in name.lower() or "xmma" in name \
                or name.startswith(("nvjet", "cutlass")):
            kind = "gemm"
        else:
            kind = "other"
        out[kind] += e.time_range.elapsed_us() / 1e3
    return out, n_events


def phase_lm(torch, rec):
    """The LM serving path at Qwen3-0.6B's published widths through
    ``build -> init -> generate`` on the card, with its checks."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flashattn
    from repro_torch.models import build
    from repro_torch.serve import cache_bytes, extend_cache, generate

    cfg = get_config(LM_ARCH)
    bundle = build(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=bundle.device).manual_seed(LM_SEED)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                            generator=gen, device=bundle.device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(next(params.parameters()).dtype == torch.bfloat16
          and bundle.device.type == "cuda",
          f"{cfg.name} is not in bf16 on the card")

    # the user's entry point, with its prefill timed and every logit it
    # produces checked for finiteness on the device
    seen = {"finite": torch.ones((), dtype=torch.bool,
                                 device=bundle.device)}

    def prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = bundle.prefill(p, batch)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t
        seen["logits"] = logits
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    def decode_step(p, token, cache, pos):
        logits, cache = bundle.decode_step(p, token, cache, pos)
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    served = dataclasses.replace(bundle, prefill=prefill,
                                 decode_step=decode_step)
    batch = {"tokens": prompts[:, :LM_PROMPT]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only = "lm prefill", {"flash_attention"}
    t0 = time.perf_counter()
    toks = generate(served, params, batch, LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t_prefill = seen["prefill_s"]       # the warm run below overwrites it
    launches = dict(LAUNCHES)
    rec.stage = rec.only = None
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] launches while generate ran: {launches}")
    for name in LM_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the serving path")
    n_flash = launches.get("flash_attention", 0)
    check(n_flash == cfg.n_layers,
          f"{n_flash} flash launches in a {cfg.n_layers}-layer prefill")

    # (iii) ids and logits
    check(tuple(toks.shape) == (LM_BATCH, LM_NEW) and toks.is_cuda
          and toks.dtype == torch.int32, f"generate gave {tuple(toks.shape)} "
          f"{toks.dtype} on {toks.device}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.padded_vocab,
          f"ids outside [0, {cfg.padded_vocab})")
    check(bool(seen["finite"]), "a logit of the serving path is not finite")
    check(torch.equal(toks[:, 0], seen["logits"].argmax(-1).to(torch.int32)),
          "the first id is not the prefill's argmax")
    # (i) the same prefill with the plain attention swapped in
    kernel_logits = seen.pop("logits")
    saved = flashattn.flash_attention_kernel

    def plain(q, k, v, causal=True, block_q=512, block_k=512):
        return flashattn.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            block_q, block_k).transpose(1, 2)

    flashattn.flash_attention_kernel = plain
    try:
        plain_logits, _ = bundle.prefill(params, batch)
    finally:
        flashattn.flash_attention_kernel = saved
    err_plain = _max_rel(kernel_logits, plain_logits)
    check(err_plain < LM_TOL, f"prefill with the kernel vs the plain "
          f"attention: {err_plain:.3g} of the largest logit (>= {LM_TOL})")
    # (ii) prefill(S) + decode_step == prefill(S + 1)
    want, _ = bundle.prefill(params, {"tokens": prompts})
    _, cache = bundle.prefill(params, batch)
    kv_bytes = cache_bytes(cache)
    got, _ = bundle.decode_step(params, prompts[:, LM_PROMPT],
                                extend_cache(cache, 1), LM_PROMPT)
    err_decode = _max_rel(got, want)
    check(err_decode < LM_TOL, f"prefill(S) + decode_step vs prefill(S + "
          f"1): {err_decode:.3g} of the largest logit (>= {LM_TOL})")
    check(bool(torch.isfinite(want).all() and torch.isfinite(got).all()),
          "non-finite logits in check (ii)")
    del cache, got, want, kernel_logits, plain_logits
    # warm: the same call again, timed; then one prefill and one decode
    # step under the profiler, for their device time by kind (the idle
    # share is that time's complement in the warm run's walls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(served, params, batch, LM_NEW)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm = {"prefill": seen["prefill_s"] * 1e3,
            "decode step": (t_warm - seen["prefill_s"]) / (LM_NEW - 1) * 1e3}
    check(bool(seen["finite"]), "a logit of the warm run is not finite")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        logits, cache = bundle.prefill(params, batch)
        torch.cuda.synchronize()
    device, events = {}, {}
    device["prefill"], events["prefill"] = _device_ms_by_kind(prof)
    cache = extend_cache(cache, 1)
    with torch.profiler.profile(activities=activities) as prof:
        bundle.decode_step(params, logits.argmax(-1), cache, LM_PROMPT)
        torch.cuda.synchronize()
    device["decode step"], events["decode step"] = _device_ms_by_kind(prof)
    del params, cache, logits
    decode_ms = (t_gen - t_prefill) / (LM_NEW - 1) * 1e3
    info = {"lm_arch": cfg.name, "lm_params": n_params,
            "lm_init_s": t_init, "lm_generate_s": t_gen,
            "lm_prefill_s": t_prefill, "lm_decode_ms": decode_ms,
            "lm_tok_per_s": LM_BATCH * LM_NEW / t_gen,
            "lm_prefill_tok_per_s": LM_BATCH * LM_PROMPT / t_prefill,
            "lm_peak_device_bytes": peak, "lm_kv_cache_bytes": kv_bytes,
            "lm_err_plain_attention": err_plain,
            "lm_err_decode_vs_prefill": err_decode,
            "lm_warm_generate_s": t_warm, "lm_warm_ms": warm,
            "lm_device_ms": device, "lm_device_events": events}
    print(f"[lm] {cfg.name} at its published widths: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab "
          f"{cfg.padded_vocab} padded, {n_params / 1e9:.3f} B parameters "
          f"in bf16 (init {t_init:.2f} s)")
    print(f"[lm] cold generate: {LM_BATCH} prompts of {LM_PROMPT} ids, "
          f"{LM_NEW} new, greedy: {t_gen:.3f} s wall, prefill "
          f"{t_prefill * 1e3:.1f} ms "
          f"({info['lm_prefill_tok_per_s']:.0f} prompt tok/s), "
          f"{decode_ms:.2f} ms per decode step (the cache extension "
          f"included), {info['lm_tok_per_s']:.1f} generated tok/s; peak "
          f"device memory {peak / 2**30:.2f} GiB (KV cache at S "
          f"{kv_bytes / 2**30:.2f} GiB)")
    print(f"[lm] warm generate: {t_warm:.3f} s wall")
    for part, wall_ms in warm.items():
        busy = sum(device[part].values())
        print(f"[lm] warm {part}: {wall_ms:.2f} ms wall; device "
              + (f"{busy:.2f} ms over {events[part]} kernels and copies "
                 f"(torch.profiler: "
                 + ", ".join(f"{k} {v:.2f}" for k, v in device[part].items())
                 + f"), idle {1 - busy / wall_ms:.1%} of the wall"
                 if busy else "time not measured (the profiler saw no "
                 "device events)"))
    print(f"[lm] (i) kernel vs plain attention {err_plain:.3g}, (ii) "
          f"decode vs prefill {err_decode:.3g} of the largest logit "
          f"(bound {LM_TOL}); (iii) ids {tuple(toks.shape)} in range, "
          f"every logit finite")
    return launches, info


#: phase 3f: the published architecture at train_4k's sequence length;
#: the global batch is cut from train_4k's 256 to 8 for time, in four
#: microbatches of 2: with microbatches of 4 the float32 logits (4 x 4,096
#: x 153,600, 10 GB) and their gradients ran the card out of memory
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = "qwen3_0p6b", 4096, 8, 4
TRAIN_SEED, TRAIN_STEPS = 15, 6
#: AdamW's schedule: a warm-up of two steps to 1e-3, cosine over 100
TRAIN_LR = (1e-3, 2, 100)
#: check (ii): each gradient leaf's RMS difference from the step with the
#: plain attention, as a share of the plain leaf's RMS (bf16 activations
#: through 28 layers; the kernels round p and ds to bf16 for their
#: products where the plain backward keeps float32), and the loss's
#: relative difference
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL = 0.05, 1e-3
#: check (iv): grad_accum 2 against 1 on the same batch, the JAX
#: package's bound (tests/test_optim_train.py)
TRAIN_ACCUM_TOL = 5e-3


def _plain_attention(flashattn, block=None):
    """Model-layout adapters of the plain forward-with-lse and backward,
    to swap in for the kernel wrappers; ``block`` (if given) replaces the
    caller's query and key blocks."""

    def fwd(q, k, v, causal=True, block_q=512, block_k=512):
        bq, bk = (block, block) if block else (block_q, block_k)
        o, lse = flashattn.flash_attention_fwd_plain(
            _hm(q), _hm(k), _hm(v), causal, bq, bk)
        return _hm(o), lse

    def bwd(q, k, v, o, lse, do, causal=True, block_q=512, block_k=512):
        bq, bk = (block, block) if block else (block_q, block_k)
        return tuple(_hm(g) for g in flashattn.flash_attention_bwd_plain(
            _hm(q), _hm(k), _hm(v), _hm(o), lse, _hm(do), causal, bq, bk))

    return fwd, bwd


#: the most elements `_rel_rms` takes in float32 at once
REL_RMS_SLICE = 1 << 26


def _rel_rms(got, want) -> float:
    """RMS of ``got - want`` over the RMS of ``want``, summed in float32
    slices along the leading axis (so a 10 GB expert weight takes no
    whole float32 copy); ``want`` may lie on the host."""
    rows = max(1, REL_RMS_SLICE // max(1, got[0].numel())) \
        if got.dim() else 1
    num = den = 0.0
    for i in (range(0, got.shape[0], rows) if got.dim() else [None]):
        part = (slice(i, i + rows),) if i is not None else ()
        g = got[part].float()
        w = want[part].to(got.device).float()
        num += float((g - w).pow(2).sum())
        den += float(w.pow(2).sum())
    return (num / max(den, 1e-60)) ** 0.5


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_train(torch, rec):
    """Training at Qwen3-0.6B's published widths through ``build -> init
    -> make_train_step`` (AdamW, ``warmup_cosine``, ``remat="block"``,
    the port's `SyntheticLM`), and the compressed signum step on a
    one-rank NCCL group, with their checks."""
    import copy

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES, flashattn
    from repro_torch.models import build
    from repro_torch.optim import adamw, signum, warmup_cosine
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.train import (make_train_step,
                                   make_train_step_compressed)
    from repro_torch.train.step import loss_and_grads

    torch.cuda.empty_cache()         # the earlier phases' cached blocks
    cfg = get_config(TRAIN_ARCH)
    bundle = build(cfg, remat="block")
    gen = torch.Generator(device=bundle.device).manual_seed(TRAIN_SEED)
    params = bundle.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                       seed=TRAIN_SEED)
    batch = data.batch(0)
    check(batch["tokens"].is_cuda and next(params.parameters()).dtype
          == torch.bfloat16, f"{cfg.name} is not in bf16 on the card")
    opt = adamw(warmup_cosine(*TRAIN_LR))
    state = opt.init(params)
    step_fn = make_train_step(bundle, opt, grad_accum=TRAIN_ACCUM)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_micro = TRAIN_ACCUM * cfg.n_layers

    # the main path: the cold first step, every launch recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only = "train step", set(TRAIN_KERNELS)
    t0 = time.perf_counter()
    params, state, metrics = step_fn(params, state, 0, batch)
    losses = [float(metrics["loss"])]
    t_cold = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rec.stage = rec.only = None
    print(f"[train] launches in the first step: {launches}")
    want = {"flash_attention_fwd": 2 * n_micro,
            "flash_attention_bwd": n_micro}
    check({k: v for k, v in launches.items() if v} == want,
          f"the step launched {launches}, not {want}: per layer and "
          f"microbatch the lse forward twice (the forward and the "
          f"checkpointed block's recompute) and the backward once")
    # the flash FLOPs of every microbatch's launches, which 3q(b)'s count
    # of the step on meta must charge
    flash_flops = sum(flashattn.flash_cost(kind, args[0], args[1],
                                           kw.get("causal", True))[0]
                      for kind, args, kw, stage in rec.calls
                      if stage == "train step")
    # (i) the first loss
    ln_v = float(np.log(cfg.padded_vocab))
    check(np.isfinite(losses[0]) and abs(losses[0] - ln_v) < 0.1 * ln_v,
          f"first loss {losses[0]:.4f} is not within 10% of ln "
          f"{cfg.padded_vocab} = {ln_v:.4f}")
    # (iii) six steps on the one batch lower the loss; the warm ones timed
    warm = []
    for i in range(1, TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, i, batch)
        losses.append(float(metrics["loss"]))
        warm.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    held = rec.held_bytes()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{TRAIN_STEPS} steps on one batch did not lower the loss: "
          f"{losses}")
    t_warm = float(np.mean(warm[1:]))
    # the device's split of one more warm step
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, TRAIN_STEPS, batch)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    device, events = _device_ms_by_kind(prof, backward=True)
    del prof, state, opt, step_fn

    # (ii) loss and gradients against the plain attention swapped in
    loss_k, _, grads_k = loss_and_grads(bundle, params, batch, TRAIN_ACCUM)
    saved = (flashattn.flash_attention_fwd_kernel,
             flashattn.flash_attention_bwd_kernel)
    flashattn.flash_attention_fwd_kernel, \
        flashattn.flash_attention_bwd_kernel = _plain_attention(flashattn)
    try:
        loss_p, _, grads_p = loss_and_grads(bundle, params, batch,
                                            TRAIN_ACCUM)
    finally:
        flashattn.flash_attention_fwd_kernel, \
            flashattn.flash_attention_bwd_kernel = saved
    err_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    err_grad = {n: _rel_rms(grads_k[n], grads_p[n]) for n in grads_p}
    worst_leaf = max(err_grad, key=err_grad.get)
    check(err_loss < TRAIN_LOSS_TOL, f"loss with the kernels vs the plain "
          f"attention: {err_loss:.3g} relative (>= {TRAIN_LOSS_TOL})")
    check(err_grad[worst_leaf] < TRAIN_GRAD_TOL, f"gradient {worst_leaf} "
          f"with the kernels vs the plain attention: RMS difference "
          f"{err_grad[worst_leaf]:.3g} of its RMS (>= {TRAIN_GRAD_TOL})")
    del grads_k, grads_p
    # (iv) grad_accum 2 against 1 on the same batch: one main-path
    # microbatch, so the single microbatch stays the main path's size
    half = {k: x[:TRAIN_BATCH // TRAIN_ACCUM] for k, x in batch.items()}
    loss_2, _, g2 = loss_and_grads(bundle, params, half, 2)
    del g2
    loss_1, _, g1 = loss_and_grads(bundle, params, half, 1)
    del g1
    err_accum = abs(float(loss_2) - float(loss_1))
    check(err_accum < TRAIN_ACCUM_TOL, f"grad_accum 2 vs 1: losses "
          f"{float(loss_2):.5f} and {float(loss_1):.5f} differ by "
          f"{err_accum:.3g} (>= {TRAIN_ACCUM_TOL})")

    # (v) the compressed step on a one-rank NCCL group against the local
    # signum step with the same gradients
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1)
    try:
        group = dist.group.WORLD
        voted = signum(warmup_cosine(*TRAIN_LR), group=group)
        local = signum(warmup_cosine(*TRAIN_LR))
        seen = {}

        def update(grads, state, params, step):
            seen["grads"] = {k: g.clone() for k, g in grads.items()}
            return voted.update(grads, state, params, step)

        twin = copy.deepcopy(params)
        comp = make_train_step_compressed(
            bundle, Optimizer(voted.init, update, voted.name), group,
            grad_accum=TRAIN_ACCUM)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        rec.stage, rec.only = "compressed step", {"pack_signs",
                                                  "unpack_signs"}
        t0 = time.perf_counter()
        params, _, cm = comp(params, voted.init(params), TRAIN_STEPS + 1,
                             batch)
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        comp_launches = dict(LAUNCHES)
        rec.stage = rec.only = None
    finally:
        dist.destroy_process_group()
    print(f"[train] launches in the compressed step: {comp_launches}")
    want = {"flash_attention_fwd": 2 * n_micro,
            "flash_attention_bwd": n_micro, "pack_signs": 1,
            "unpack_signs": 1, "majority": 1}
    check({k: v for k, v in comp_launches.items() if v} == want,
          f"the compressed step launched {comp_launches}, not {want}")
    local.update(seen["grads"], local.init(twin), twin, TRAIN_STEPS + 1)
    twins = dict(twin.named_parameters())
    n_diff = n_signless = 0
    for name, p in params.named_parameters():
        g = seen["grads"][name].float()
        free = (g == 0) | torch.isnan(g)        # u = g at the first step
        diff = p.detach() != twins[name].detach()
        n_diff += int((diff & ~free).sum())
        n_signless += int(free.sum())
    check(n_diff == 0, f"the compressed step differs from the local signum "
          f"step on {n_diff} elements whose u is not +-0 or NaN")
    del twin, twins, seen, params
    for n, c in comp_launches.items():
        launches[n] = launches.get(n, 0) + c
    info = {"train_arch": cfg.name, "train_params": n_params,
            "train_tokens_per_step": tokens, "train_cold_s": t_cold,
            "train_warm_s": t_warm, "train_warm_steps_s": warm,
            "train_tok_per_s": tokens / t_warm, "train_losses": losses,
            "train_peak_device_bytes": peak, "train_recorded_bytes": held,
            "train_profiled_step_s": t_prof, "train_device_ms": device,
            "train_device_events": events,
            "train_err_plain_loss": err_loss,
            "train_err_plain_grad": err_grad[worst_leaf],
            "train_err_plain_grad_leaf": worst_leaf,
            "train_err_accum": err_accum, "train_compressed_s": t_comp,
            "train_flash_flops": flash_flops,
            "train_compressed_loss": float(cm["loss"]),
            "train_signless_elements": n_signless}
    busy = sum(device.values())
    print(f"[train] {cfg.name} at its published widths: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab "
          f"{cfg.padded_vocab} padded, {n_params / 1e9:.3f} B parameters "
          f"in bf16; AdamW, remat 'block', sequence {TRAIN_SEQ}, global "
          f"batch {TRAIN_BATCH} in {TRAIN_ACCUM} microbatches (cut from "
          f"train_4k's 256 for time; microbatch halved from 4 for "
          f"memory)")
    print(f"[train] step ms: cold {t_cold * 1e3:.1f}, warm "
          f"{t_warm * 1e3:.1f} (mean of steps 2-{TRAIN_STEPS - 1}; "
          f"{', '.join(f'{w * 1e3:.1f}' for w in warm)}); "
          f"{tokens / t_warm:.0f} tok/s; peak device memory "
          f"{peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB hold "
          f"the recorded launches' arguments for phase 4")
    print(f"[train] losses over {TRAIN_STEPS} steps on one batch: "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" (ln V = {ln_v:.4f})")
    print(f"[train] warm step under the profiler: {t_prof * 1e3:.1f} ms "
          f"wall; device "
          + (f"{busy:.1f} ms over {events} kernels and copies ("
             + ", ".join(f"{k} {v:.1f}" for k, v in device.items())
             + f"), idle {1 - busy / (t_prof * 1e3):.1%} of the wall "
             f"(the profiler's own host work included; against the "
             f"unprofiled warm step, {1 - busy / (t_warm * 1e3):.1%})"
             if busy else "time not measured (the profiler saw no device "
             "events)"))
    print(f"[train] (ii) kernels vs plain attention: loss {err_loss:.3g} "
          f"relative, worst gradient leaf {worst_leaf} RMS difference "
          f"{err_grad[worst_leaf]:.3g} of its RMS (bounds "
          f"{TRAIN_LOSS_TOL}, {TRAIN_GRAD_TOL}); (iv) grad_accum 2 vs 1 "
          f"loss {err_accum:.3g} (bound {TRAIN_ACCUM_TOL}); (v) compressed "
          f"step on one NCCL rank: {t_comp * 1e3:.1f} ms, equal to the "
          f"local signum step on every element but the {n_signless} whose "
          f"u is +-0 or NaN")
    return launches, info


# ---------------------------------------------------------------------------
# phase 3s: Qwen3-0.6B in float32
# ---------------------------------------------------------------------------

#: phase 3s: Qwen3-0.6B at its published widths and depth with ``dtype``
#: float32, served on 3e's traffic and trained at 3f's sequence and global
#: batch in the fewest microbatches that fit: two of 4 (the phase prints
#: the step's peak; float32 takes some 12 GiB a sequence of activations
#: and logits beside 11 GiB of weights, gradients and AdamW's moments, so
#: one microbatch of 8 would need about 110 GiB); AdamW on 3l-3n's
#: schedule, whose first step runs at rate 0 and so leaves the initial
#: weights
F32_ACCUM = 2
#: the CPU tests' float32 model tolerance (tests/test_torch_models.py):
#: the prefill logits within this share of their largest magnitude, the
#: first loss and every gradient leaf's RMS difference within it of the
#: plain attention's (both sides float32: only the sums' order differs)
F32_TOL = 1e-4
#: launches of each kind that phase 4 replays: each run's flash launches
#: share one shape
F32_REPLAYS = 2


def phase_f32(torch, rec):
    """Qwen3-0.6B in float32 on the card through the user's entry points:
    (a) ``generate`` on 3e's traffic, its greedy ids equal to those of
    the same model with the plain attention swapped in and its prefill
    logits within `F32_TOL` of theirs; (b) ``make_train_step`` at 3f's
    shape, the first loss and every gradient leaf within `F32_TOL` of the
    plain attention's. Each run's exact flash launches, cold and warm
    walls, tok/s, peak memory and a profiled run's device ms by kind with
    its idle share are printed; `F32_REPLAYS` launches of each kind are
    kept for phase 4."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES, flashattn
    from repro_torch.models import build
    from repro_torch.models.layers import INIT_STD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.serve import generate
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]

    # (a) serving
    bundle = build(cfg)
    gen = torch.Generator(device=bundle.device).manual_seed(LM_SEED)
    params = bundle.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    check(all(p.dtype == torch.float32 for p in params.parameters())
          and bundle.device.type == "cuda",
          f"{cfg.name} is not in float32 on the card")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (LM_BATCH, LM_PROMPT), generator=gen,
                                     device=bundle.device)}
    seen = {}

    def prefill(p, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = bundle.prefill(p, b)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t
        seen["logits"] = logits
        return logits, cache

    served = dataclasses.replace(bundle, prefill=prefill)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only, rec.limit = "f32 lm prefill", set(LM_KERNELS), \
        F32_REPLAYS
    t0 = time.perf_counter()
    toks = generate(served, params, batch, LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    rec.stage = rec.only = rec.limit = None
    serve_launches = dict(LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated()
    t_prefill, kernel_logits = seen["prefill_s"], seen.pop("logits")
    check({k: v for k, v in serve_launches.items() if v}
          == {"flash_attention": cfg.n_layers},
          f"generate launched {serve_launches}, not one flash forward per "
          f"prefill layer ({cfg.n_layers})")
    check(bool(torch.isfinite(kernel_logits).all()),
          "a float32 prefill logit is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(served, params, batch, LM_NEW)
    torch.cuda.synchronize()
    t_gen_warm = time.perf_counter() - t0
    t_prefill_warm = seen["prefill_s"]
    with torch.profiler.profile(activities=activities) as prof:
        bundle.prefill(params, batch)
        torch.cuda.synchronize()
    serve_device, serve_events = _device_ms_by_kind(prof)
    del prof
    # the same generate with the plain attention swapped in
    saved = flashattn.flash_attention_kernel
    flashattn.flash_attention_kernel = \
        lambda q, k, v, causal=True, block_q=512, block_k=512: _hm(
            flashattn.flash_attention_plain(_hm(q), _hm(k), _hm(v), causal,
                                            block_q, block_k))
    try:
        toks_plain = generate(served, params, batch, LM_NEW)
    finally:
        flashattn.flash_attention_kernel = saved
    err_logits = _max_rel(kernel_logits, seen.pop("logits"))
    check(err_logits <= F32_TOL, f"float32 prefill logits, kernel vs plain "
          f"attention: {err_logits:.3g} of the largest (> {F32_TOL})")
    n_same = int((toks == toks_plain).sum())
    check(n_same == toks.numel(), f"float32 greedy ids: {n_same} of "
          f"{toks.numel()} equal the plain attention's")
    del params, kernel_logits, toks, toks_plain
    torch.cuda.empty_cache()
    serve = {"params": n_params, "generate_s": t_gen,
             "warm_generate_s": t_gen_warm, "prefill_s": t_prefill,
             "warm_prefill_s": t_prefill_warm,
             "prefill_tok_per_s": LM_BATCH * LM_PROMPT / t_prefill_warm,
             "tok_per_s": LM_BATCH * LM_NEW / t_gen_warm,
             "peak_device_bytes": serve_peak, "err_plain_logits": err_logits,
             "device_ms": serve_device, "device_events": serve_events,
             "launches": serve_launches}

    # (b) training
    bundle = build(cfg, remat="block")
    params = bundle.init(torch.Generator(device=bundle.device)
                         .manual_seed(TRAIN_SEED))
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=TRAIN_SEED).batch(0)
    opt = adamw(warmup_cosine(*TRAIN_FAMILY_LR))
    state = opt.init(params)
    calls = []

    def loss(p, b):
        # phase 4 replays launches of the first microbatch only
        calls.append(None)
        if len(calls) > 1:
            rec.stage = None
        return bundle.loss(p, b)

    step_fn = make_train_step(dataclasses.replace(bundle, loss=loss), opt,
                              grad_accum=F32_ACCUM)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only, rec.limit = "f32 train step", set(TRAIN_KERNELS), \
        F32_REPLAYS
    t0 = time.perf_counter()
    params, state, metrics = step_fn(params, state, 0, batch)
    losses = [float(metrics["loss"])]
    t_cold = time.perf_counter() - t0
    rec.stage = rec.only = rec.limit = None
    train_launches = dict(LAUNCHES)
    cold_peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_fwd": 2 * cfg.n_layers * F32_ACCUM,
            "flash_attention_bwd": cfg.n_layers * F32_ACCUM}
    check({k: v for k, v in train_launches.items() if v} == want,
          f"the float32 step launched {train_launches}, not {want}: per "
          f"layer and microbatch the lse forward twice (the forward and the "
          f"checkpointed block's recompute) and the backward once")
    ln_v = float(np.log(cfg.padded_vocab))
    want_loss = ln_v + INIT_STD ** 2 * cfg.d_model / 2
    check(np.isfinite(losses[0])
          and abs(losses[0] - want_loss) < 0.1 * want_loss,
          f"float32 first loss {losses[0]:.4f} is not within 10% of "
          f"{want_loss:.4f}")
    # the first step (at rate 0: the initial weights) against the plain
    # attention swapped in
    loss_k, _, grads_k = loss_and_grads(bundle, params, batch, F32_ACCUM)
    saved = (flashattn.flash_attention_fwd_kernel,
             flashattn.flash_attention_bwd_kernel)
    flashattn.flash_attention_fwd_kernel, \
        flashattn.flash_attention_bwd_kernel = _plain_attention(flashattn)
    try:
        loss_p, _, grads_p = loss_and_grads(bundle, params, batch,
                                            F32_ACCUM)
    finally:
        flashattn.flash_attention_fwd_kernel, \
            flashattn.flash_attention_bwd_kernel = saved
    err_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    err_grad = {n: _rel_rms(grads_k[n], grads_p[n]) for n in grads_p}
    worst_leaf = max(err_grad, key=err_grad.get)
    del grads_k, grads_p
    check(err_loss <= F32_TOL, f"float32 loss, kernels vs plain attention: "
          f"{err_loss:.3g} relative (> {F32_TOL})")
    check(err_grad[worst_leaf] <= F32_TOL, f"float32 gradient {worst_leaf}, "
          f"kernels vs plain attention: RMS difference "
          f"{err_grad[worst_leaf]:.3g} of its RMS (> {F32_TOL})")
    torch.cuda.reset_peak_memory_stats()     # the steps' peak, not the check's
    warm = []
    for i in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, i, batch)
        losses.append(float(metrics["loss"]))
        warm.append(time.perf_counter() - t0)
    train_peak = max(cold_peak, torch.cuda.max_memory_allocated())
    check(all(np.isfinite(losses)), f"float32 losses {losses}")
    # the device's split of one more warm step, device events only (as
    # 3l-3n's)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, 3, batch)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    train_device, train_events = _device_ms_by_kind(prof, backward=True)
    del prof, params, state, opt, step_fn
    torch.cuda.empty_cache()
    t_warm = float(np.mean(warm))
    train = {"tokens_per_step": tokens, "microbatches": F32_ACCUM,
             "cold_s": t_cold, "warm_s": t_warm, "warm_steps_s": warm,
             "tok_per_s": tokens / t_warm, "losses": losses,
             "peak_device_bytes": train_peak, "err_plain_loss": err_loss,
             "err_plain_grad": err_grad[worst_leaf],
             "err_plain_grad_leaf": worst_leaf, "profiled_step_s": t_prof,
             "device_ms": train_device, "device_events": train_events,
             "launches": train_launches}

    print(f"[3s] {cfg.name} in float32 at its published widths: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab "
          f"{cfg.padded_vocab} padded, {n_params / 1e9:.3f} B parameters "
          f"({4 * n_params / 2**30:.2f} GiB)")
    print(f"[3s] (a) generate, {LM_BATCH} prompts of {LM_PROMPT} ids, "
          f"{LM_NEW} new, greedy: flash launches {serve_launches} (one a "
          f"prefill layer); cold {t_gen:.3f} s wall (prefill "
          f"{t_prefill * 1e3:.1f} ms), warm {t_gen_warm:.3f} s (prefill "
          f"{t_prefill_warm * 1e3:.1f} ms, "
          f"{serve['prefill_tok_per_s']:.0f} prompt tok/s), "
          f"{serve['tok_per_s']:.1f} generated tok/s; peak device memory "
          f"{serve_peak / 2**30:.2f} GiB")
    busy = sum(serve_device.values())
    print(f"[3s] (a) warm prefill under the profiler: device "
          + (f"{busy:.2f} ms over {serve_events} kernels and copies ("
             + ", ".join(f"{k} {v:.2f}" for k, v in serve_device.items())
             + f"), idle {1 - busy / (t_prefill_warm * 1e3):.1%} of the "
             f"warm prefill's wall" if busy else "time not measured (the "
             "profiler saw no device events)"))
    print(f"[3s] (a) kernel vs plain attention: prefill logits "
          f"{err_logits:.3g} of the largest (bound {F32_TOL}); greedy ids "
          f"{n_same} of {LM_BATCH * LM_NEW} equal")
    print(f"[3s] (b) train step, AdamW, remat 'block', sequence "
          f"{TRAIN_SEQ}, global batch {TRAIN_BATCH} in {F32_ACCUM} "
          f"microbatches of {TRAIN_BATCH // F32_ACCUM} (reduced: global "
          f"batch cut from train_4k's 256 to {TRAIN_BATCH} for time; depth "
          f"and widths published): flash launches {train_launches} (per "
          f"sequence of microbatch {2 * cfg.n_layers} lse forwards and "
          f"{cfg.n_layers} backwards); cold {t_cold * 1e3:.1f} ms, warm "
          f"{t_warm * 1e3:.1f} ms ("
          + ", ".join(f"{w * 1e3:.1f}" for w in warm)
          + f"), {tokens / t_warm:.0f} tok/s; peak device memory "
          f"{train_peak / 2**30:.2f} GiB; losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    busy = sum(train_device.values())
    print(f"[3s] (b) warm step under the profiler: {t_prof * 1e3:.1f} ms "
          f"wall; device "
          + (f"{busy:.1f} ms over {train_events} kernels and copies ("
             + ", ".join(f"{k} {v:.1f}" for k, v in train_device.items())
             + f"), idle {1 - busy / (t_prof * 1e3):.1%} of its wall "
             f"(against the unprofiled warm step, "
             f"{1 - busy / (t_warm * 1e3):.1%})" if busy else "time not "
             "measured (the profiler saw no device events)"))
    print(f"[3s] (b) kernels vs plain attention: loss {err_loss:.3g} "
          f"relative, worst gradient leaf {worst_leaf} RMS difference "
          f"{err_grad[worst_leaf]:.3g} of its RMS (bound {F32_TOL})")
    launches = dict(serve_launches)
    for n, c in train_launches.items():
        launches[n] = launches.get(n, 0) + c
    return launches, {"f32_serve": serve, "f32_train": train}


# ---------------------------------------------------------------------------
# phase 3g: MoE serving
# ---------------------------------------------------------------------------

#: phase 3g: (arch, depth, seed) of the MoE models served at their
#: published widths with 3e's traffic (LM_BATCH prompts of LM_PROMPT ids,
#: LM_NEW new), each depth cut to 2 layers, one dense and one MoE: Llama-4
#: Maverick (one super-layer of the reference's scan; its 128 experts of
#: one MoE layer alone hold 32.2 GB; 18.69 B parameters, 37.4 GB) and
#: Kimi K2 (its leading dense layer and one MoE layer of all 384 experts;
#: 19.89 B parameters, 39.8 GB; head dim 112)
MOE_PHASES = (("llama4_maverick_400b_a17b", 2, 18),
              ("kimi_k2_1t_a32b", 2, 29))
MOE_ARCH = MOE_PHASES[0][0]
MOE_KERNELS = ("flash_attention",)


def phase_moe(torch, rec, arch, n_layers, seed):
    """MoE serving at ``arch``'s published widths (``n_layers`` layers)
    through ``build -> init -> generate`` on the card: the prefill's
    drops against a host recount from the router's ids, finite logits,
    ids in vocab."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import build, moe
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import generate

    published = get_config(arch).n_layers
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    check(layer_kinds(cfg) == ("dense", "moe"),
          f"{cfg.name} at {n_layers} layers is {layer_kinds(cfg)}")
    torch.cuda.empty_cache()
    bundle = build(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=bundle.device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    seen = {"finite": torch.ones((), dtype=torch.bool, device=bundle.device),
            "routed": None}

    def prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = bundle.prefill(p, batch)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t
        seen["logits"] = logits
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    def decode_step(p, token, cache, pos):
        logits, cache = bundle.decode_step(p, token, cache, pos)
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    dispatch = moe.dispatch

    def spy(idx, n_experts, capacity):
        d = dispatch(idx, n_experts, capacity)
        if seen["routed"] is not None:
            seen["routed"].append((idx, d.keep, d.counts, capacity))
        return d

    served = dataclasses.replace(bundle, prefill=prefill,
                                 decode_step=decode_step)
    batch = {"tokens": prompts}
    moe.dispatch = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        seen["routed"] = []
        rec.stage, rec.only = f"{cfg.name} prefill", {"flash_attention"}
        t0 = time.perf_counter()
        toks = generate(served, params, batch, LM_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        rec.stage = rec.only = None
        routed, seen["routed"] = seen["routed"], None
        t_prefill = seen["prefill_s"]
        peak = torch.cuda.max_memory_allocated()
        check(bool(seen["finite"]), "a logit of the MoE serving path is "
              "not finite")
        first_logits = seen.pop("logits")
        # warm: the same call again, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(served, params, batch, LM_NEW)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        t_warm_prefill = seen["prefill_s"]
        check(bool(seen["finite"]), "a logit of the warm MoE run is not "
              "finite")
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            bundle.prefill(params, batch)
            torch.cuda.synchronize()
        device, events = _device_ms_by_kind(prof)
    finally:
        moe.dispatch = dispatch
        rec.stage = rec.only = None
    print(f"[moe] {cfg.name}: launches while generate ran: {launches}")
    for name in MOE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the MoE serving path")
    n_flash = launches.get("flash_attention", 0)
    check(n_flash == cfg.n_layers,
          f"{n_flash} flash launches in a {cfg.n_layers}-layer prefill")
    check(tuple(toks.shape) == (LM_BATCH, LM_NEW) and toks.is_cuda
          and toks.dtype == torch.int32, f"generate gave {tuple(toks.shape)} "
          f"{toks.dtype} on {toks.device}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.padded_vocab,
          f"ids outside [0, {cfg.padded_vocab})")
    check(torch.equal(toks[:, 0], first_logits.argmax(-1).to(torch.int32)),
          "the first id is not the prefill's argmax")
    # the dispatch: one per MoE layer in the prefill and in each decode
    # step; its drops against a host recount from the router's ids
    check(len(routed) == LM_NEW, f"{len(routed)} MoE dispatches for one "
          f"prefill and {LM_NEW - 1} decode steps")
    T = LM_BATCH * LM_PROMPT
    C = moe.expert_capacity(cfg, T)
    for i, (idx, keep, counts, capacity) in enumerate(routed):
        n_tok = T if i == 0 else LM_BATCH
        check(tuple(idx.shape) == (n_tok, cfg.top_k)
              and capacity == moe.expert_capacity(cfg, n_tok),
              f"dispatch {i}: ids {tuple(idx.shape)}, capacity {capacity}")
        host = np.bincount(idx.cpu().numpy().reshape(-1),
                           minlength=cfg.n_experts)
        want = int(np.maximum(host - capacity, 0).sum())
        got = int((~keep).sum())
        check(got == want and np.array_equal(counts.cpu().numpy(), host),
              f"dispatch {i}: {got} slots dropped on the card, {want} by "
              f"the host's recount at capacity {capacity}")
    idx, keep, counts, _ = routed[0]
    dropped = int((~keep).sum())
    load = counts.float()
    drop_share = dropped / (T * cfg.top_k)
    decode_ms = (t_gen - t_prefill) / (LM_NEW - 1) * 1e3
    warm_decode_ms = (t_warm - t_warm_prefill) / (LM_NEW - 1) * 1e3
    busy = sum(device.values())
    info = {"arch": cfg.name, "layers": cfg.n_layers,
            "params": n_params, "weight_bytes": w_bytes,
            "init_s": t_init, "generate_s": t_gen,
            "prefill_s": t_prefill, "decode_ms": decode_ms,
            "tok_per_s": LM_BATCH * LM_NEW / t_gen,
            "prefill_tok_per_s": T / t_prefill,
            "warm_generate_s": t_warm,
            "warm_prefill_s": t_warm_prefill,
            "warm_decode_ms": warm_decode_ms,
            "warm_tok_per_s": LM_BATCH * LM_NEW / t_warm,
            "peak_device_bytes": peak, "capacity": C,
            "dropped_slots": dropped, "drop_share": drop_share,
            "load_max": float(load.max()),
            "load_mean": float(load.mean()),
            "prefill_device_ms": device,
            "prefill_device_events": events}
    print(f"[moe] {cfg.name} at its published widths, depth cut from "
          f"{published} to {cfg.n_layers} layers (one dense at d_ff "
          f"{cfg.dense_d_ff}, one "
          f"MoE: {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
          f"{cfg.top_k}, {cfg.n_shared_experts} shared): d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, vocab {cfg.padded_vocab} padded, "
          f"{n_params / 1e9:.3f} B parameters ({w_bytes / 2**30:.2f} GiB) "
          f"in bf16 (init {t_init:.2f} s)")
    print(f"[moe] {cfg.name} cold generate: {LM_BATCH} prompts of "
          f"{LM_PROMPT} ids, {LM_NEW} new, greedy: {t_gen:.3f} s wall, prefill "
          f"{t_prefill * 1e3:.1f} ms ({T / t_prefill:.0f} prompt tok/s), "
          f"{decode_ms:.2f} ms per decode step (the cache extension "
          f"included), {LM_BATCH * LM_NEW / t_gen:.1f} generated tok/s; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"[moe] {cfg.name} warm generate: {t_warm:.3f} s wall, prefill "
          f"{t_warm_prefill * 1e3:.1f} ms, {warm_decode_ms:.2f} ms per "
          f"decode step, {LM_BATCH * LM_NEW / t_warm:.1f} generated tok/s")
    print(f"[moe] {cfg.name} prefill dispatch: {T} tokens, capacity {C}: "
          f"{dropped} of {T * cfg.top_k} routed slots dropped ({drop_share:.2%}), equal "
          f"to the host's recount; expert load max {float(load.max()):.0f} "
          f"/ mean {float(load.mean()):.1f}; the {LM_NEW - 1} decode "
          f"dispatches ({LM_BATCH} tokens, capacity "
          f"{moe.expert_capacity(cfg, LM_BATCH)}) drop "
          f"{sum(int((~k).sum()) for _, k, _, _ in routed[1:])}")
    print(f"[moe] {cfg.name} warm prefill under the profiler: device "
          + (f"{busy:.2f} ms over {events} kernels and copies "
             f"(torch.profiler: "
             + ", ".join(f"{k} {v:.2f}" for k, v in device.items())
             + f"), idle {1 - busy / (t_warm_prefill * 1e3):.1%} of the "
             f"warm prefill's wall" if busy else
             "time not measured (the profiler saw no device events)"))
    del params, prof, routed, first_logits
    torch.cuda.empty_cache()
    return launches, {f"moe_{arch.split('_')[0]}_{k}": v
                      for k, v in info.items()}


# ---------------------------------------------------------------------------
# phase 3h: the paper's §3, §6.2 and §8.4 at real sizes
# ---------------------------------------------------------------------------

#: phase 3h's sizes: the reference benchmark's (benchmarks/extra_apps.py:
#: 2**23 pixels and words, 16 Bloom filters of 2**20 bits and 1,000 keys),
#: the genome raised from 100 kb to 2**24 bases so that the card does real
#: work, Monte-Carlo at 2**20 trials, bop over 8 KiB rows, the bitmap
#: filter over 2**24 documents
MC_TRIALS, MC_SIGMAS = 1 << 20, (0.06, 0.25)
BOP_ROW_BITS = 65536
PIXELS, CIPHER_WORDS, CIPHER_KEY = 1 << 23, 1 << 23, 0x1234567
GENOME, READ_LEN, READ_AT = 1 << 24, 16, 5000
BLOOM_FILTERS, BLOOM_BITS, BLOOM_KEYS, BLOOM_K = 16, 1 << 20, 1000, 4
N_DOCS = 1 << 24
PAPER_KERNELS = ("bitwise", "popcount", "bitweaving_scan", "majority",
                 "vm_materialize", "bit_transpose")
#: §6.2's bop sequence (op, dst, srcs, group of a new dst): one subarray
#: (Buddy, no PSM copy), scattered operands (Buddy with PSM copies), three
#: sources and the destination in four subarrays (the CPU path)
PAPER_BOPS = (("and", "o1", ["a", "b"], "g0"), ("or", "o2", ["a", "c"],
                                                "g3"),
              ("maj3", "o3", ["a", "c", "d"], "g4"),
              ("xnor", "o4", ["o1", "b"], "g0"),
              ("maj3", "o5", ["o1", "o2", "o3"], None))


def _np_keystream(key: int, n: int) -> np.ndarray:
    """The §8.4.2 keystream in numpy uint32 (the independent oracle)."""
    with np.errstate(over="ignore"):
        x = np.arange(n, dtype=np.uint32) + np.uint32(
            (key * 0x9E3779B9) & 0xFFFFFFFF)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x21F0AAAD)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x735A2D97)
        x ^= x >> np.uint32(15)
    return x


def _np_bloom_slots(keys: np.ndarray, k: int, m_bits: int) -> np.ndarray:
    """The §8.4.4 double hashing in numpy uint32 -> (n, k) slots."""
    with np.errstate(over="ignore"):
        h1 = keys * np.uint32(0x9E3779B1)
        h1 = (h1 ^ (h1 >> np.uint32(15))) * np.uint32(0x85EBCA77)
        h1 ^= h1 >> np.uint32(13)
        h2 = keys * np.uint32(0xC2B2AE3D)
        h2 = (h2 ^ (h2 >> np.uint32(16))) | np.uint32(1)
        i = np.arange(k, dtype=np.uint32)
        return ((h1[:, None] + i[None, :] * h2[:, None])
                % np.uint32(m_bits)).astype(np.int64)


def _np_bits(words: np.ndarray, n: int) -> np.ndarray:
    """LSB-first uint32 words -> the first ``n`` bits, bool."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def _np_tra(values: np.ndarray, caps: np.ndarray, p):
    """§3's charge sharing in float64: (delta, sensed, expected)."""
    v, c = values.astype(np.float64), caps.astype(np.float64)
    delta = ((v * c).sum(-1) * p.vdd + p.c_bitline_ff * p.vdd / 2.0) \
        / (c.sum(-1) + p.c_bitline_ff) - p.vdd / 2.0
    return delta, delta + p.sense_offset_frac * p.vdd > 0, v.sum(-1) >= 2


def phase_paper(torch, rec):
    """The paper's §3 (Table 1, Monte-Carlo TRA), §6.2 (the bop dispatch)
    and §8.4 (masked init, XOR cipher, DNA matching, Bloom filters) and the
    bitmap data filter through their entry points on the card, every
    result against numpy on the host."""
    from repro_torch.core import spice
    from repro_torch.core.bitplane import to_uint32
    from repro_torch.core.isa import BuddyDevice
    from repro_torch.data import bitmap_filter as bf
    from repro_torch.kernels import LAUNCHES
    from repro_torch.ops import bloom, crypto, dna
    from repro_torch.ops.masked_init import (field_mask,
                                             masked_fill_constant,
                                             masked_init)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2017)
    walls = {}

    def timed(name, fn):
        rec.stage = name
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t
        rec.stage = None
        return out

    p = spice.DEFAULT_SPICE
    # inputs, drawn before the counts start
    rows = {n: _draw_words(torch, gen, BOP_ROW_BITS // 32) for n in "abcd"}
    groups = {"a": "g0", "b": "g0", "c": "g1", "d": "g2"}
    pixels = _draw_words(torch, gen, PIXELS)
    values = _draw_words(torch, gen, PIXELS)
    plain = _draw_words(torch, gen, CIPHER_WORDS)
    genome = torch.randint(0, 4, (GENOME,), generator=gen, device=dev)
    bloom_keys = [_draw_words(torch, gen, BLOOM_KEYS)
                  for _ in range(BLOOM_FILTERS)]
    probes = _draw_words(torch, gen, 1 << 16)
    read = genome[READ_AT:READ_AT + READ_LEN].tolist()
    mutated = list(read)
    for j in (3, 11):
        mutated[j] = (mutated[j] + 1) % 4
    torch.cuda.synchronize()

    LAUNCHES.clear()
    table = timed("§3 table 1", lambda: spice.table1(device=dev))
    mc = {s: timed(f"§3 monte carlo {s}", lambda s=s: spice.monte_carlo_tra(
        torch.Generator(device=dev).manual_seed(int(s * 100)), MC_TRIALS, s))
        for s in MC_SIGMAS}

    def bops():
        bd = BuddyDevice(row_bits=BOP_ROW_BITS, device=dev)
        for name, words in rows.items():
            bd.store(name, words, group=groups[name])
        return [bd.bop(op, dst, srcs, group=g)
                for op, dst, srcs, g in PAPER_BOPS]

    bop_results = timed("§6.2 bop", bops)
    mask = timed("§8.4.1 masked init", lambda: field_mask(
        32, 24, 8, PIXELS, device=dev))
    cleared, filled, put = (timed("§8.4.1 masked init", fn) for fn in (
        lambda: masked_fill_constant(pixels, mask, 0),
        lambda: masked_fill_constant(pixels, mask, 1),
        lambda: masked_init(pixels, mask, values)))
    cipher = timed("§8.4.2 xor", lambda: crypto.xor_encrypt(plain,
                                                            CIPHER_KEY))
    back = timed("§8.4.2 xor", lambda: crypto.xor_decrypt(cipher,
                                                          CIPHER_KEY))
    exact = timed("§8.4.3 dna", lambda: dna.find_matches(genome, read))
    near = timed("§8.4.3 dna", lambda: dna.find_matches_with_mismatches(
        genome, mutated, 2))

    def blooms():
        fs = [bloom.BloomFilter.create(BLOOM_BITS, BLOOM_K, device=dev)
              .insert(k) for k in bloom_keys]
        merged = fs[0].merge(*fs[1:])
        return merged, merged.query(torch.cat(bloom_keys)), \
            merged.query(probes), merged.fill_ratio()

    merged, hits, probe_hits, fill = timed("§8.4.4 bloom", blooms)
    cat = timed("bitmap filter", lambda: bf.CorpusCatalog.synthetic(
        gen, N_DOCS))
    spec = dict(require=("lang_en",), exclude=("toxic",),
                ranges={"n_tokens": (128, 2048)})
    bitmap, n_ok = timed("bitmap filter",
                         lambda: bf.build_filter(cat, **spec))
    ids = timed("bitmap filter",
                lambda: bf.sample_eligible(gen, bitmap, N_DOCS, 4096))
    launches = dict(LAUNCHES)
    print(f"[paper] launches while §3, §6.2, §8.4 and the filter ran: "
          f"{launches}")
    for name in PAPER_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the paper's path")

    # §3 against numpy
    for case, vals, _ in spice.TABLE1_CASES:
        for v in spice.VARIATIONS:
            caps = p.c_cell_ff * np.array([1 + v, 1 - v, 1 - v])
            delta, sensed, want = _np_tra(np.array(vals), caps, p)
            lat = p.tau_ns * np.log(p.vdd / 2 / max(abs(delta), 1e-6)) + (
                p.t_restore_1_ns if sensed else p.t_restore_0_ns)
            e = table[case][v]
            check(e["fails"] == (bool(sensed) != bool(want))
                  and abs(e["latency_ns"] - lat) <= 1e-5 * lat
                  and abs(e["delta_v"] - delta) <= 1e-6,
                  f"§3 Table 1 {case} at {v}: {e} vs numpy delta "
                  f"{delta:.6g}, latency {lat:.6g}")
    fails = [(c, v) for c, row in table.items() for v, e in row.items()
             if e["fails"]]
    check(fails == [("1s0w0w", 0.25)], f"§3 Table 1 fails at {fails}")
    mc_rates = {}
    for s, got in mc.items():
        v_t, c_t = spice.draw_trials(
            torch.Generator(device=dev).manual_seed(int(s * 100)),
            MC_TRIALS, s)
        delta, sensed, want = _np_tra(v_t.cpu().numpy(), c_t.cpu().numpy(),
                                      p)
        n_fail = int((sensed != want).sum())
        # float32 on the card against float64 here: trials within 1e-6 V
        # of the sense threshold may land either way
        edge = int((np.abs(delta + p.sense_offset_frac * p.vdd)
                    < 1e-6).sum())
        lat = p.tau_ns * np.log(p.vdd / 2 / np.maximum(np.abs(delta), 1e-6)) \
            + np.where(sensed, p.t_restore_1_ns, p.t_restore_0_ns)
        check(abs(int(got["n_fail"]) - n_fail) <= edge
              and abs(float(got["mean_latency_ns"]) - lat.mean())
              <= 1e-4 * lat.mean(),
              f"§3 Monte-Carlo at sigma {s}: {int(got['n_fail'])} fails, "
              f"mean latency {float(got['mean_latency_ns']):.6g} vs numpy "
              f"{n_fail} (+-{edge}), {lat.mean():.6g}")
        mc_rates[s] = float(got["failure_rate"])
    check(mc_rates[MC_SIGMAS[0]] == 0.0 < mc_rates[MC_SIGMAS[1]],
          f"§3 Monte-Carlo failure rates {mc_rates}")
    # §6.2 against numpy
    host = {n: to_uint32(w) for n, w in rows.items()}
    paths = []
    for (op, dst, srcs, _), r in zip(PAPER_BOPS, bop_results):
        host[dst] = _np_bitwise(op, *(host[s] for s in srcs))
        check(np.array_equal(to_uint32(r.value), host[dst])
              and r.value.is_cuda, f"§6.2 bop {op} -> {dst} ({r.path}) "
              "differs from numpy")
        paths.append(f"{op}:{r.path}/{r.n_psm}")
    check({r.path for r in bop_results} == {"buddy", "cpu"}
          and all((r.path == "cpu") == (r.n_psm >= 3) for r in bop_results),
          f"§6.2 paths {paths}")
    # §8.4.1 against numpy
    px, vals_h = to_uint32(pixels), to_uint32(values)
    m = np.uint32(0xFF000000)
    check(np.array_equal(to_uint32(mask), np.full(PIXELS, m)),
          "§8.4.1 field mask differs from numpy")
    for label, got, want in (("clear", cleared, px & ~m),
                             ("fill", filled, px | m),
                             ("init", put, (px & ~m) | (vals_h & m))):
        check(np.array_equal(to_uint32(got), want),
              f"§8.4.1 masked {label} differs from numpy")
    # §8.4.2 against numpy
    pt = to_uint32(plain)
    check(np.array_equal(to_uint32(cipher),
                         pt ^ _np_keystream(CIPHER_KEY, CIPHER_WORDS))
          and np.array_equal(to_uint32(back), pt),
          "§8.4.2 XOR cipher differs from numpy")
    # §8.4.3 against numpy
    g = genome.cpu().numpy()
    n_starts = GENOME - READ_LEN + 1
    counts = {}
    for label, r, t, bv in (("exact", read, 0, exact),
                            ("<= 2 mismatches", mutated, 2, near)):
        miss = np.zeros(n_starts, np.int8)
        for j, b in enumerate(r):
            miss += g[j:j + n_starts] != b
        sel = miss <= t
        check(bv.n_bits == n_starts
              and np.array_equal(to_uint32(bv.words), _packed(sel)),
              f"§8.4.3 DNA {label} differs from numpy")
        check(bool(sel[READ_AT]), f"§8.4.3 DNA {label} misses the read")
        counts[label] = int(sel.sum())
    # §8.4.4 against numpy
    bits = np.zeros(BLOOM_BITS, bool)
    for k in bloom_keys:
        bits[_np_bloom_slots(to_uint32(k), BLOOM_K, BLOOM_BITS).ravel()] = 1
    slots = _np_bloom_slots(to_uint32(probes), BLOOM_K, BLOOM_BITS)
    check(np.array_equal(to_uint32(merged.bits.words), _packed(bits))
          and bool(hits.all())
          and np.array_equal(probe_hits.cpu().numpy(), bits[slots].all(1))
          and abs(float(fill) - bits.mean()) <= 1e-7,
          "§8.4.4 merged Bloom filter differs from numpy")
    # the bitmap filter against numpy on the catalog's own bits
    attr = {n: _np_bits(to_uint32(w), N_DOCS) for n, w in cat.attrs.items()}
    col = cat.columns["n_tokens"]
    planes = to_uint32(col.planes)
    tok = np.zeros(N_DOCS, np.int64)
    for j in range(col.n_bits):
        tok |= _np_bits(planes[j], N_DOCS).astype(np.int64) << j
    sel = attr["lang_en"] & ~attr["toxic"] & (tok >= 128) & (tok <= 2048)
    ids_h = ids.cpu().numpy()
    check(n_ok == int(sel.sum())
          and np.array_equal(to_uint32(bitmap), _packed(sel)),
          f"bitmap filter: {n_ok} eligible vs numpy {int(sel.sum())}")
    check(len(set(ids_h.tolist())) == ids_h.shape[0]
          and bool(sel[ids_h].all()), "bitmap filter: the sample repeats "
          "an id or holds an ineligible one")
    print(f"[paper] §3: Table 1 fails only at {fails} and equals numpy; "
          f"Monte-Carlo at {MC_TRIALS} trials: failure rates "
          + ", ".join(f"sigma {s}: {r:.3g}" for s, r in mc_rates.items())
          + "; all equal numpy")
    print(f"[paper] §6.2: {len(PAPER_BOPS)} bops over "
          f"{BOP_ROW_BITS // 8}-byte rows ({', '.join(paths)}) equal numpy")
    print(f"[paper] §8.4: masked init of {PIXELS} pixels, XOR of "
          f"{CIPHER_WORDS} words, DNA in {GENOME} bases ({counts}), "
          f"{BLOOM_FILTERS} Bloom filters of {BLOOM_BITS} bits x "
          f"{BLOOM_KEYS} keys merged (fill {float(fill):.4f}); bitmap "
          f"filter over {N_DOCS} documents: {n_ok} eligible, 4096 sampled; "
          f"all equal numpy")
    print("[paper] wall s by part: "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return launches, {"paper_wall_s": walls, "paper_mc_failure_rate":
                      mc_rates, "paper_dna_matches": counts,
                      "paper_filter_eligible": n_ok}


# ---------------------------------------------------------------------------
# phases 3i-3k: the SSM, hybrid, enc-dec and VLM families served
# ---------------------------------------------------------------------------

#: phases 3i-3k: (phase, arch, depth or None for the published one, seed,
#: flash launches a prefill). Each serves 3e's traffic (LM_BATCH prompts
#: of LM_PROMPT ids, LM_NEW new, greedy, bf16, weights drawn on the card
#: one matrix at a time). Mamba2 has no attention, so no kernel; Zamba2
#: runs its shared block 54 / 6 = 9 times at head dim 80; SeamlessM4T's
#: 12 encoder layers attend non-causally over 1,024 frames, its 12 decoder
#: layers causally and across to the frames; the VLM is cut from 100
#: layers to 10 (two groups of 4 self-attention layers and one self +
#: cross layer, about 22 GB of weights; all 100 hold 181 GB),
#: 10 self and 2 cross launches over 1,600 patches.
FAMILY_PHASES = (
    ("3i", "mamba2_1p3b", None, 19, 0),
    ("3i", "zamba2_2p7b", None, 20, 9),
    ("3j", "seamless_m4t_medium", None, 21, 36),
    ("3k", "llama_3p2_vision_90b", 10, 22, 12),
)


def _attentions(cfg) -> int:
    """The attention calls of one forward of ``cfg`` by its layout: the
    flash launches of a prefill."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "vlm":
        return cfg.n_layers + cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


def phase_family(torch, rec, tag, arch, n_layers, seed, n_flash):
    """One model of phases 3i-3k at its published widths through ``build
    -> init -> generate`` on the card: finite logits, ids in the
    vocabulary, the exact flash launches of a prefill, and prefill(S) +
    ``decode_step`` against prefill(S + 1); prints the cold and warm
    walls, tok/s, peak memory, the cache's bytes and a warm prefill's
    device ms by kind with its idle share (the profiled run's device time
    against that run's own wall)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import frontend_name
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import build
    from repro_torch.serve import cache_bytes, extend_cache, generate

    cfg = get_config(arch)
    published = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    check(_attentions(cfg) == n_flash,
          f"{cfg.name}: {_attentions(cfg)} flash launches a prefill "
          f"by its layout, {n_flash} expected")
    torch.cuda.empty_cache()
    bundle = build(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = bundle.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1),
                            generator=gen, device=bundle.device)
    batch = {"tokens": prompts[:, :LM_PROMPT]}
    front = frontend_name(cfg)
    if front:
        batch[front] = torch.randn(
            (LM_BATCH, cfg.n_frontend_tokens, cfg.frontend_dim or
             cfg.d_model), generator=gen, device=bundle.device).to(
                torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(bundle.device.type == "cuda" and all(
        p.dtype == torch.bfloat16 for n, p in params.named_parameters()
        if n.rsplit(".", 1)[-1] not in ("a_log", "d_skip", "dt_bias")),
        f"{cfg.name} is not in bf16 on the card")

    seen = {"finite": torch.ones((), dtype=torch.bool,
                                 device=bundle.device)}

    def prefill(p, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = bundle.prefill(p, b)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t
        seen["logits"] = logits
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    def decode_step(p, token, cache, pos):
        logits, cache = bundle.decode_step(p, token, cache, pos)
        seen["finite"] &= torch.isfinite(logits).all()
        return logits, cache

    served = dataclasses.replace(bundle, prefill=prefill,
                                 decode_step=decode_step)
    stage = f"{cfg.name} prefill"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only = stage, {"flash_attention"}
    try:
        t0 = time.perf_counter()
        toks = generate(served, params, batch, LM_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        rec.stage = rec.only = None
    t_prefill = seen["prefill_s"]
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {cfg.name}: launches while generate ran: {launches}"
          + ("" if n_flash else " (the SSM family launches no kernel: its "
             "mixer is plain PyTorch, as the reference's is plain jnp)"))
    check(launches == ({"flash_attention": n_flash} if n_flash else {}),
          f"{cfg.name}: launches {launches}, expected {n_flash} flash "
          f"launches of one prefill and nothing else")
    check(tuple(toks.shape) == (LM_BATCH, LM_NEW) and toks.is_cuda
          and toks.dtype == torch.int32, f"generate gave {tuple(toks.shape)} "
          f"{toks.dtype} on {toks.device}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.padded_vocab,
          f"ids outside [0, {cfg.padded_vocab})")
    check(bool(seen["finite"]), f"a logit of {cfg.name}'s serving path is "
          f"not finite")
    check(torch.equal(toks[:, 0], seen.pop("logits").argmax(-1).to(
        torch.int32)), "the first id is not the prefill's argmax")
    # prefill(S) + decode_step == prefill(S + 1): the SSM state and conv
    # window, the self KV sheets and the cross keys / values carry the
    # prompt
    longer = dict(batch, tokens=prompts)
    want, _ = bundle.prefill(params, longer)
    _, cache = bundle.prefill(params, batch)
    n_cache = cache_bytes(cache)
    got, _ = bundle.decode_step(params, prompts[:, LM_PROMPT],
                                extend_cache(cache, 1), LM_PROMPT)
    err_decode = _max_rel(got, want)
    check(bool(torch.isfinite(want).all() and torch.isfinite(got).all()),
          "non-finite logits in the decode check")
    check(err_decode < LM_TOL, f"{cfg.name}: prefill(S) + decode_step vs "
          f"prefill(S + 1): {err_decode:.3g} of the largest logit (>= "
          f"{LM_TOL})")
    del cache, got, want, longer
    # warm: the same call again, timed; then one prefill under the
    # profiler for its device time by kind
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(served, params, batch, LM_NEW)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t_warm_prefill = seen["prefill_s"]
    check(bool(seen["finite"]), "a logit of the warm run is not finite")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.prefill(params, batch)
        torch.cuda.synchronize()
        t_profiled = time.perf_counter() - t0
    device, events = _device_ms_by_kind(prof)
    del params, prof
    torch.cuda.empty_cache()
    decode_ms = (t_gen - t_prefill) / (LM_NEW - 1) * 1e3
    warm_decode_ms = (t_warm - t_warm_prefill) / (LM_NEW - 1) * 1e3
    busy = sum(device.values())
    key = arch.split("_")[0]
    info = {f"{key}_arch": cfg.name, f"{key}_layers": cfg.n_layers,
            f"{key}_published_layers": published,
            f"{key}_params": n_params, f"{key}_weight_bytes": w_bytes,
            f"{key}_init_s": t_init, f"{key}_generate_s": t_gen,
            f"{key}_prefill_s": t_prefill, f"{key}_decode_ms": decode_ms,
            f"{key}_tok_per_s": LM_BATCH * LM_NEW / t_gen,
            f"{key}_warm_generate_s": t_warm,
            f"{key}_warm_prefill_s": t_warm_prefill,
            f"{key}_warm_decode_ms": warm_decode_ms,
            f"{key}_warm_tok_per_s": LM_BATCH * LM_NEW / t_warm,
            f"{key}_peak_device_bytes": peak, f"{key}_cache_bytes": n_cache,
            f"{key}_flash_per_prefill": n_flash,
            f"{key}_err_decode_vs_prefill": err_decode,
            f"{key}_profiled_prefill_s": t_profiled,
            f"{key}_prefill_device_ms": device,
            f"{key}_prefill_device_events": events}
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"depth cut from {published} to {cfg.n_layers} layers")
    print(f"[{tag}] {cfg.name} at its published widths, {depth}: d_model "
          f"{cfg.d_model}, vocab {cfg.padded_vocab} padded, "
          f"{n_params / 1e9:.3f} B parameters ({w_bytes / 2**30:.2f} GiB) "
          f"in bf16 (init {t_init:.2f} s)"
          + (f"; frontend {front} {tuple(batch[front].shape)}" if front
             else ""))
    print(f"[{tag}] {cfg.name} cold generate: {LM_BATCH} prompts of "
          f"{LM_PROMPT} ids, {LM_NEW} new, greedy: {t_gen:.3f} s wall, "
          f"prefill {t_prefill * 1e3:.1f} ms, {decode_ms:.2f} ms per decode "
          f"step (the cache extension included), "
          f"{LM_BATCH * LM_NEW / t_gen:.1f} generated tok/s; peak device "
          f"memory {peak / 2**30:.2f} GiB, cache at S "
          f"{n_cache / 2**30:.3f} GiB")
    print(f"[{tag}] {cfg.name} warm generate: {t_warm:.3f} s wall, prefill "
          f"{t_warm_prefill * 1e3:.1f} ms, {warm_decode_ms:.2f} ms per "
          f"decode step, {LM_BATCH * LM_NEW / t_warm:.1f} generated tok/s")
    print(f"[{tag}] {cfg.name} warm prefill under the profiler: device "
          + (f"{busy:.2f} ms over {events} kernels and copies "
             f"(torch.profiler: "
             + ", ".join(f"{k} {v:.2f}" for k, v in device.items())
             + f"), idle {1 - busy / (t_profiled * 1e3):.1%} of its own "
             f"wall, {t_profiled * 1e3:.1f} ms" if busy else
             "time not measured (the profiler saw no device events)"))
    print(f"[{tag}] {cfg.name}: {n_flash} flash launches a prefill, exact; "
          f"decode vs prefill(S + 1) {err_decode:.3g} of the largest logit "
          f"(bound {LM_TOL}); ids {tuple(toks.shape)} in range, every "
          f"logit finite")
    return launches, info


# ---------------------------------------------------------------------------
# phases 3l-3n: the SSM, hybrid, enc-dec and VLM families trained
# ---------------------------------------------------------------------------

#: phases 3l-3n: (phase, arch, depth or None for the published one, seed,
#: optimizer, global batch, microbatches, attentions a forward). Each
#: trains at train_4k's sequence (TRAIN_SEQ) in bf16 through ``build ->
#: init -> make_train_step`` with ``remat="block"`` on the port's
#: `SyntheticLM` (its stub frames / patches included), the global batch
#: cut from train_4k's 256 for time. Mamba2 has no attention, so no
#: kernel; Zamba2 applies its shared block 9 times at head dim 80;
#: SeamlessM4T runs 12 encoder, 12 decoder and 12 cross attentions at head
#: dim 64. The VLM is cut from 100 layers to 5 (one group: 4 self layers,
#: one self + cross layer; 6.6 B parameters) and trains with Adafactor in
#: one microbatch of 2: AdamW's two float32 moments would add 52.9 GB to
#: its 26.4 GB of bf16 weights and gradients, and a second microbatch
#: another 26.4 GB of float32 sums.
TRAIN_FAMILY_PHASES = (
    ("3l", "mamba2_1p3b", None, 23, "adamw", 4, 2, 0),
    ("3l", "zamba2_2p7b", None, 24, "adamw", 4, 2, 9),
    ("3m", "seamless_m4t_medium", None, 25, "adamw", 4, 2, 36),
    ("3n", "llama_3p2_vision_90b", 5, 26, "adafactor", 2, 1, 6),
)
#: phase 3p: the MoE family trained, as 3n (Adafactor, global batch 1 of
#: train_4k's sequence in one microbatch: a second microbatch would add
#: 42-46 GB of float32 sums), each model at its published widths with its
#: depth cut to 2 layers (one dense, one MoE) and its expert count halved
#: (``n_experts``, the one width cut): Llama-4 Maverick at 64 of 128
#: experts (10.63 B parameters: 21.3 GB of bf16 weights, as much again of
#: gradients, 11.3 GB of Adafactor statistics) and Kimi K2 at 192 of 384
#: (11.43 B: 22.9 + 22.9 + 11.9 GB); at all the experts these take 96.8
#: and 102.7 GB, past the card's 80 GB. Fields as TRAIN_FAMILY_PHASES',
#: then the expert count.
TRAIN_MOE_PHASES = (
    ("3p", "llama4_maverick_400b_a17b", 2, 27, "adafactor", 1, 1, 2, 64),
    ("3p", "kimi_k2_1t_a32b", 2, 28, "adafactor", 1, 1, 2, 192),
)
#: the cold step and three warm ones, on one batch
TRAIN_FAMILY_STEPS = 4
#: the schedule: one warm-up step (at rate 0, so the cold step leaves the
#: initial parameters as they were) to 1e-3, cosine over 100
TRAIN_FAMILY_LR = (1e-3, 1, 100)
#: check (ii): a gradient leaf passes within TRAIN_GRAD_TOL of its RMS or
#: within this multiple of the plain attention's own spread on that leaf
#: (its 256 x 256 blocks against its 512 x 512). Zamba2's SSM scalars
#: (a_log, dt_bias: gradients that are sums of terms that cancel) move by
#: more than TRAIN_GRAD_TOL between the plain attention's two blockings
TRAIN_SPREAD_MULT = 2.0


def _plain_grad_check(bundle, params, batch, accum, name,
                      host: bool = False) -> dict:
    """Check (ii) of 3l-3n and 3p: the loss and every gradient leaf of
    one batch with the kernels against the plain attention swapped in
    (loss within TRAIN_LOSS_TOL relative; each leaf's RMS difference
    within TRAIN_GRAD_TOL of its RMS or TRAIN_SPREAD_MULT times the plain
    attention's own spread). At most two gradient sets are alive at
    once; with ``host`` the plain attention's set waits on the host, so
    that only one set is ever on the card (3p: the MoE's 21-23 GB of
    bf16 gradients beside its weights and Adafactor's statistics)."""
    import torch

    from repro_torch.kernels import flashattn
    from repro_torch.train.step import loss_and_grads

    def run(swap):
        saved = (flashattn.flash_attention_fwd_kernel,
                 flashattn.flash_attention_bwd_kernel)
        if swap is not None:
            flashattn.flash_attention_fwd_kernel, \
                flashattn.flash_attention_bwd_kernel = swap
        try:
            return loss_and_grads(bundle, params, batch, accum)
        finally:
            flashattn.flash_attention_fwd_kernel, \
                flashattn.flash_attention_bwd_kernel = saved

    loss_p, _, grads_p = run(_plain_attention(flashattn))
    if host:
        grads_p = {n: g.cpu() for n, g in grads_p.items()}
        torch.cuda.empty_cache()
    loss_k, _, grads_k = run(None)
    err = {n: _rel_rms(grads_k[n], grads_p[n]) for n in grads_p}
    del grads_k
    _, _, grads_s = run(_plain_attention(flashattn, block=256))
    spread = {n: _rel_rms(grads_s[n], grads_p[n]) for n in grads_p}
    del grads_s, grads_p
    bound = {n: max(TRAIN_GRAD_TOL, TRAIN_SPREAD_MULT * spread[n])
             for n in err}
    worst = max(err, key=lambda n: err[n] / bound[n])
    err_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(err_loss < TRAIN_LOSS_TOL, f"{name}: loss with the kernels vs "
          f"the plain attention: {err_loss:.3g} relative (>= "
          f"{TRAIN_LOSS_TOL})")
    check(err[worst] <= bound[worst], f"{name}: gradient {worst} with the "
          f"kernels vs the plain attention: RMS difference "
          f"{err[worst]:.3g} of its RMS (bound {bound[worst]:.3g}: "
          f"{TRAIN_GRAD_TOL} or {TRAIN_SPREAD_MULT} x the plain "
          f"attention's spread {spread[worst]:.3g})")
    top = max(err, key=err.get)
    return {"err_plain_loss": err_loss, "err_plain_grad": err[top],
            "err_plain_grad_leaf": top, "plain_spread": spread[top],
            "err_plain_share": err[worst] / bound[worst],
            "leaves_over_tol": sum(e >= TRAIN_GRAD_TOL
                                   for e in err.values()),
            "leaves": len(err)}


def _ssd_ms(torch, cfg, batch: int):
    """Device ms of one `ssd_chunked` forward, and of its forward and
    backward, at one layer's training shape (bf16 x, B and C, float32
    dt; CUDA events, mean of 3 after a warm-up)."""
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(
            dtype).requires_grad_()

    x = draw(batch, TRAIN_SEQ, H, P)
    dt = (0.1 * torch.randn((batch, TRAIN_SEQ, H), generator=gen,
                            device="cuda")).abs().requires_grad_()
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    Bm, Cm = draw(batch, TRAIN_SEQ, N), draw(batch, TRAIN_SEQ, N)

    def fwd():
        return ssd_chunked(x, dt, a_log, Bm, Cm, cfg.ssm_chunk)[0]

    def fwd_bwd():
        y = fwd()
        torch.autograd.grad(y, (x, dt, Bm, Cm), torch.ones_like(y))

    out = []
    for fn in (fwd, fwd_bwd):
        fn()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(3):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / 3)
    return tuple(out)


#: the plain flash functions, which no launch on the card may reach
PLAIN_FLASH = ("flash_attention_plain", "flash_attention_fwd_plain",
               "flash_attention_bwd_plain")


def phase_train_family(torch, rec, tag, arch, n_layers, seed, opt_name,
                       batch_size, accum, n_attn, n_experts=None):
    """One model of phases 3l-3n and 3p trained at its published widths
    (``n_experts``: the MoE's expert count, cut) through ``build -> init
    -> make_train_step`` on the card, with the checks of 3f: (i) the
    first loss finite and within 10% of its value at the initial
    weights, ln(padded vocab) + INIT_STD^2 d_model / 2, for the MoE plus
    the weighted load-balancing loss (MOE_AUX_WEIGHT x the first step's
    aux); (ii) the first step's loss and every gradient leaf against the
    same step with the plain attention forward and backward swapped in
    (`_plain_grad_check`, the plain set held on the host for the MoE;
    not for Mamba2, which has no attention); (iii) three steps on one
    batch lower the loss; (iv) with two microbatches, ``grad_accum`` 2
    and 1 on one main-path microbatch agree in loss; (v) the exact
    launches of a step, and no call of a plain flash function.
    The first microbatch's flash launches are recorded for phase 4.
    Prints the cold and warm step, tokens/s, peak memory, a warm step's
    device ms by kind with its idle share, for the SSD families the
    scan's forward and backward at one layer's shape, and for the MoE
    the aux loss and each MoE layer's dropped slots."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES, flashattn
    from repro_torch.models import build, moe
    from repro_torch.models.layers import INIT_STD
    from repro_torch.models.transformer import MOE_AUX_WEIGHT, layer_kinds
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = get_config(arch)
    published, published_experts = cfg.n_layers, cfg.n_experts
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
    n_moe = layer_kinds(cfg).count("moe") if cfg.family == "moe" else 0
    check(_attentions(cfg) == n_attn, f"{cfg.name}: {_attentions(cfg)} "
          f"attentions a forward by its layout, {n_attn} expected")
    torch.cuda.empty_cache()
    bundle = build(cfg, remat="block")
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=bundle.device)
                         .manual_seed(seed))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(bundle.device.type == "cuda" and all(
        p.dtype == torch.bfloat16 for n, p in params.named_parameters()
        if n.rsplit(".", 1)[-1] not in ("a_log", "d_skip", "dt_bias",
                                        "router")),
        f"{cfg.name} is not in bf16 on the card")
    batch = SyntheticLM.for_cell(
        cfg, ShapeConfig("train_4k", TRAIN_SEQ, batch_size, "train"),
        seed=seed).batch(0)
    check(all(x.is_cuda for x in batch.values()),
          "the batch is not on the card")
    opt = get_optimizer(opt_name, warmup_cosine(*TRAIN_FAMILY_LR))
    state = opt.init(params)
    calls = []

    def loss(p, b):
        # phase 4 replays the first microbatch's launches only
        calls.append(None)
        if len(calls) > 1:
            rec.stage = None
        return bundle.loss(p, b)

    step_fn = make_train_step(dataclasses.replace(bundle, loss=loss), opt,
                              grad_accum=accum)
    tokens = batch_size * TRAIN_SEQ

    # the main path: the cold first step, the plain flash functions
    # counted (none may run) and the MoE dispatches kept
    plain = {"calls": 0}
    saved = {n: getattr(flashattn, n) for n in PLAIN_FLASH}

    def counted(fn):
        def call(*a, **kw):
            plain["calls"] += 1
            return fn(*a, **kw)
        return call

    dispatch, drops = moe.dispatch, []

    def spy(idx, n_experts, capacity):
        d = dispatch(idx, n_experts, capacity)
        drops.append((int((~d.keep).sum()), d.keep.numel(), capacity))
        return d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec.stage, rec.only = f"{cfg.name} train step", set(TRAIN_KERNELS)
    for n, fn in saved.items():
        setattr(flashattn, n, counted(fn))
    moe.dispatch = spy
    try:
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, 0, batch)
        losses = [float(metrics["loss"])]
        t_cold = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        rec.stage = rec.only = None
        for n, fn in saved.items():
            setattr(flashattn, n, fn)
        moe.dispatch = dispatch
    # the load-balancing loss (one microbatch's metrics carry it)
    aux = float(metrics["aux"]) if n_moe else 0.0
    peak = torch.cuda.max_memory_allocated()
    check(plain["calls"] == 0, f"{cfg.name}: the step called a plain "
          f"flash function {plain['calls']} times")
    # the forward's dispatches (the checkpointed recompute repeats them)
    check(len(drops) == 2 * n_moe * accum, f"{cfg.name}: {len(drops)} "
          f"MoE dispatches in a step of {n_moe} MoE layers")
    drops = drops[:n_moe]
    print(f"[{tag}] {cfg.name}: launches in the first step: {launches}"
          + ("" if n_attn else " (the SSM family launches no kernel: its "
             "mixer is plain PyTorch, as the reference's is plain jnp)"))
    want = ({"flash_attention_fwd": 2 * n_attn * accum,
             "flash_attention_bwd": n_attn * accum} if n_attn else {})
    check({k: v for k, v in launches.items() if v} == want,
          f"{cfg.name}: the step launched {launches}, not {want}: per "
          f"attention and microbatch the lse forward twice (the forward "
          f"and the checkpointed block's recompute) and the backward once")
    # (i) the first loss, against its value at the initial weights: the
    # logits of unit-RMS hidden states through the N(0, INIT_STD^2) head
    # have variance INIT_STD^2 d_model, which lifts the cross-entropy over
    # ln V by half of it (1.64 at the VLM's d_model of 8,192, 14% of ln V)
    ln_v = float(np.log(cfg.padded_vocab))
    want_loss = ln_v + INIT_STD ** 2 * cfg.d_model / 2 + MOE_AUX_WEIGHT * aux
    check(np.isfinite(losses[0])
          and abs(losses[0] - want_loss) < 0.1 * want_loss,
          f"{cfg.name}: first loss {losses[0]:.4f} is not within 10% of ln "
          f"{cfg.padded_vocab} + {INIT_STD}^2 d_model / 2 + "
          f"{MOE_AUX_WEIGHT} aux ({aux:.4f}) = {want_loss:.4f}")
    # (ii) the first step's loss and gradients (at rate 0 it left the
    # initial parameters) against the plain attention swapped in
    info = (_plain_grad_check(bundle, params, batch, accum, cfg.name,
                              host=n_moe > 0) if n_attn else {})
    # (iii) three steps on the one batch lower the loss; the warm ones
    # timed (the peak memory is the steps', not the check's)
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for i in range(1, TRAIN_FAMILY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, i, batch)
        losses.append(float(metrics["loss"]))
        warm.append(time.perf_counter() - t0)
    peak = max(peak, torch.cuda.max_memory_allocated())
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{cfg.name}: three steps on one batch did not lower the loss: "
          f"{losses}")
    t_warm = float(np.mean(warm[1:]))
    # the device's split of one more warm step; device events only (the
    # split reads no host event, and host events multiply the profiler's
    # cost over these steps' tens of thousands of kernels)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, TRAIN_FAMILY_STEPS, batch)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    device, events = _device_ms_by_kind(prof, backward=True)
    del prof, state, opt, step_fn

    # (iv) grad_accum 2 against 1 on one main-path microbatch
    if accum > 1:
        half = {k: x[:batch_size // accum] for k, x in batch.items()}
        loss_2, _, g2 = loss_and_grads(bundle, params, half, 2)
        del g2
        loss_1, _, g1 = loss_and_grads(bundle, params, half, 1)
        del g1
        err_accum = abs(float(loss_2) - float(loss_1))
        check(err_accum < TRAIN_ACCUM_TOL, f"{cfg.name}: grad_accum 2 vs "
              f"1: losses {float(loss_2):.5f} and {float(loss_1):.5f} "
              f"differ by {err_accum:.3g} (>= {TRAIN_ACCUM_TOL})")
        info["err_accum"] = err_accum
    del params
    torch.cuda.empty_cache()
    ssd = _ssd_ms(torch, cfg, batch_size // accum) if cfg.ssm_state \
        else None
    busy = sum(device.values())
    key = arch.split("_")[0]
    if n_moe:
        info.update(experts=cfg.n_experts,
                    published_experts=published_experts, aux=aux,
                    dropped_slots=[d for d, _, _ in drops],
                    routed_slots=drops[0][1], capacity=drops[0][2])
    info.update(arch=cfg.name, layers=cfg.n_layers,
                published_layers=published, params=n_params,
                weight_bytes=w_bytes, optimizer=opt_name,
                global_batch=batch_size, microbatches=accum,
                tokens_per_step=tokens, init_s=t_init, cold_s=t_cold,
                warm_s=t_warm, warm_steps_s=warm, tok_per_s=tokens / t_warm,
                losses=losses, peak_device_bytes=peak,
                profiled_step_s=t_prof, device_ms=device,
                device_events=events, launches=launches, ssd_ms=ssd)
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"depth cut from {published} to {cfg.n_layers} layers")
    if n_experts is not None:
        depth += (f", experts cut from {published_experts} to "
                  f"{cfg.n_experts} (top-{cfg.top_k}, "
                  f"{cfg.n_shared_experts} shared)")
    print(f"[{tag}] {cfg.name} trained at its published widths, {depth}: "
          f"d_model {cfg.d_model}, vocab {cfg.padded_vocab} padded, "
          f"{n_params / 1e9:.3f} B parameters ({w_bytes / 2**30:.2f} GiB) "
          f"in bf16 (init {t_init:.2f} s); {opt_name}, remat 'block', "
          f"sequence {TRAIN_SEQ}, global batch {batch_size} in {accum} "
          f"microbatch{'es' if accum > 1 else ''}")
    print(f"[{tag}] {cfg.name} step ms: cold {t_cold * 1e3:.1f}, warm "
          f"{t_warm * 1e3:.1f} (mean of steps 2-{TRAIN_FAMILY_STEPS - 1}; "
          f"{', '.join(f'{w * 1e3:.1f}' for w in warm)}); "
          f"{tokens / t_warm:.0f} tok/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[{tag}] {cfg.name} losses over {TRAIN_FAMILY_STEPS} steps on "
          f"one batch: " + ", ".join(f"{x:.4f}" for x in losses)
          + f" (ln V = {ln_v:.4f}; at the initial weights "
          f"{want_loss:.4f} expected)")
    if n_moe:
        print(f"[{tag}] {cfg.name} first step: aux {aux:.4f} (x "
              f"{MOE_AUX_WEIGHT} in the loss); dropped slots per MoE layer "
              f"of the forward: "
              + ", ".join(f"{d} of {n} at capacity {c}" for d, n, c in drops))
    print(f"[{tag}] {cfg.name} warm step under the profiler: "
          f"{t_prof * 1e3:.1f} ms wall; device "
          + (f"{busy:.1f} ms over {events} kernels and copies ("
             + ", ".join(f"{k} {v:.1f}" for k, v in device.items())
             + f"), idle {1 - busy / (t_prof * 1e3):.1%} of its wall "
             f"(against the unprofiled warm step, "
             f"{1 - busy / (t_warm * 1e3):.1%})"
             if busy else "time not measured (the profiler saw no device "
             "events)"))
    if ssd is not None:
        n_mb = cfg.n_layers * accum
        share = n_mb * (ssd[0] + ssd[1]) / (t_warm * 1e3)
        print(f"[{tag}] {cfg.name} SSD scan at one layer's shape (B "
              f"{batch_size // accum}, S {TRAIN_SEQ}, {cfg.n_ssm_heads} "
              f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
              f"{cfg.ssm_chunk}): forward {ssd[0]:.2f} ms, forward + "
              f"backward {ssd[1]:.2f} ms; a step runs both {n_mb} times "
              f"(the recompute is the second forward): "
              f"{n_mb * (ssd[0] + ssd[1]):.0f} ms, {share:.1%} of the "
              f"warm step")
    print(f"[{tag}] {cfg.name}: launches exact"
          + (f"; (ii) the first step, kernels vs plain attention: loss "
             f"{info['err_plain_loss']:.3g} relative (bound "
             f"{TRAIN_LOSS_TOL}); largest gradient leaf difference "
             f"{info['err_plain_grad']:.3g} of its RMS "
             f"({info['err_plain_grad_leaf']}, where the plain attention's "
             f"own spread is {info['plain_spread']:.3g}); "
             f"{info['leaves_over_tol']} of {info['leaves']} leaves over "
             f"{TRAIN_GRAD_TOL}, each within {TRAIN_SPREAD_MULT} x its "
             f"spread; largest share of a leaf's bound "
             f"{info['err_plain_share']:.3g}" if n_attn else "")
          + (f"; (iv) grad_accum 2 vs 1 loss {info['err_accum']:.3g} "
             f"(bound {TRAIN_ACCUM_TOL})" if accum > 1 else ""))
    return launches, {f"{key}_train_{k}": v for k, v in info.items()}


# ---------------------------------------------------------------------------
# phase 3o: the chip cluster under the query service
# ---------------------------------------------------------------------------

#: phase 3o: chip counts on the one card, the plan groups whose first
#: dispatch the fault injector fails, the stream's batches
CLUSTER_CHIPS = (2, 4, 8)
FAILED_GROUPS = (1, 5)
STREAM_BATCHES = 3


def _served(torch, svc, queries):
    """One batch on the card: (report, wall s, VM launches by mode)."""
    from repro_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    report = svc.query_batch(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vm = {k: LAUNCHES.get(k, 0) - before.get(k, 0) for k in CLUSTER_KERNELS}
    return report, wall, vm


def _check_like_3a(report, want, label) -> None:
    for got, w in zip(report.results, want):
        check(np.array_equal(np.asarray(got.value), np.asarray(w)),
              f"{label}: query {got.index} differs from phase 3a's")
    check(len(report.results) == len(want), f"{label}: result count")


def phase_cluster(torch, spec, ref):
    """3o: the §8 stream of 3a through the chip cluster on the card."""
    import shutil
    import tempfile

    from repro_torch.dist.fault_tolerance import (FaultTolerance,
                                                  SimulatedFailure)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.service import ServiceConfig, build_service

    card = nvidia_smi("name,power.limit")
    queries, mat = ref["queries"], ref["mat"]
    cfg = ServiceConfig(n_banks=8, n_chips=1, max_chips=8, device="cuda")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    svc = build_service(spec, config=cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    cl = svc.cluster
    words = svc.catalog.placement("t0/male").local_words
    check((cl.slots, cl.local_banks, words) == (64, 64, 8192),
          f"3o layout: {cl.slots} slots of {words} words")
    info = {"build_service_s": t_build}
    walls = []
    for label, qs, want, mode in (
            ("cold", queries, ref["scalars"], "vm_popcount"),
            ("warm", queries, ref["scalars"], "vm_popcount"),
            ("materialize", mat, ref["mat_values"], "vm_materialize")):
        report, wall, vm = _served(torch, svc, qs)
        _check_like_3a(report, want, f"3o(a) {label}")
        check(vm[mode] == report.n_plan_groups,
              f"3o(a) {label}: {vm[mode]} {mode} launches for "
              f"{report.n_plan_groups} plan groups")
        info[f"c1_{label}_wall_s"] = wall
        walls.append(f"{label} {wall:.3f} s ({vm[mode]} {mode})")
    print(f"[cluster] (a) {len(svc.catalog)} vectors on 1 chip x 8 banks, "
          f"{cl.slots} slots of {words} words; build_service "
          f"{t_build:.2f} s; " + ", ".join(walls)
          + f"; every answer equals 3a's; card {card}")
    # (b) C chips on the one card: the same catalog re-placed
    for c in CLUSTER_CHIPS:
        plan = svc.rescale(c, devices=["cuda:0"] * c)
        check(plan.grad_accum == 8 // c and svc.cluster.n_chips == c,
              f"3o(b) rescale to {c} chips: {plan}")
        report, wall, vm = _served(torch, svc, queries)
        _check_like_3a(report, ref["scalars"], f"3o(b) {c} chips")
        report_mat, wall_mat, vm_mat = _served(torch, svc, mat)
        _check_like_3a(report_mat, ref["mat_values"],
                       f"3o(b) {c} chips materialize")
        check(vm["vm_popcount"] == c * report.n_plan_groups
              and vm_mat["vm_materialize"] == c * report_mat.n_plan_groups,
              f"3o(b) {c} chips: VM launches {vm}, {vm_mat} are not "
              f"{c} per plan group")
        info[f"c{c}_batch_wall_s"] = wall
        info[f"c{c}_materialize_wall_s"] = wall_mat
        print(f"[cluster] (b) {c} chips on the one card (sweeps of 8 "
              f"banks: {plan.grad_accum}): {len(queries)}-query batch "
              f"{wall:.3f} "
              f"s wall, {vm['vm_popcount']} VM popcount launches "
              f"({report.n_plan_groups} plan groups); materialize batch "
              f"{wall_mat:.3f} s, {vm_mat['vm_materialize']} VM "
              f"materialize launches; equal to 3a's; card {card}")
    # (c) replays of plain failures on a 4-chip cluster
    armed = set(FAILED_GROUPS)

    def inject(g):
        if g in armed:
            armed.discard(g)
            raise RuntimeError(f"injected failure in plan group {g}")

    ft = FaultTolerance(max_replays=2, failure_injector=inject)
    del svc
    svc = build_service(spec, config=ServiceConfig(
        n_banks=8, n_chips=1, max_chips=8, device="cuda",
        fault_tolerance=ft))
    svc.rescale(4, devices=["cuda:0"] * 4)
    report, wall, vm = _served(torch, svc, queries)
    _check_like_3a(report, ref["scalars"], "3o(c) with injected failures")
    check(ft.failures == len(FAILED_GROUPS)
          and ft.replays == len(FAILED_GROUPS) and not armed,
          f"3o(c): {ft.failures} failures, {ft.replays} replays for "
          f"{len(FAILED_GROUPS)} injected ({ft.timeline})")
    check(vm["vm_popcount"] == 4 * report.n_plan_groups,
          f"3o(c): {vm['vm_popcount']} VM launches for "
          f"{report.n_plan_groups} plan groups on 4 chips")
    info["ft_batch_wall_s"] = wall
    print(f"[cluster] (c) 4 chips, a RuntimeError injected in plan groups "
          f"{FAILED_GROUPS}: batch {wall:.3f} s wall, equal to 3a's; "
          f"failures {ft.failures}, replays {ft.replays}, timeline "
          f"{ft.timeline}; card {card}")
    # (d) checkpointed stream serving, recovered and resumed
    per = -(-len(queries) // STREAM_BATCHES)
    batches = [queries[i:i + per] for i in range(0, len(queries), per)]
    hit = {"live": True}

    def crash(step):
        if step == 1 and hit["live"]:
            hit["live"] = False
            raise SimulatedFailure("injected mid-stream crash")

    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        t0 = time.perf_counter()
        vals, rep = svc.serve_stream(batches, ck_dir, ckpt_every=1,
                                     failure_injector=crash)
        t_stream = time.perf_counter() - t0
        check(list(vals) == list(ref["scalars"]),
              "3o(d): the stream's values differ from 3a's")
        check(rep.failures == 1 and rep.restores == 1
              and "restore@1" in rep.timeline,
              f"3o(d): report {rep.timeline}")
        # a fresh service resumes after the last checkpoint was lost
        shutil.rmtree(os.path.join(ck_dir, f"step_{len(batches):08d}"))
        del svc
        fresh = build_service(spec, config=cfg)
        t0 = time.perf_counter()
        vals2, rep2 = fresh.serve_stream(batches, ck_dir, ckpt_every=1)
        t_resume = time.perf_counter() - t0
        check(list(vals2) == list(ref["scalars"]),
              "3o(d): the resumed stream's values differ from 3a's")
        check(rep2.timeline[0] == f"resume@{len(batches) - 1}"
              and rep2.steps_run == 1,
              f"3o(d): resume report {rep2.timeline}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    info["stream_wall_s"] = t_stream
    info["resume_wall_s"] = t_resume
    print(f"[cluster] (d) serve_stream of {len(batches)} batches with one "
          f"failure: {t_stream:.3f} s wall ({rep.timeline}); a fresh "
          f"service resumed at batch {len(batches) - 1}: {t_resume:.3f} s; "
          f"both equal to 3a's; card {card}")
    launches = dict(LAUNCHES)
    print(f"[cluster] launches while 3o ran: {launches}")
    for name in CLUSTER_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the cluster path")
    return launches, {f"cluster_{k}": v for k, v in info.items()}


# ---------------------------------------------------------------------------
# phase 3q: the mesh-free launch stack
# ---------------------------------------------------------------------------

#: 3q(a): steps of 3f's training under "dots" (one cold, two warm)
DOTS_STEPS = 3
#: the VM modes 3q(c) must launch
PLANE_KERNELS = ("vm_materialize", "vm_popcount")


def phase_plane_helpers(torch, clean, rec):
    """3q(c): the first plan group of 3a's stream through the VM's named-row
    helpers: `lowering.make_plane` from the catalog's rows, then
    `kernels.ops.run_megakernel` with the group's output names and with
    ``reduce="popcount"`` (the catalog's tail mask), each held bit for bit
    to `lowering.execute_lowered` on the same rows; `read_rows` of the
    plane gives back the catalog's rows. Both launches are recorded for
    phase 4 (stage "plane helpers")."""
    from repro_torch.core import lowering
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ops import run_megakernel

    t_part = time.perf_counter()
    svc, queries = clean["svc"], clean["queries"]
    planner = svc.scheduler.planner

    def key(q):
        return planner.plan(q.query, columns=svc.catalog.columns,
                            names=svc.catalog).plan.key

    first = key(queries[0])
    texts = [q.query for q in queries if key(q) == first]
    plan, data = _group(svc, texts)
    lp, outs = plan.lowered, list(plan.outputs)
    rows = {n: torch.stack(v) for n, v in data.items()}
    words = svc.catalog.mask().shape[0]
    plane = lowering.make_plane(lp, rows, words, batch=(len(texts),))
    check(plane.is_cuda and plane.dtype == torch.int32,
          f"make_plane gave {plane.dtype} on {plane.device}")
    back = lowering.read_rows(lp, plane, list(rows))
    check(all(torch.equal(back[n], rows[n]) for n in rows),
          "read_rows of the plane differs from the catalog's rows")
    mask = svc.catalog.mask()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    rec.stage, rec.only = "plane helpers", {"vm"}
    t0 = time.perf_counter()
    got_rows = run_megakernel(lp, plane, outs)
    got_counts = run_megakernel(lp, plane, outs, reduce="popcount",
                                mask=mask)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rec.stage = rec.only = None
    print(f"[3q-c plane] launches of run_megakernel: {launches}")
    for name in PLANE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"run_megakernel never launched {name}")
    want_rows = lowering.execute_lowered(lp, data, outputs=outs)
    want_counts = lowering.execute_lowered(lp, data, outputs=outs,
                                           reduce="popcount", mask=mask)
    for j, name in enumerate(outs):
        check(torch.equal(got_rows[j], want_rows[name]),
              f"run_megakernel row {name} differs from execute_lowered's")
        check(torch.equal(got_counts[j], want_counts[name]),
              f"run_megakernel count {name} differs from execute_lowered's")
    print(f"[3q-c plane] first plan group of 3a's stream: {len(texts)} "
          f"queries, {lp.n_rows} plane rows x {words} words, "
          f"{lp.n_cmds} commands, outputs {outs}: make_plane + "
          f"run_megakernel (materialize, then popcount under the tail "
          f"mask, {t_run * 1e3:.2f} ms cold) equal execute_lowered bit for "
          f"bit; read_rows gives back the catalog's rows")
    t_part = time.perf_counter() - t_part
    print(f"[3q-c plane] the part took {t_part:.1f} s")
    return launches, {"plane_group_queries": len(texts),
                      "plane_rows": lp.n_rows, "plane_cmds": lp.n_cmds,
                      "plane_part_s": t_part}


def phase_remat_dots(torch, block):
    """3q(a): 3f's training (Qwen3-0.6B at 4,096, global batch 8 in four
    microbatches, AdamW, 3f's seed and weights) under ``remat="dots"``
    beside "block": the loss of 3f's first batch and every gradient leaf
    bit-equal to "block"'s ("dots" changes only what the backward reruns,
    not what it computes); then one cold and two warm steps of "dots",
    their walls and peak memory, and one more warm step under the
    profiler (device kernels only): its device time by kind. "block"'s
    walls, device time and peak are 3f's (``block``, `phase_train`'s
    info; its peak less the arguments recorded for phase 4); the idle
    shares are taken against each policy's unprofiled warm wall."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import build
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    t_part = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    bundles = {r: build(cfg, remat=r) for r in ("block", "dots")}
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=TRAIN_SEED,
                        device=bundles["block"].device).batch(0)
    gen = torch.Generator(device=bundles["block"].device).manual_seed(
        TRAIN_SEED)
    params = bundles["block"].init(gen)
    loss_b, _, g_b = loss_and_grads(bundles["block"], params, batch,
                                    TRAIN_ACCUM)
    loss_d, _, g_d = loss_and_grads(bundles["dots"], params, batch,
                                    TRAIN_ACCUM)
    check(float(loss_d) == float(loss_b), f"remat 'dots' loss "
          f"{float(loss_d)!r} != 'block' loss {float(loss_b)!r}")
    err = {n: _rel_rms(g_d[n], g_b[n]) for n in g_b}
    worst = max(err, key=err.get)
    unequal = [n for n in g_b if not torch.equal(g_d[n], g_b[n])]
    check(not unequal, f"remat 'dots' gradients differ from 'block''s on "
          f"{len(unequal)} of {len(err)} leaves (first {unequal[:3]}; "
          f"worst {worst}, RMS difference {err[worst]:.3g} of 'block''s)")
    del g_b, g_d
    opt = adamw(warmup_cosine(*TRAIN_LR))
    state = opt.init(params)
    step_fn = make_train_step(bundles["dots"], opt, grad_accum=TRAIN_ACCUM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    walls, losses = [], []
    for i in range(DOTS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, i, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        params, state, _ = step_fn(params, state, DOTS_STEPS, batch)
        torch.cuda.synchronize()
    device, events = _device_ms_by_kind(prof, backward=True)
    del prof, params, state, opt, step_fn
    torch.cuda.empty_cache()
    print(f"[3q-a dots] launches in {DOTS_STEPS} 'dots' steps: {launches}")
    n_micro = TRAIN_ACCUM * cfg.n_layers
    want = {"flash_attention_fwd": 2 * n_micro * DOTS_STEPS,
            "flash_attention_bwd": n_micro * DOTS_STEPS}
    check({k: v for k, v in launches.items() if v} == want,
          f"the 'dots' steps launched {launches}, not {want}: the flash "
          f"forward is recomputed as under 'block'")
    check(losses[0] == float(loss_b), f"the first 'dots' step's loss "
          f"{losses[0]!r} != 'block''s {float(loss_b)!r}")
    runs = {"block": {"walls_s": [block["train_cold_s"]]
                      + block["train_warm_steps_s"],
                      "warm_s": block["train_warm_s"],
                      "losses": block["train_losses"],
                      "peak_bytes": block["train_peak_device_bytes"]
                      - block["train_recorded_bytes"],
                      "device_ms": block["train_device_ms"],
                      "device_events": block["train_device_events"]},
            "dots": {"walls_s": walls, "warm_s": float(np.mean(walls[1:])),
                     "losses": losses, "peak_bytes": peak,
                     "device_ms": device, "device_events": events}}
    for remat, r in runs.items():
        busy = sum(r["device_ms"].values())
        warm_ms = r["warm_s"] * 1e3
        r["idle_share"] = 1 - busy / warm_ms if busy else None
        print(f"[3q-a dots] remat {remat!r}"
              + (" (3f's run)" if remat == "block" else "")
              + f": step ms cold {r['walls_s'][0] * 1e3:.1f}, warm "
              + ", ".join(f"{w * 1e3:.1f}" for w in r["walls_s"][1:])
              + f" (mean {warm_ms:.1f}); peak device memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; losses "
              + ", ".join(f"{x:.4f}" for x in r["losses"][:DOTS_STEPS]))
        print(f"[3q-a dots] remat {remat!r}: a profiled warm step's device "
              + (f"time {busy:.1f} ms over {r['device_events']} kernels "
                 f"and copies (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                             r["device_ms"].items())
                 + f"), idle {r['idle_share']:.1%} of the mean warm wall; "
                 f"host beyond the device {warm_ms - busy:.1f} ms"
                 if busy else "time not measured (the profiler saw no "
                 "device events)"))
    busy = {k: sum(r["device_ms"].values()) for k, r in runs.items()}
    gap = (runs["dots"]["warm_s"] - runs["block"]["warm_s"]) * 1e3
    if busy["block"] and busy["dots"]:
        print(f"[3q-a dots] 'dots' - 'block': mean warm wall {gap:+.1f} ms, "
              f"device {busy['dots'] - busy['block']:+.1f} ms, host beyond "
              f"the device {gap - (busy['dots'] - busy['block']):+.1f} ms")
    t_part = time.perf_counter() - t_part
    print(f"[3q-a dots] loss {float(loss_d):.6f} and all {len(err)} "
          f"gradient leaves bit-equal to 'block''s (largest RMS "
          f"difference {err[worst]:.3g}); the part took {t_part:.1f} s")
    return launches, {"dots_runs": runs, "dots_err_grad": err[worst],
                      "dots_err_grad_leaf": worst,
                      "dots_equal_leaves": len(err) - len(unequal),
                      "dots_part_s": t_part}


def _count_cell(cfg, shape, overrides=None):
    """3q(b)'s chain for one cell: `plan_for` -> ``build(remat=
    plan.remat)`` -> ``abstract`` -> `input_specs` -> `hlocost.count` of
    the step on meta -> `roofline.analyze` at one chip."""
    import dataclasses

    from repro_torch.launch import hlocost, roofline
    from repro_torch.launch.plans import plan_for
    from repro_torch.models import build, input_specs
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.train import make_train_step

    plan = plan_for(cfg, shape, overrides)
    accum = plan.grad_accum
    while accum > 1 and shape.global_batch % accum:
        accum //= 2
    plan = dataclasses.replace(plan, grad_accum=accum)
    bundle = build(cfg, remat=plan.remat)
    params, _ = bundle.abstract()
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = get_optimizer(plan.optimizer, warmup_cosine(*TRAIN_LR))
        state = opt.init(params)
        cost = hlocost.count(make_train_step(bundle, opt,
                                             grad_accum=plan.grad_accum),
                             params, state, 0, batch)
        held = hlocost.tensor_bytes(params, state, batch)
    else:
        cost = hlocost.count(bundle.prefill, params, batch)
        held = hlocost.tensor_bytes(params, batch)
    return plan, cost, roofline.analyze(cost, cfg, shape, "1", 1, plan.arch,
                                        bytes_per_device=held, card=CARD)


def phase_roofline(torch, info):
    """3q(b): 3e's prefill, 3f's training step and 3g's two prefills
    counted on meta and priced against the card's peaks, beside each
    phase's measured warm wall and device time and the measured share of
    the card's bf16 peak, ``useful_flops / (wall x peak)``. The
    reference's ``model_flops`` (2 N D, 6 N D) is printed and kept under
    its own key; the useful ratio, the roofline fraction and the share
    are taken on `roofline.useful_flops`, which leaves out the token
    table's lookup and a prefill's head at all but the last position
    (2 N D charges both and passes 1 on 3g's 2-layer prefills). The
    count allocates nothing on the card, and the flash FLOPs it charges
    3f's step equal `flash_cost` summed over 3f's launches."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.roofline import useful_flops

    t_part = time.perf_counter()
    cells = [("3e", get_config(LM_ARCH),
              ShapeConfig("3e prefill", LM_PROMPT, LM_BATCH, "prefill"),
              None, info["lm_warm_ms"]["prefill"] / 1e3,
              info["lm_device_ms"]["prefill"]),
             ("3f", get_config(TRAIN_ARCH),
              ShapeConfig("3f train", TRAIN_SEQ, TRAIN_BATCH, "train"),
              {"grad_accum": TRAIN_ACCUM}, info["train_warm_s"],
              info["train_device_ms"])]
    for arch, n_layers, _ in MOE_PHASES:
        tag = f"moe_{arch.split('_')[0]}_"
        cells.append((f"3g {arch.split('_')[0]}", dataclasses.replace(
            get_config(arch), n_layers=n_layers),
            ShapeConfig("3g prefill", LM_PROMPT, LM_BATCH, "prefill"), None,
            info[tag + "warm_prefill_s"], info[tag + "prefill_device_ms"]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = {}
    for tag, cfg, shape, over, wall, device in cells:
        t0 = time.perf_counter()
        plan, cost, r = _count_cell(cfg, shape, over)
        t_count = time.perf_counter() - t0
        check(torch.cuda.memory_allocated() == before,
              f"counting {tag} allocated "
              f"{torch.cuda.memory_allocated() - before} bytes on the card")
        d = r.to_dict()
        useful = useful_flops(cfg, shape)
        u = dataclasses.replace(r, model_flops_=useful)
        d.update(useful_flops=useful, useful_flops_ratio=u.useful_ratio,
                 roofline_fraction=u.roofline_fraction)
        busy = sum(device.values())
        share = useful / (wall * CARD.bf16_flops_per_s)
        counted_share = d["hlo_flops"] / (wall * CARD.bf16_flops_per_s)
        check(0 < share <= 1 and 0 < d["useful_flops_ratio"] <= 1,
              f"{tag}: useful FLOPs {useful:.4e} read {share:.4f} of the "
              f"peak and {d['useful_flops_ratio']:.4f} of the count")
        if tag == "3f":
            charged = sum(cost.kernel_flops.values())
            check(charged == info["train_flash_flops"],
                  f"the count charges 3f's step {charged:.6e} flash FLOPs, "
                  f"its launches {info['train_flash_flops']:.6e}")
        print(f"[3q-b roofline] {tag}: {cfg.name} ({cfg.n_layers} layers) "
              f"{shape.kind} {shape.global_batch} x {shape.seq_len}, plan "
              f"{plan.optimizer} / accum {plan.grad_accum} / remat "
              f"{plan.remat}; counted on meta in {t_count:.1f} s: "
              f"{d['hlo_flops']:.4e} FLOP, {d['hlo_bytes']:.4e} B, dot "
              f"{d['dot_bytes']:.4e} B, held {d['bytes_per_device']:.4e} B; "
              f"terms compute {d['t_compute_s'] * 1e3:.2f} ms, memory "
              f"{d['t_memory_s'] * 1e3:.2f} ms (floor "
              f"{d['t_memory_floor_s'] * 1e3:.2f}), collective "
              f"{d['t_collective_s'] * 1e3:.2f} ms, dominant "
              f"{d['dominant']}; model FLOPs (the reference's 2 N D / "
              f"6 N D) {d['model_flops']:.4e}, useful FLOPs (no table "
              f"lookup, a prefill's head at the last position) "
              f"{useful:.4e}: useful ratio {d['useful_flops_ratio']:.4f}, "
              f"roofline fraction {d['roofline_fraction']:.4f}")
        print(f"[3q-b roofline] {tag}: measured warm wall "
              f"{wall * 1e3:.2f} ms, device {busy:.2f} ms (torch.profiler)"
              f"; useful FLOPs / (wall x {CARD.bf16_flops_per_s:.3g} "
              f"FLOP/s) = {share:.4f} of the card's bf16 peak (counted "
              f"FLOPs: {counted_share:.4f})"
              + (f"; flash FLOPs charged {charged:.6e} = flash_cost over "
                 f"3f's launches" if tag == "3f" else ""))
        out[tag] = {**d, "measured_wall_s": wall, "measured_device_ms": busy,
                    "measured_peak_share": share,
                    "counted_peak_share": counted_share, "count_s": t_count,
                    "kernel_flops": cost.kernel_flops}
    t_part = time.perf_counter() - t_part
    print(f"[3q-b roofline] the counts left the card's allocated memory at "
          f"{before} bytes; the part took {t_part:.1f} s")
    return {}, {"roofline": out, "roofline_part_s": t_part}


# ---------------------------------------------------------------------------
# phase 4: numbers
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 3r: the mesh
# ---------------------------------------------------------------------------

#: 3r's mesh: two ranks sharing the one card over gloo would carry
#: DTensor's collectives through the host, but the card's torch 2.11
#: gloo never completes a functional all-gather of CUDA tensors
#: (``_c10d_functional.all_gather_into_tensor``; its all-reduce,
#: reduce-scatter and all-to-all, and the raw c10d all-gather, do), and
#: NCCL takes one rank a card; so 3r runs the mesh's entry points on a
#: (data 1, model 1) mesh of one NCCL rank, and the two-rank and
#: four-rank meshes run in the CPU tests
MESH_SHAPE = (1, 1)
#: 3r(a): Qwen3-0.6B at its published widths and depth, one sequence of
#: train_4k's 4,096 a step, AdamW at a constant rate; a cold and two
#: warm steps and a profiled one
MESH_SEQ, MESH_BATCH, MESH_STEPS, MESH_SEED, MESH_LR = 4096, 1, 3, 27, 1e-4
#: 3r(c): the dry run's cells, each in a subprocess of its own on meta
DRYRUN_CELLS = (("qwen3_8b", "train_4k"), ("kimi_k2_1t_a32b", "train_4k"))
#: the dry runs' limit: they start with the script and run beside it
DRYRUN_TIMEOUT = 900


def start_dryruns():
    """3r(c)'s dry runs, started at once (their count runs on the host's
    CPU beside the card's phases): one subprocess a cell, one thread
    each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for arch, shape in DRYRUN_CELLS]


def stop_dryruns(runs) -> None:
    for _, _, proc in runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dryrun_counts(runs) -> dict:
    """Each dry run's counted FLOPs, bytes and collective bytes (its
    ``cost:`` line), waiting for it."""
    out = {}
    for arch, shape, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise SmokeFailure(f"the dry run of {arch} x {shape} took more "
                               f"than {DRYRUN_TIMEOUT} s")
        check(proc.returncode == 0 and "1/1 cells counted OK" in stdout,
              f"the dry run of {arch} x {shape} failed: {stderr[-1500:]}")
        line = next(x for x in stdout.splitlines()
                    if x.strip().startswith("cost:"))
        vals = dict(kv.split("=", 1) for kv in line.split()[1:4])
        timing = next(x for x in stdout.splitlines() if x.startswith("["))
        out[f"{arch} x {shape}"] = {
            "flops": float(vals["flops"]), "bytes": float(vals["bytes"]),
            "collective_bytes": float(vals["coll_bytes"]),
            "build_count": timing.split("] ", 1)[1]}
    return out


def phase_mesh(torch, clock_hz, dry):
    """3r: the mesh entry points on the card (`launch.mesh.make_host_mesh`
    -> `launch.cells.build_cell` -> `Cell.run` on DTensor parameters,
    the flash kernels in the `local_map` branch), the compressed step on
    the mesh's data axis, an empty launch's time, and the dry runs."""
    import copy
    import dataclasses
    import importlib

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_group, make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.optim.optimizers import leaves
    from repro_torch.train.step import loss_and_grads

    signum_mod = importlib.import_module("repro_torch.optim.signum")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("3r", MESH_SEQ, MESH_BATCH, "train")
    bundle = build(cfg)
    data = SyntheticLM(cfg.vocab_size, MESH_SEQ, MESH_BATCH, seed=MESH_SEED)
    batch = data.batch(0)

    def fresh():
        return bundle.init(torch.Generator(device="cuda").manual_seed(
            MESH_SEED))

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1)
    try:
        mesh = make_host_mesh(*MESH_SHAPE, device="cuda")
        names = dict(zip(mesh.mesh_dim_names, mesh.shape))
        params, twin = fresh(), fresh()
        cell = build_cell(TRAIN_ARCH, "train_4k", mesh, shape_override=shape,
                          params=params, batch=batch,
                          lr_fn=constant(MESH_LR))
        check(all(type(p).__name__ == "DTensor"
                  for p in params.parameters()),
              "build_cell left a parameter off the mesh")
        # (i) the first loss and every gradient leaf against the unsharded
        # step on the same card, seed and batch (3f's train gate)
        grads_cell = dataclasses.replace(
            cell, fn=lambda p, s, i, b: loss_and_grads(bundle, p, b))
        loss_m, _, g_m = grads_cell.run()
        loss_1, _, g_1 = loss_and_grads(bundle, twin, batch)
        err_loss = abs(float(loss_m.full_tensor()) - float(loss_1)) / abs(
            float(loss_1))
        err_grad = {n: _rel_rms(g_m[n].full_tensor(), g_1[n]) for n in g_1}
        worst = max(err_grad, key=err_grad.get)
        del g_m, g_1, twin
        check(err_loss < TRAIN_LOSS_TOL, f"3r's first loss on the mesh vs "
              f"the unsharded step: {err_loss:.3g} relative (>= "
              f"{TRAIN_LOSS_TOL})")
        check(err_grad[worst] < TRAIN_GRAD_TOL, f"3r's gradient {worst} on "
              f"the mesh vs the unsharded step: RMS difference "
              f"{err_grad[worst]:.3g} of its RMS (>= {TRAIN_GRAD_TOL})")
        # (ii) the main path: a cold step, every launch counted, then warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        p, s, m = cell.run()
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        want = {"flash_attention_fwd": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
        check(launches == want, f"3r's step launched {launches}, not "
              f"{want} (per rank and layer the lse forward twice, the "
              f"backward once, from the local_map branch)")
        losses, warm = [float(m["loss"])], []
        for i in range(1, MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = cell.run(p, s, i, cell.args[3])
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"3r's losses {losses}")
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            cell.run(p, s, MESH_STEPS, cell.args[3])
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        comm_ms = sum(e.self_cpu_time_total for e in prof.key_averages()
                      if "c10d" in e.key or "nccl" in e.key.lower()) / 1e3
        device, events = _device_ms_by_kind(prof, backward=True)
        del prof, p, s, cell, params
        main_launches = dict(launches)

        # (b) the compressed step on the mesh's data axis against a signum
        # step whose majority is computed in numpy from the ranks' signs
        comp_params = fresh()
        before = {n: x.detach().clone()
                  for n, x in comp_params.named_parameters()}
        seen = {}
        vote, pack = signum_mod.majority_allreduce, signum_mod.pack_tree

        def recorded_vote(packed, group=None):
            seen["packed"], seen["voted"] = packed.clone(), vote(packed,
                                                                 group)
            return seen["voted"]

        def recorded_pack(tree):
            seen["u"] = {k: x.detach().clone() for k, x in tree.items()}
            return pack(tree)

        signum_mod.majority_allreduce = recorded_vote
        signum_mod.pack_tree = recorded_pack
        try:
            comp = build_cell(TRAIN_ARCH, "train_4k", mesh,
                              overrides={"compressed_dp": True},
                              shape_override=shape, params=comp_params,
                              batch=batch, lr_fn=constant(MESH_LR))
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            comp_params, _, cm = comp.run()
            torch.cuda.synchronize()
            t_comp = time.perf_counter() - t0
            comp_launches = {k: v for k, v in LAUNCHES.items() if v}
        finally:
            signum_mod.majority_allreduce = vote
            signum_mod.pack_tree = pack
        want = {"flash_attention_fwd": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers, "pack_signs": 1,
                "unpack_signs": 1, "majority": 1}
        check(comp_launches == want, f"3r's compressed step launched "
              f"{comp_launches}, not {want}")
        data_group = axis_group(mesh, ("data",))
        d = dist.get_world_size(data_group)
        gathered = [seen["packed"].clone() for _ in range(d)]
        dist.all_gather(gathered, seen["packed"], group=data_group)
        words = np.stack([g.cpu().numpy().view(np.uint32) for g in gathered])
        bits = np.unpackbits(words.view(np.uint8), axis=-1,
                             bitorder="little")
        maj = np.packbits(bits.sum(0) >= d // 2 + 1, axis=-1,
                          bitorder="little").view(np.uint32)
        voted = seen["voted"].cpu().numpy().view(np.uint32)
        check(np.array_equal(voted, maj), "3r's voted words differ from "
              "the numpy majority of the ranks' packed signs")
        signs = torch.from_numpy(
            np.unpackbits(maj.view(np.uint8), bitorder="little")
            .astype(np.float32)).to("cuda") * -2 + 1
        # the packed signs: each leaf's u flattened in sorted order
        u = seen["u"]
        keys = sorted(u)
        offsets = dict(zip(keys, np.cumsum([0] + [u[k].numel()
                                                   for k in keys])))
        named = {n: x.to_local() for n, x in
                 comp_params.named_parameters()}
        worst_p = 0.0
        for leaf in leaves(named):
            k = leaf.name
            s_k = signs[offsets[k]:offsets[k] + u[k].numel()].reshape(
                u[k].shape)
            p0 = leaf.gather(before).float()
            want_p = (p0 - MESH_LR * (u[k].abs().mean() * s_k)).to(
                torch.bfloat16).float()
            got_p = leaf.gather(named).float()
            # within one bf16 rounding of the leaf's largest value (the
            # scale's mean may sum in another order on the mesh)
            worst_p = max(worst_p, float((got_p - want_p).abs().max()
                                         / want_p.abs().max()))
        check(worst_p <= 2 ** -8, f"3r's compressed step differs from the "
              f"signum step with numpy's majority by {worst_p:.3g} of a "
              f"leaf's largest value")
        del comp, comp_params, before, seen, u, signs
        for n, c in comp_launches.items():
            main_launches[n] = main_launches.get(n, 0) + c
    finally:
        dist.destroy_process_group()
    # an empty launch: the floor under every small kernel's time
    _, empty_ms, empty_call_ms = _time_ms(
        torch, lambda: torch.cuda._sleep(0), 50, clock_hz)
    counts = _dryrun_counts(dry)
    t_part = time.perf_counter() - t_phase
    busy = sum(device.values())
    t_warm = float(np.mean(warm))
    print(f"[3r mesh] ranks: {d} on a {names} mesh of one NCCL rank "
          f"(two gloo ranks on the card hang in DTensor's all-gather; the "
          f"2- and 4-rank meshes run in the CPU tests)")
    print(f"[3r mesh] {cfg.name} at published widths ({cfg.n_layers} "
          f"layers, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim_}, vocab {cfg.padded_vocab}) through build_cell "
          f"-> Cell.run, AdamW, one sequence of {MESH_SEQ}: launches a "
          f"step per rank {launches}; (i) loss {err_loss:.3g} "
          f"relative, worst gradient leaf {worst} {err_grad[worst]:.3g} of "
          f"its RMS against the unsharded step (bounds {TRAIN_LOSS_TOL}, "
          f"{TRAIN_GRAD_TOL})")
    print(f"[3r mesh] step ms: cold {t_cold * 1e3:.1f}, warm "
          + ", ".join(f"{w * 1e3:.1f}" for w in warm)
          + f"; rank 0 peak {peak / 2**30:.2f} GiB; losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    print(f"[3r mesh] profiled warm step {t_prof * 1e3:.1f} ms wall: "
          f"collectives (c10d / NCCL host events) {comm_ms:.2f} ms, "
          f"{comm_ms / (t_prof * 1e3):.2%} of it; device "
          + (f"{busy:.1f} ms over {events} kernels and copies, idle "
             f"{1 - busy / (t_prof * 1e3):.1%}" if busy else
             "time not measured (the profiler saw no device events)"))
    print(f"[3r mesh] (b) compressed step on the data axis "
          f"({d} rank): {t_comp * 1e3:.1f} ms, launches {comp_launches}; "
          f"voted words equal numpy's majority of the ranks' signs, and "
          f"the parameters the signum step with them (worst "
          f"{worst_p:.3g} of a leaf's largest)")
    print(f"[3r mesh] an empty launch (torch.cuda._sleep(0)): "
          f"{empty_ms * 1e3:.2f} us device, {empty_call_ms * 1e3:.2f} us "
          f"a back-to-back call")
    for cell_name, c in counts.items():
        print(f"[3r mesh] (c) dry run {cell_name} on the 16x16 fake group: "
              f"flops {c['flops']:.4g}, bytes {c['bytes']:.4g}, collective "
              f"bytes {c['collective_bytes']:.4g} ({c['build_count']})")
    print(f"[3r mesh] the phase took {t_part:.1f} s")
    info = {"mesh_ranks": d, "mesh_shape": names, "mesh_cold_s": t_cold,
            "mesh_warm_s": warm, "mesh_peak_device_bytes": peak,
            "mesh_losses": losses, "mesh_err_loss": err_loss,
            "mesh_err_grad": err_grad[worst], "mesh_err_grad_leaf": worst,
            "mesh_profiled_step_s": t_prof, "mesh_collective_ms": comm_ms,
            "mesh_device_ms": device, "mesh_compressed_s": t_comp,
            "empty_launch_us": empty_ms * 1e3,
            "empty_launch_call_us": empty_call_ms * 1e3,
            "dryrun": counts, "mesh_phase_s": t_part,
            "mesh_warm_mean_s": t_warm}
    return main_launches, info


def _time_ms(torch, fn, reps: int, clock_hz: float):
    """(result, device ms, call ms) of ``fn()``; times averaged over
    ``reps``.

    Device time: a sleep kernel holds the stream while the host enqueues
    every (start event, call, stop event) triple, so no host gap falls
    between a pair of events. Call time: events around ``reps``
    back-to-back calls on an idle stream, host work included.
    """
    result = fn()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(min(2.0 * reps * host_s + 2e-3, 5.0) * clock_hz))
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    device_ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return result, device_ms, start.elapsed_time(stop) / reps


def _vm_bound(args, kw, int_rate: float):
    """(bytes ms, ops ms): the least time one VM launch's bytes and int32
    operations take on these inputs."""
    table, plane, out_idx = args
    batch, n_in, words = plane.shape
    n_out = len(out_idx)
    counting = kw.get("reduce") is not None
    nbytes = 4 * (plane.numel() + table.size + n_out
                  + (batch * n_out if counting else batch * n_out * words))
    for t in (kw.get("errors"), kw.get("mask")):
        if t is not None:
            nbytes += 4 * t.numel()
    # one 3-input logic op (LOP3: majority with polarity) per command per
    # word; count mode adds an AND and a popcount per output word
    ops = table.shape[0] * batch * words \
        + (2 * batch * n_out * words if counting else 0)
    return nbytes / CARD.hbm_bytes_per_s * 1e3, ops / int_rate * 1e3


def _library_call(torch, op):
    """The one PyTorch call computing ``op``, or None for a composite op
    (nand, nor, xnor, andnot, maj3 have none)."""
    return {"and": torch.bitwise_and, "or": torch.bitwise_or,
            "xor": torch.bitwise_xor, "not": torch.bitwise_not}.get(op)


def _replay(torch, kind, args, kw, int_rate, clock_hz):
    """Time one recorded launch and its plain version on the same inputs.

    Returns (kernel name, kernel result, plain result, kernel ms, call ms,
    plain ms, bytes ms, ops ms, shape dict, library ms or None, library
    result or None)."""
    from repro_torch.kernels import (arith, bittranspose, bitweaving,
                                     bitwise, flashattn, majority, popcount,
                                     ref, signpack, vm)
    from repro_torch.kernels.bittranspose import bit_transpose_kernel

    lib_ms = lib_out = None
    if kind == "vm":
        name = "vm_materialize" if kw.get("reduce") is None \
            else "vm_popcount"
        table, plane, out_idx = args
        draw = kw.get("errors")
        if isinstance(draw, FaultDraw):
            kw = dict(kw, errors=draw.redraw())
        got, k_ms, c_ms = _time_ms(torch, lambda: vm.vm_megakernel(
            table, plane, out_idx, **kw), 10, clock_hz)
        want, p_ms, _ = _time_ms(torch, lambda: vm.vm_plain(
            table, plane, out_idx, **kw), 2, clock_hz)
        b_ms, o_ms = _vm_bound(args, kw, int_rate)
        shape = {"batch": plane.shape[0], "rows_in": plane.shape[1],
                 "n_rows": kw["n_rows"], "n_cmds": int(table.shape[0]),
                 "n_out": len(out_idx), "words": plane.shape[2]}
        # the design's shared-memory floor: its LDS + STS bytes over every
        # SM's 128 B a clock at the max SM clock (beside the bound, not
        # in it)
        masked = kw.get("reduce") is not None and kw.get("mask") is not None
        prog = vm.program(np.asarray(table, np.int32), tuple(out_idx),
                          kw["n_rows"], kw.get("first_row", 0),
                          plane.shape[1], kw.get("errors") is not None,
                          masked, plane.device)
        smem_rate = CARD.smem_bytes_per_clk * int_rate \
            / CARD.int32_lanes_per_sm
        shape.update(
            block=[prog.threads, prog.words],
            run_cmds=len(prog.dec.cmds),
            smem_floor_ms=plane.shape[0] * plane.shape[2]
            * prog.dec.shared_bytes_per_word(prog.words, masked)
            / smem_rate * 1e3)
        if isinstance(draw, FaultDraw):
            shape["fault_key"] = list(draw.key)
            shape["fault_words_set"] = draw.fingerprint[1]
        del kw
    elif kind == "bt":
        name = "bit_transpose"
        values, n_bits = args
        got, k_ms, c_ms = _time_ms(
            torch, lambda: bit_transpose_kernel(values, n_bits), 10, clock_hz)
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.bit_transpose(values, n_bits), 2, clock_hz)
        n = values.numel()
        b_ms = 4 * (n + n_bits * (n // 32)) / CARD.hbm_bytes_per_s * 1e3
        o_ms = n * n_bits / int_rate * 1e3    # one bit test per plane
        shape = {"values": n, "n_bits": n_bits}
    elif kind in ("bitwise", "bitwise_banked"):
        name = kind
        op, operands = args[0], args[1:]
        fn = bitwise.bitwise_kernel if kind == "bitwise" \
            else bitwise.banked_bitwise_kernel
        got, k_ms, c_ms = _time_ms(torch, lambda: fn(op, *operands), 10,
                                   clock_hz)
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.bitwise(op, *operands), 2, clock_hz)
        lib = _library_call(torch, op)
        if lib is not None:
            lib_out, lib_ms, _ = _time_ms(torch, lambda: lib(*operands), 10,
                                          clock_hz)
        words = operands[0].numel()
        # each operand read once, the result written once; one LOP3 a word
        b_ms = 4 * (len(operands) + 1) * words / CARD.hbm_bytes_per_s * 1e3
        o_ms = words / int_rate * 1e3
        shape = {"op": op, "shape": list(operands[0].shape), "words": words}
    elif kind == "popcount":
        name = kind
        (words,) = args
        got, k_ms, c_ms = _time_ms(
            torch, lambda: popcount.popcount_kernel(words), 10, clock_hz)
        want, p_ms, _ = _time_ms(torch, lambda: ref.popcount(words), 2,
                                 clock_hz)
        n = words.numel()
        b_ms = (4 * n + 8) / CARD.hbm_bytes_per_s * 1e3
        o_ms = 2 * n / int_rate * 1e3          # a POPC and an add a word
        shape = {"shape": list(words.shape), "words": n}
    elif kind == "majority":
        name = kind
        planes, threshold = args
        got, k_ms, c_ms = _time_ms(torch, lambda: majority.majority_kernel(
            planes, threshold), 10, clock_hz)
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.majority_k(planes, threshold), 2, clock_hz)
        k, words = planes.shape[0], planes[0].numel()
        n_planes = max(1, k.bit_length())
        # k planes read once, the result written once; per word k ripple
        # adds into the counter (two ops a counter plane) and the compare
        b_ms = 4 * (k + 1) * words / CARD.hbm_bytes_per_s * 1e3
        o_ms = (2 * k + 3) * n_planes * words / int_rate * 1e3
        # the copy `core.errors.vote_outputs` makes before the launch:
        # the k replicas' output planes stacked into one (k, rows, W)
        _, s_ms, _ = _time_ms(torch, lambda: torch.stack(planes.unbind(0)),
                              10, clock_hz)
        shape = {"k": k, "shape": list(planes.shape[1:]),
                 "threshold": threshold, "stack_ms": s_ms}
    elif kind == "bitserial_add":
        name = kind
        a, b, sub = args
        got, k_ms, c_ms = _time_ms(torch, lambda: arith.bitserial_add_kernel(
            a, b, sub), 10, clock_hz)
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.bitserial_add(a, b, sub), 2, clock_hz)
        n_bits, words = a.shape[0], a[0].numel()
        # two planes read and one written per bit; a full adder (two XOR,
        # one majority) and the complement per bit
        b_ms = 4 * 3 * n_bits * words / CARD.hbm_bytes_per_s * 1e3
        o_ms = 4 * n_bits * words / int_rate * 1e3
        shape = {"n_bits": n_bits, "shape": list(a.shape[1:]), "sub": sub}
    elif kind == "bitserial_lt":
        name = kind
        a, b = args
        got, k_ms, c_ms = _time_ms(torch, lambda: arith.bitserial_lt_kernel(
            a, b), 10, clock_hz)
        want, p_ms, _ = _time_ms(torch, lambda: ref.bitserial_lt(a, b), 2,
                                 clock_hz)
        n_bits, words = a.shape[0], a[0].numel()
        # two planes read per bit, one result word written; the lt / eq
        # update is two three-input ops per bit
        b_ms = 4 * (2 * n_bits + 1) * words / CARD.hbm_bytes_per_s * 1e3
        o_ms = 2 * n_bits * words / int_rate * 1e3
        shape = {"n_bits": n_bits, "shape": list(a.shape[1:])}
    elif kind == "bit_untranspose":
        name = kind
        (planes,) = args
        got, k_ms, c_ms = _time_ms(
            torch, lambda: bittranspose.bit_untranspose_kernel(planes), 10,
            clock_hz)
        n_bits, g = planes.shape
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.bit_untranspose(planes, n_bits), 2, clock_hz)
        n = 32 * g
        # each of the n_bits plane words read once and each value written
        # once; one bit test per plane per value
        b_ms = 4 * (n_bits + 32) * g / CARD.hbm_bytes_per_s * 1e3
        o_ms = n_bits * n / int_rate * 1e3
        shape = {"values": n, "n_bits": n_bits}
    elif kind == "flash_attention":
        name = kind
        q, k, v = args                  # the model's (B, S, heads, hd)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        got, k_ms, c_ms = _time_ms(torch, lambda: flashattn.
                                   flash_attention_kernel(q, k, v, **kw), 10,
                                   clock_hz)
        want, p_ms, _ = _time_ms(torch, lambda: flashattn.
                                 flash_attention_plain(qh, kh, vh, **kw), 2,
                                 clock_hz)
        want = want.transpose(1, 2)
        causal = kw.get("causal", True)
        # the yardstick: one PyTorch call on head-major copies
        qc, kc, vc = (x.contiguous() for x in (qh, kh, vh))
        lib_out, lib_ms, _ = _time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, enable_gqa=True), 10,
            clock_hz)
        lib_out = lib_out.transpose(1, 2)
        del qc, kc, vc, qh, kh, vh
        B, Sq, H, hd = q.shape
        Sk = k.shape[1]
        flops, nbytes, b_ms, o_ms = _flash_cost(kind, q, k, causal)
        shape = {"B": B, "H": H, "KV": k.shape[2], "Sq": Sq, "Sk": Sk,
                 "hd": hd, "causal": causal, "dtype": str(q.dtype),
                 "flops": flops, "bytes": nbytes,
                 "fma_ms": _fma_ms(flops) if q.dtype == torch.float32
                 else None}
    elif kind in ("flash_attention_fwd", "flash_attention_bwd"):
        name = kind
        q, k, v = args[:3]                  # the model's (B, S, heads, hd)
        causal = kw.get("causal", True)
        B, Sq, H, hd = q.shape
        Sk = k.shape[1]
        # the library call, on head-major contiguous copies (the port
        # never calls it)
        qc, kc, vc = (_hm(x).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if kind == "flash_attention_fwd":
            got, k_ms, c_ms = _time_ms(torch, lambda: flashattn.
                                       flash_attention_fwd_kernel(
                                           q, k, v, **kw), 10, clock_hz)
            want, p_ms, _ = _time_ms(torch, lambda: flashattn.
                                     flash_attention_fwd_plain(
                                         _hm(q), _hm(k), _hm(v), **kw), 2,
                                     clock_hz)
            want = (_hm(want[0]), want[1])
            lib_out, lib_ms, _ = _time_ms(torch, lambda: sdpa(
                qc, kc, vc, is_causal=causal, enable_gqa=True), 10,
                clock_hz)
            lib_out = (_hm(lib_out),)
        else:
            o, lse, do = args[3:]
            got, k_ms, c_ms = _time_ms(torch, lambda: flashattn.
                                       flash_attention_bwd_kernel(
                                           *args, **kw), 5, clock_hz)
            want, p_ms, _ = _time_ms(torch, lambda: flashattn.
                                     flash_attention_bwd_plain(
                                         _hm(q), _hm(k), _hm(v), _hm(o), lse,
                                         _hm(do), **kw), 2, clock_hz)
            want = tuple(_hm(w) for w in want)
            # the library's backward alone: the graph of one forward, its
            # backward timed
            qg, kg, vg = (x.requires_grad_() for x in (qc, kc, vc))
            with torch.enable_grad():
                lib_o = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
            doc = _hm(do).contiguous()
            lib_out, lib_ms, _ = _time_ms(torch, lambda: torch.autograd.grad(
                lib_o, (qg, kg, vg), doc, retain_graph=True), 10, clock_hz)
            lib_out = tuple(_hm(g) for g in lib_out)
            del lib_o, doc, qg, kg, vg
        del qc, kc, vc
        flops, nbytes, b_ms, o_ms = _flash_cost(kind, q, k, causal)
        shape = {"B": B, "H": H, "KV": k.shape[2], "Sq": Sq, "Sk": Sk,
                 "hd": hd, "causal": causal, "dtype": str(q.dtype),
                 "flops": flops, "bytes": nbytes,
                 "fma_ms": _fma_ms(flops) if q.dtype == torch.float32
                 else None}
    elif kind in ("pack_signs", "unpack_signs"):
        name = kind
        if kind == "pack_signs":
            (x,) = args
            got, k_ms, c_ms = _time_ms(
                torch, lambda: signpack.pack_signs_kernel(x), 10, clock_hz)
            want, p_ms, _ = _time_ms(torch, lambda: ref.pack_signs(x), 2,
                                     clock_hz)
            lanes, lane_bytes = x.numel(), x.element_size()
        else:
            words, dtype = args
            got, k_ms, c_ms = _time_ms(
                torch, lambda: signpack.unpack_signs_kernel(words, dtype),
                10, clock_hz)
            want, p_ms, _ = _time_ms(
                torch, lambda: ref.unpack_signs(words, dtype), 2, clock_hz)
            lanes, lane_bytes = 32 * words.numel(), got.element_size()
            itype = torch.int32 if lane_bytes == 4 else torch.int16
            got, want = got.view(itype), want.view(itype)
        # every lane read (written) once, one word per 32 lanes written
        # (read); one sign test or select per lane
        b_ms = (lane_bytes * lanes + 4 * lanes // 32) / CARD.hbm_bytes_per_s \
            * 1e3
        o_ms = lanes / int_rate * 1e3
        shape = {"lanes": lanes, "lane_bytes": lane_bytes}
    else:
        name = "bitweaving_scan"
        planes, c1, c2, n_bits = args
        got, k_ms, c_ms = _time_ms(
            torch, lambda: bitweaving.bitweaving_scan_kernel(
                planes, c1, c2, n_bits), 10, clock_hz)
        want, p_ms, _ = _time_ms(
            torch, lambda: ref.bitweaving_scan(planes, c1, c2, n_bits), 2,
            clock_hz)
        g = planes.shape[1]
        # n_bits planes read once, one result word per 32 values written;
        # four logic ops per plane word (two per bound)
        b_ms = 4 * (n_bits + 1) * g / CARD.hbm_bytes_per_s * 1e3
        o_ms = 4 * n_bits * g / int_rate * 1e3
        shape = {"n_bits": n_bits, "planes": planes.shape[0], "words": g,
                 "c1": c1, "c2": c2}
    return (name, got, want, k_ms, c_ms, p_ms, b_ms, o_ms, shape, lib_ms,
            lib_out)


def _flash_gate_faults(torch, q, k, v, want, tol: float) -> dict:
    """The replay gate's own reach, on one main-path launch: a dense
    float32 softmax of the same causal q, k, v (model layout, Sq = Sk),
    p rounded to v's dtype as the kernel rounds it, must pass `_gate`
    against the plain output ``want``; with one off-diagonal 64-key tile
    dropped for the last 64 queries (a kernel that skips a tile) it must
    fail. Scores rounded to bf16, a smaller fault near p's own rounding,
    are reported, not required. Returns each share of the tolerance
    used."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for x in (k, v))                                # (B, H, S, hd)
    pos = torch.arange(S, device=q.device)
    k0 = S // 2 // 64 * 64

    def dense(fault):
        out = torch.empty_like(want)
        for r0 in range(0, S, 256):
            rows = pos[r0:r0 + 256]
            s = q[:, r0:r0 + 256].float().transpose(1, 2) @ \
                kf.transpose(-1, -2) / float(np.sqrt(hd))
            if fault == "scores in bf16":
                s = s.to(torch.bfloat16).float()
            keep = rows[:, None] >= pos[None, :]
            if fault == "key tile dropped":
                keep &= ~((rows[:, None] >= S - 64)
                          & (pos[None, :] >= k0) & (pos[None, :] < k0 + 64))
            s = s.masked_fill(~keep, -1e30)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = (p.to(v.dtype).float() @ vf) / p.sum(-1, keepdim=True)
            out[:, r0:r0 + 256] = o.transpose(1, 2).to(want.dtype)
        return out

    shares = {f: _gate(dense(f), want, tol)[0]
              for f in ("none", "key tile dropped", "scores in bf16")}
    check(shares["none"] <= 1.0, f"the gate rejects a dense recomputation "
          f"of the plain output ({shares['none']:.3g} of its tolerance)")
    check(shares["key tile dropped"] > 1.0, f"the gate admits a dropped "
          f"key tile ({shares['key tile dropped']:.3g} of its tolerance)")
    print("[numbers] flash replay gate, share of its tolerance used by a "
          "dense recomputation of one prefill launch: "
          + ", ".join(f"{f} {v:.3g}" for f, v in shares.items())
          + " (at most 1 passes)")
    return shares


#: the one PyTorch call each kernel row's ``library_ms`` times
LIBRARY_CALLS = {"bitwise": "torch.bitwise_*", "bitwise_banked":
                 "torch.bitwise_*", "flash_attention":
                 "scaled_dot_product_attention", "flash_attention_fwd":
                 "scaled_dot_product_attention", "flash_attention_bwd":
                 "scaled_dot_product_attention's backward"}


def _flash_bwd_gate_faults(torch, args, kw, want, tol: float) -> dict:
    """The backward replay gate's reach, on one main-path launch: the
    plain backward at other block sizes (256 x 256) must pass `_gate`
    against the plain result ``want`` (dq, dk, dv in the model layout);
    with the last 64 query rows of query head 0 dropped (a dq or dk / dv
    CTA that skips a query tile: ``do`` zeroed there) it must fail.
    Returns each share of the tolerance used (the largest of dq, dk,
    dv)."""
    from repro_torch.kernels import flashattn

    q, k, v, o, lse, do = args
    dropped = do.clone()
    dropped[:, -64:, 0] = 0
    shares = {}
    for fault, d, blocks in (("none", do, 256),
                             ("query tile dropped", dropped,
                              kw.get("block_q", 512))):
        got = flashattn.flash_attention_bwd_plain(
            _hm(q), _hm(k), _hm(v), _hm(o), lse, _hm(d),
            kw.get("causal", True), blocks, blocks)
        shares[fault] = max(_gate(_hm(g), w, tol)[0]
                            for g, w in zip(got, want))
        del got
    check(shares["none"] <= 1.0, f"the backward gate rejects the plain "
          f"backward at other blocks ({shares['none']:.3g} of its "
          f"tolerance)")
    check(shares["query tile dropped"] > 1.0, f"the backward gate admits a "
          f"dropped query tile ({shares['query tile dropped']:.3g} of its "
          f"tolerance)")
    print("[numbers] flash backward replay gate, share of its tolerance "
          "used on one training launch: "
          + ", ".join(f"{f} {v:.3g}" for f, v in shares.items())
          + " (at most 1 passes)")
    return shares


def _split_cost(torch, args, kw, want, tol: float, clock_hz) -> dict:
    """What entering p and ds as hi + lo bf16 parts costs the head-dim-128
    backward, on one main-path launch: the launch timed with the split
    (what the port runs) and with p and ds rounded to bf16 once
    (`flashattn._launch_bwd(split=False)`, which the port never calls), in
    turns, and the share of the gate each uses against the plain version
    ``want`` (dq, dk, dv). The unsplit share is reported, not gated."""
    from repro_torch.kernels import flashattn

    causal = kw.get("causal", True)
    runs = {True: [], False: []}
    for split in (True, False, False, True):
        got, ms, _ = _time_ms(torch, lambda: flashattn._launch_bwd(
            *args, causal, split=split), 5, clock_hz)
        runs[split].append(ms)
    shares = {split: max(_gate(g, w, tol)[0] for g, w in zip(
        flashattn._launch_bwd(*args, causal, split=split), want))
        for split in (True, False)}
    out = {"split_ms": min(runs[True]), "unsplit_ms": min(runs[False]),
           "split_gate_share": shares[True],
           "unsplit_gate_share": shares[False]}
    print(f"[numbers] flash backward hi + lo split, one training launch: "
          f"{out['split_ms']:.4f} ms with it, {out['unsplit_ms']:.4f} ms "
          f"with p and ds rounded once (the split costs "
          f"{out['split_ms'] - out['unsplit_ms']:.4f} ms, "
          f"{100 * (out['split_ms'] / out['unsplit_ms'] - 1):.1f}%); share "
          f"of the gate used {shares[True]:.3g} with it, {shares[False]:.3g} "
          f"without (at most 1 passes)")
    return out


#: the float kernels, held to their plain versions by `_gate`
FLOAT_KERNELS = ("flash_attention", "flash_attention_fwd",
                 "flash_attention_bwd")


class Numbers:
    """Phase 4's totals per kernel and per stage, over one or more
    batches of replayed launches."""

    def __init__(self, max_err, float_err):
        self.per_kernel = {
            name: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "library_kernel_ms": 0.0,
                   "library_launches": 0, "replayed": 0, "calls": []}
            for name in KERNELS}
        self.stages = {}
        self.errs = [max_err]
        self.float_err = dict(float_err)


def phase_numbers(torch, calls, numbers: Numbers, int_rate, clock_hz):
    """Replay ``calls`` (and drop them as they go), each against its plain
    version and timed, into ``numbers``."""
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    per_kernel, stages = numbers.per_kernel, numbers.stages
    errs, float_err = numbers.errs, numbers.float_err
    calls.reverse()
    while calls:
        kind, args, kw, stage = calls.pop()
        (name, got, want, k_ms, c_ms, p_ms, b_ms, o_ms, shape, lib_ms,
         lib_out) = _replay(torch, kind, args, kw, int_rate, clock_hz)
        row = per_kernel[name]
        if name in FLOAT_KERNELS:
            tol = FLASH_TOL[str(args[0].dtype).split(".")[-1]]
            label = f"{name} replay ({stage})"
            if name == "flash_attention":
                err, share = _close(label, got, want, tol)
                lib_share = _close(f"{label}: the library call", lib_out,
                                   got, tol)[1]
            else:
                # the lse to 1e-4, as in phase 2
                tols = (tol, 1e-4) if name == "flash_attention_fwd" \
                    else (tol, tol, tol)
                err = share = 0.0
                for part, g, w, t in zip(("o / dq", "lse / dk", "dv"), got,
                                         want, tols):
                    e, sh = _close(f"{label} {part}", g, w, t)
                    err, share = max(err, e), max(share, sh)
                # the library's forward is held to the kernel as in
                # prefill; its bf16 backward rounds p and ds once, so its
                # share is reported, not gated
                lib_share = max(_gate(lo, g, tol)[0]
                                for lo, g in zip(lib_out, got))
                if name == "flash_attention_fwd":
                    check(lib_share <= 1.0, f"{label}: the library call "
                          f"differs from the kernel ({lib_share:.3g} of "
                          f"the tolerance)")
            float_err[name] = max(float_err.get(name, 0.0), err)
            row["gate_share"] = max(row.get("gate_share", 0.0), share)
            if name == "flash_attention_bwd" and stage == "train step" \
                    and "split_cost" not in row:
                row["split_cost"] = _split_cost(torch, args, kw, want, tol,
                                                clock_hz)
            if stage in ("lm prefill", "train step") \
                    and "gate_faults" not in row:
                row["gate_faults"] = (
                    _flash_bwd_gate_faults(torch, args, kw, want, tol)
                    if name == "flash_attention_bwd" else
                    _flash_gate_faults(torch, *args[:3], want[0]
                                       if name == "flash_attention_fwd"
                                       else want, tol))
            row["library_gate_share"] = max(
                row.get("library_gate_share", 0.0), lib_share)
        else:
            _compare(f"{name} replay ({stage})", got, want, errs)
            if lib_ms is not None:
                check(torch.equal(lib_out, got),
                      f"{name} replay ({stage}): the library call differs")
        del got, want, lib_out
        row["ms"] += k_ms
        row["call_ms"] += c_ms
        row["plain_ms"] += p_ms
        row["bytes_ms"] += b_ms
        row["ops_ms"] += o_ms
        row["bound_ms"] += max(b_ms, o_ms)
        if lib_ms is not None:
            row["library_ms"] += lib_ms
            row["library_kernel_ms"] += k_ms
            row["library_launches"] += 1
        row["replayed"] += 1
        stages[stage] = stages.get(stage, 0.0) + k_ms
        row["calls"].append({**shape, "stage": stage, "ms": k_ms,
                             "call_ms": c_ms,
                             "plain_ms": p_ms,
                             "bytes_ms": b_ms, "ops_ms": o_ms,
                             "library_ms": lib_ms})
        del args, kw
    check(dict(LAUNCHES) != before, "replays launched no kernel")


def _hopper_head_dims(name: str) -> set:
    """The head dims at which a bf16 launch of flash kernel ``name``
    takes the Hopper route: those of its sm90 instances in
    `SM90_KERNELS` (`flash_fwd_sm90_kernel<HD>`,
    `flash_bwd_dq_sm90_kernel<HD, split>`)."""
    source, prefix = (("flashattn_bwd", "flash_bwd_dq_sm90_kernel<")
                      if name == "flash_attention_bwd"
                      else ("flashattn", "flash_fwd_sm90_kernel<"))
    return {int(k[len(prefix):].split(",")[0].rstrip(">"))
            for k in SM90_KERNELS[source] if k.startswith(prefix)}


def _flash_routes(calls, hopper) -> dict:
    """Replayed flash launches by route: bf16 at a head dim in
    ``hopper`` is the Hopper kernel at that head dim, float32 the 3xTF32
    Hopper kernel at its head dim, every other launch (bf16 forward at
    16, 32) the first design."""
    routes = {}
    for c in calls:
        if c["dtype"] == "torch.float32":
            route = f"Hopper 3xTF32 hd {c['hd']}"
        elif c["hd"] in hopper:
            route = f"Hopper hd {c['hd']}"
        else:
            route = "first design"
        routes.setdefault(route, []).append(c)
    return routes


def kernel_rows(numbers: Numbers, launches):
    """Print phase 4's totals; returns the ``{"kernels": [...]}`` rows."""
    per_kernel, stages = numbers.per_kernel, numbers.stages
    errs, float_err = numbers.errs, numbers.float_err
    stack = [c["stack_ms"] for c in per_kernel["majority"]["calls"]]
    print(f"[numbers] majority: the replicas' torch.stack before each vote "
          f"took {sum(stack):.3f} ms on the device over {len(stack)} "
          f"launches")
    for name in ("vm_popcount", "vm_materialize"):
        for masked in (False, True):
            calls = [c for c in per_kernel[name]["calls"]
                     if ("fault_key" in c) == masked]
            if not calls:
                continue
            big = max(calls, key=lambda c: c["ms"])
            print(f"[numbers] {name}, "
                  f"{'masked' if masked else 'unmasked'} launches: "
                  f"{len(calls)}, kernel {sum(c['ms'] for c in calls):.3f} "
                  f"ms, bound "
                  f"{sum(max(c['bytes_ms'], c['ops_ms']) for c in calls):.3f}"
                  f" ms, shared-memory floor "
                  f"{sum(c['smem_floor_ms'] for c in calls):.3f} ms; the "
                  f"slowest (B {big['batch']}, {big['rows_in']} rows in, "
                  f"{big['n_rows']} rows, {big['n_cmds']} commands of which "
                  f"{big['run_cmds']} run, {big['n_out']} out, "
                  f"{big['words']} words, block {big['block']}) "
                  f"{big['ms']:.4f} ms, bound "
                  f"{max(big['bytes_ms'], big['ops_ms']):.4f} ms, floor "
                  f"{big['smem_floor_ms']:.4f} ms")
    for name in FLOAT_KERNELS:
        by_stage = {}
        for c in per_kernel[name]["calls"]:
            key = (c["stage"], c["hd"], c["Sq"], c["Sk"], c["H"], c["KV"],
                   c["causal"])
            by_stage.setdefault(key, []).append(c)
        for (stage, hd, sq, sk, h, kv, causal), calls in by_stage.items():
            n = len(calls)
            ms = sum(c["ms"] for c in calls)
            bound = sum(max(c["bytes_ms"], c["ops_ms"]) for c in calls)
            lib = sum(c["library_ms"] for c in calls)
            fma = (f" (3xTF32; on the FP32-FMA peak "
                   f"{sum(c['fma_ms'] for c in calls) / n:.4f} ms)"
                   if calls[0]["dtype"] == "torch.float32" else "")
            print(f"[numbers] {name} ({stage}) hd {hd}, Sq {sq}, Sk {sk}, "
                  f"H {h} / KV {kv}, "
                  f"{'causal' if causal else 'not causal'}: {n} "
                  f"launches, kernel {ms:.3f} ms, bound {bound:.3f} ms, "
                  f"plain {sum(c['plain_ms'] for c in calls):.3f} ms, "
                  f"library {lib:.3f} ms; per launch kernel {ms / n:.4f} "
                  f"ms, bound {bound / n:.4f} ms{fma} ({ms / bound:.2f}x), "
                  f"{LIBRARY_CALLS[name]} {lib / n:.4f} ms "
                  f"({ms / lib:.2f}x)")
        for route, calls in _flash_routes(
                per_kernel[name]["calls"], _hopper_head_dims(name)).items():
            print(f"[numbers] {name}, {route}: {len(calls)} launches, "
                  f"kernel {sum(c['ms'] for c in calls):.3f} ms, bound "
                  f"{sum(max(c['bytes_ms'], c['ops_ms']) for c in calls):.3f}"
                  f" ms, plain {sum(c['plain_ms'] for c in calls):.3f} ms, "
                  f"library {sum(c['library_ms'] for c in calls):.3f} ms")
    print("[numbers] kernel device ms by stage of the slice: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "replayed": r["replayed"],
            "max_abs_err": float_err.get(name, 0.0)
            if name in FLOAT_KERNELS else max(errs), "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["library_ms"] if r["library_launches"]
            else None})
        lib = (f"; library ({LIBRARY_CALLS[name]}) {r['library_ms']:.3f} "
               f"ms over the {r['library_launches']} launches it computes, "
               f"where the kernel took {r['library_kernel_ms']:.3f} ms"
               if r["library_launches"] else "")
        print(f"[numbers] {name}: {len(r['calls'])} launches of the slice "
              f"replayed: kernel {r['ms']:.3f} ms on the device "
              f"({r['call_ms']:.3f} ms timed with the wrapper's host "
              f"work), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms (bytes {r['bytes_ms']:.3f} ms, "
              f"operations {r['ops_ms']:.3f} ms){lib}; max abs err against "
              f"the plain version {rows[-1]['max_abs_err']:.3g}"
              + (f" (tolerance {FLASH_TOL['bfloat16']:g} bf16, "
                 f"{FLASH_TOL['float32']:g} float32, of the RMS plus each "
                 f"element; largest share used {r['gate_share']:.3g}, the "
                 f"library call against the kernel "
                 f"{r['library_gate_share']:.3g})"
                 if name in FLOAT_KERNELS and r["replayed"] else ""))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every launch's numbers here")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout that holds "
              "src/repro_torch", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: chip_smoke.py needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import hw
    from repro_torch.kernels import _build
    from repro_torch.service import WorkloadSpec, build_service

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    global CARD
    CARD = hw.current()
    int_rate = CARD.int32_lanes_per_sm * props.multi_processor_count \
        * max_mhz * 1e6
    print(f"[device] {torch.cuda.get_device_name(0)}: "
          f"{props.multi_processor_count} SMs, max SM clock {max_mhz:.0f} "
          f"MHz -> int32 rate {int_rate / 1e12:.2f} Top/s; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    dry = []
    try:
        phase_build(_build)
        dry = start_dryruns()
        small = WorkloadSpec(n_tenants=4, n_weeks=3,
                             domain_bits=(1 << 20) + 32 * 37 + 5,
                             n_queries=96)
        max_err = phase_kernels(torch, build_service(small, device="cuda"),
                                small)
        sm90 = phase_sm90_report(_build)
        off_path, gate_shares = {}, {}
        float_err = {"flash_attention": phase_flash_kernels(
            torch, max_mhz * 1e6, off_path, gate_shares)}
        float_err.update(phase_train_kernels(torch, max_mhz * 1e6,
                                             off_path, gate_shares))
        _print_off_path(off_path)
        phase_moe_ffn(torch)
        spec = spec3a = WorkloadSpec(n_tenants=4, n_weeks=3,
                                     domain_bits=1 << 24, n_queries=96)
        numbers = Numbers(max_err, float_err)
        rec = Recorder()
        try:
            launches, slice_info, clean = phase_slice(torch, spec, rec)
            later = [phase_plane_helpers(torch, clean, rec),
                     phase_direct(torch, rec),
                     phase_reliability(torch, clean, rec),
                     phase_arith(torch, rec)]
            ref3a = {k: clean[k] for k in ("queries", "mat", "scalars",
                                           "mat_values")}
            del clean
            later.append(phase_lm(torch, rec))
            # phase 4 for 3a-3e first, which frees their recorded
            # arguments before training records its own
            phase_numbers(torch, rec.calls, numbers, int_rate,
                          max_mhz * 1e6)
            rec.drop()
            later.append(phase_train(torch, rec))
            # phase 4 for 3f, which frees its recorded arguments before
            # 3q(a) and the MoE model takes 37 GB of the card
            phase_numbers(torch, rec.calls, numbers, int_rate,
                          max_mhz * 1e6)
            rec.drop()
            later.append(phase_remat_dots(torch, later[-1][1]))
            later.append(phase_f32(torch, rec))
            # phase 4 for 3s before the MoE models take the card
            phase_numbers(torch, rec.calls, numbers, int_rate,
                          max_mhz * 1e6)
            rec.drop()
            for spec in MOE_PHASES:
                later.append(phase_moe(torch, rec, *spec))
            later.append(phase_paper(torch, rec))
            # phase 4 for 3g-3h, which frees their recorded arguments
            # before the serving families take the card
            phase_numbers(torch, rec.calls, numbers, int_rate,
                          max_mhz * 1e6)
            rec.drop()
            for spec in FAMILY_PHASES:
                later.append(phase_family(torch, rec, *spec))
            # phase 4 for 3i-3k, which frees their recorded arguments
            # before training takes the card
            phase_numbers(torch, rec.calls, numbers, int_rate,
                          max_mhz * 1e6)
            rec.drop()
            for spec in TRAIN_FAMILY_PHASES + TRAIN_MOE_PHASES:
                later.append(phase_train_family(torch, rec, *spec))
                # phase 4 for each model before the next takes the card
                if rec.calls:
                    phase_numbers(torch, rec.calls, numbers, int_rate,
                                  max_mhz * 1e6)
                rec.drop()
            later.append(phase_cluster(torch, spec3a, ref3a))
            later.append(phase_mesh(torch, max_mhz * 1e6, dry))
        finally:
            rec.close()
        # each kernel's launches over every main-path run
        for counts, info in later:
            slice_info.update(info)
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        slice_info.update(phase_roofline(torch, slice_info)[1])
        rows = kernel_rows(numbers, launches)
    except SmokeFailure as e:
        print(f"[fail] {e}", file=sys.stderr)
        return 1
    finally:
        stop_dryruns(dry)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps({
            "card": card, "int32_ops_per_s": int_rate, "slice": slice_info,
            "ptxas_sm90": sm90,
            "kernel_ms_by_stage": numbers.stages,
            "off_path_flash": off_path, "flash_gate_shares": gate_shares,
            "kernels": rows, "launches": numbers.per_kernel}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
