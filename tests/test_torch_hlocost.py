"""The port's cost model: `launch.hlocost.count` on ``meta``.

One product counts 2 M N K FLOPs exactly and its operand and output
bytes (also as ``dot_bytes``); an elementwise op its operands' and
output's bytes and one FLOP per output element; a reduction one FLOP per
input element; views and allocations nothing. The flash wrappers called
on ``meta`` under a count charge `kernels.flashattn.flash_cost` (the
serving forward, the lse forward and the backward) and raise outside
one. `count` raises for a tensor on any device but ``meta``. A reduced
train step of every family, planned by `launch.plans.plan_for` and
counted on ``meta``, gives finite FLOPs with a useful ratio in (0, 1]
once the token table's lookup (which 6 N D counts and no product
computes) is left out of the model FLOPs (`launch.roofline.useful_flops`),
its flash FLOPs those of its launches, and fewer
FLOPs under ``remat="dots"`` than under "block"; a reduced prefill of
every family counts at least `useful_flops` (which also leaves out the
head at all but the last position), where 2 N D passes the count. The MoE dispatch's
static-size count (which ``meta`` can run) equals ``torch.bincount``.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import configs as TC
from repro_torch import hw
from repro_torch.kernels import flashattn as F
from repro_torch.kernels import ops as kops
from repro_torch.launch import hlocost, roofline
from repro_torch.launch.plans import plan_for
from repro_torch.models import build, input_specs
from repro_torch.models import moe as tmoe
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.train import make_train_step


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_one_product_counts_2mnk_exactly():
    M, K, N = 37, 129, 65
    c = hlocost.count(torch.mm, meta(M, K), meta(K, N))
    assert c.flops == 2 * M * N * K
    assert c.bytes == c.dot_bytes == 4 * (M * K + K * N + M * N)
    # the weight product of the models: bmm with a batch of 1
    B, S, D, H, hd = 2, 7, 16, 3, 8
    c = hlocost.count(lambda x, w: torch.einsum("bsd,dhk->bshk", x, w),
                      meta(B, S, D, dtype=torch.bfloat16),
                      meta(D, H, hd, dtype=torch.bfloat16))
    assert c.flops == 2 * B * S * D * H * hd
    assert c.dot_bytes == 2 * (B * S * D + D * H * hd + B * S * H * hd)
    c = hlocost.count(torch.addmm, meta(N), meta(M, K), meta(K, N))
    assert c.flops == 2 * M * N * K + M * N


def test_elementwise_reduction_and_view_costs():
    a, b = meta(4, 5), meta(4, 5)
    c = hlocost.count(torch.add, a, b)
    assert (c.flops, c.bytes, c.dot_bytes) == (20, 3 * 80, 0)
    c = hlocost.count(lambda x: x.to(torch.bfloat16), a)
    assert (c.flops, c.bytes) == (20, 80 + 40)
    c = hlocost.count(torch.exp, a)
    assert (c.flops, c.transcendentals, c.bytes) == (20, 20, 160)
    c = hlocost.count(lambda x: x.sum(-1), a)
    assert (c.flops, c.bytes) == (20, 80 + 16)
    c = hlocost.count(lambda x: (x.t(), x.view(20), x[1:3], x.reshape(2, 10),
                                 x.transpose(0, 1).unsqueeze(0),
                                 torch.empty(1 << 20, device="meta")), a)
    assert c == hlocost.Cost()
    c = hlocost.count(lambda x: x.copy_(b), a)
    assert c.bytes == 2 * 80 and c.flops == 0


def _qkv(B=2, Sq=96, Sk=96, H=4, KV=2, hd=32, dtype=torch.bfloat16):
    return (meta(B, Sq, H, hd, dtype=dtype), meta(B, Sk, KV, hd, dtype=dtype),
            meta(B, Sk, KV, hd, dtype=dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(96, 96), (40, 100), (130, 64)])
def test_meta_flash_calls_charge_flash_cost(causal, Sq, Sk):
    q, k, v = _qkv(Sq=Sq, Sk=Sk)
    out = {}

    def serve(q, k, v):
        out["o"] = F.flash_attention_kernel(q, k, v, causal=causal)

    c = hlocost.count(serve, q, k, v)
    flops, nbytes = F.flash_cost("flash_attention", q, k, causal)
    assert c.kernel_flops == {"flash_attention": flops}
    assert (c.flops, c.bytes, c.dot_bytes) == (flops, nbytes, nbytes)
    assert out["o"].is_meta and out["o"].shape == q.shape

    def fwd(q, k, v):
        out["o"], out["lse"] = F.flash_attention_fwd_kernel(q, k, v, causal)

    c = hlocost.count(fwd, q, k, v)
    flops, nbytes = F.flash_cost("flash_attention_fwd", q, k, causal)
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert tuple(out["lse"].shape) == (2, 4, Sq)
    assert out["lse"].dtype == torch.float32

    def bwd(q, k, v):
        out["g"] = F.flash_attention_bwd_kernel(q, k, v, out["o"],
                                                out["lse"], out["o"], causal)

    c = hlocost.count(bwd, q, k, v)
    flops, nbytes = F.flash_cost("flash_attention_bwd", q, k, causal)
    assert c.kernel_flops == {"flash_attention_bwd": flops}
    # and the card's rowsum(o do): one float32 product and reduction
    assert c.flops > flops and c.bytes > nbytes
    assert [tuple(g.shape) for g in out["g"]] == [tuple(q.shape),
                                                  tuple(k.shape),
                                                  tuple(k.shape)]
    # the pair count: query i sees keys 0..i when causal
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    assert F.flash_cost("flash_attention", q, k, causal)[0] == \
        4 * 2 * 4 * 32 * pairs


def test_meta_flash_outside_a_count_raises():
    q, k, v = _qkv()
    for call in (lambda: F.flash_attention_kernel(q, k, v),
                 lambda: F.flash_attention_fwd_kernel(q, k, v),
                 lambda: kops.flash_attention(q, k, v)):
        with pytest.raises(ValueError, match="only under launch.hlocost"):
            call()


def test_count_raises_off_meta():
    with pytest.raises(ValueError, match="meta tensors only"):
        hlocost.count(torch.mm, torch.ones(2, 2), meta(2, 2))
    model, _ = build(TC.reduced(TC.get_config("qwen3_0p6b")),
                     device="cpu").abstract()
    model.embed.tok = torch.nn.Parameter(torch.zeros(
        model.embed.tok.shape[0], 1), requires_grad=False)
    with pytest.raises(ValueError, match="on cpu"):
        hlocost.count(lambda m: None, model)
    assert hlocost.count(lambda: None) == hlocost.Cost()


def test_moe_static_count_equals_bincount():
    g = torch.Generator().manual_seed(0)
    for E, T, k in ((8, 40, 2), (64, 7, 1), (5, 300, 3)):
        idx = torch.randint(0, E, (T, k), generator=g)
        d = tmoe.dispatch(idx, E, tmoe.expert_capacity(
            dataclasses.replace(TC.get_config("kimi_k2_1t_a32b"),
                                n_experts=E, top_k=k), T))
        assert torch.equal(d.counts, torch.bincount(idx.reshape(-1),
                                                    minlength=E))
        assert d.counts.dtype == torch.int64


def _count_step(cfg, shape, remat=None):
    """(Roofline, Cost) of one planned train step of ``cfg`` on meta."""
    plan = plan_for(cfg, shape)
    accum = plan.grad_accum
    while accum > 1 and shape.global_batch % accum:
        accum //= 2
    bundle = build(cfg, device="cpu", remat=remat or plan.remat)
    params, _ = bundle.abstract()
    opt = get_optimizer(plan.optimizer, warmup_cosine(3e-4, 100, 10_000))
    state = opt.init(params)
    batch = input_specs(cfg, shape)
    cost = hlocost.count(make_train_step(bundle, opt, grad_accum=accum),
                         params, state, 0, batch)
    r = roofline.analyze(cost, cfg, shape, "1", 1, plan.arch,
                         hlocost.tensor_bytes(params, state, batch),
                         card=hw.H100_SXM)
    return r, cost


SHAPE = TC.ShapeConfig("train_small", 32, 2, "train")


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_reduced_train_step_counts_of_every_family(arch):
    cfg = TC.reduced(TC.get_config(arch))
    r, cost = _count_step(cfg, SHAPE)
    d = r.to_dict()
    assert math.isfinite(cost.flops) and cost.flops > 0
    # 6 N D counts the token table (a quarter of N at reduced widths), a
    # lookup no product computes: the ratio may pass 1 by that much (up
    # to 6% here; 0.706 at Qwen3-0.6B's published widths), and without
    # it every useful FLOP is among the counted ones
    assert 0 < d["useful_flops_ratio"] < 1.1
    assert 0 < roofline.useful_flops(cfg, SHAPE) / cost.flops <= 1
    assert 0 < cost.dot_bytes < cost.bytes
    assert d["bytes_per_device"] > sum(
        p.numel() * p.element_size()
        for p in build(cfg, device="cpu").abstract()[0].parameters())
    assert d["collective_bytes"] == 0 and d["collective_by_kind"] == {}
    if cfg.family in ("dense", "moe"):
        # "block": per layer the lse forward twice (the forward and its
        # recompute) and the backward once, over the whole batch
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        q = meta(SHAPE.global_batch, SHAPE.seq_len, H, hd)
        k = meta(SHAPE.global_batch, SHAPE.seq_len, KV, hd)
        assert cost.kernel_flops == {
            "flash_attention_fwd": 2 * cfg.n_layers * F.flash_cost(
                "flash_attention_fwd", q, k, True)[0],
            "flash_attention_bwd": cfg.n_layers * F.flash_cost(
                "flash_attention_bwd", q, k, True)[0]}
    if arch in ("qwen3_0p6b", "kimi_k2_1t_a32b"):
        _, dots = _count_step(cfg, SHAPE, remat="dots")
        assert dots.flops < cost.flops
        assert dots.kernel_flops == cost.kernel_flops


PREFILL = TC.ShapeConfig("prefill_small", 32, 2, "prefill")


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_reduced_prefill_counts_at_least_the_useful_flops(arch):
    cfg = TC.reduced(TC.get_config(arch))
    bundle = build(cfg, device="cpu")
    params, _ = bundle.abstract()
    cost = hlocost.count(bundle.prefill, params, input_specs(cfg, PREFILL))
    assert math.isfinite(cost.flops) and cost.flops > 0
    # the prefill computes the head at the last position only: 2 N D,
    # which charges it at every position, passes the count
    assert 0 < roofline.useful_flops(cfg, PREFILL) / cost.flops <= 1
    assert roofline.model_flops(cfg, PREFILL) > cost.flops
