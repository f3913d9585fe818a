"""The pattern-driven hybrid (Nemotron-H) on the CPU at a tiny size with
every block kind of the published model (pattern ``MEM*E``: Mamba-2 with
2 groups of B / C, a sigmoid-routed dropless MoE of 8 relu^2 experts top
2 with a shared expert, NoPE attention), against the plain float32
reference of the benchmark (`perfbench/reference/nemotron_h.py`) on
seeded weights."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.reference import nemotron_h as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import nemotron_h as NH  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.obs import device as obs_device  # noqa: E402
from repro_torch.obs import taps  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

TINY = dict(block_pattern="MEM*E", n_layers=5, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=32, shared_d_ff=48,
            vocab_size=256, n_experts=8, top_k=2, ssm_state=16,
            ssm_head_dim=8, ssm_heads=8, ssm_groups=2, ssm_chunk=8,
            dtype="float32")


def _cfg(**change):
    return dataclasses.replace(get_config("nemotron3_nano_30b_a3b"),
                               **{**TINY, **change})


def ref_config(cfg):
    """The reference's keys (the published config's) for ``cfg``."""
    return {"hybrid_override_pattern": cfg.block_pattern,
            "mamba_num_heads": cfg.n_ssm_heads,
            "mamba_head_dim": cfg.ssm_head_dim, "n_groups": cfg.ssm_groups,
            "ssm_state_size": cfg.ssm_state, "conv_kernel": cfg.ssm_conv,
            "chunk_size": cfg.ssm_chunk, "layer_norm_epsilon": cfg.norm_eps,
            "num_experts_per_tok": cfg.top_k, "n_routed_experts": cfg.n_experts,
            "routed_scaling_factor": cfg.routed_scale,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_}


@torch.no_grad()
def _model(cfg, seed=0):
    """The registry's model with every term live: the selection bias,
    dt_bias, the conv bias and the norm scales drawn too."""
    bundle = build(cfg, device="cpu")
    g = torch.Generator("cpu").manual_seed(seed)
    model = bundle.init(g)
    for name, p in model.named_parameters():
        if name.endswith("e_bias"):
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        elif name.endswith(("dt_bias", "conv_b")):
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        elif name.endswith(("ln", "norm")):
            p.copy_(1 + torch.randn(p.shape, generator=g) * 0.1)
    return bundle, model


def _draw(model):
    params = dict(model.named_parameters())
    return lambda name: params[name].detach().float()


def _tokens(B=2, S=21, seed=1):
    g = torch.Generator("cpu").manual_seed(seed)
    return torch.randint(0, 256, (B, S), generator=g)


def _close(got, want, rel=1e-4):
    assert torch.allclose(got, want, atol=rel * float(want.abs().max())), \
        float((got - want).abs().max())


def test_full_forward_matches_the_reference():
    cfg = _cfg()
    bundle, model = _model(cfg)
    tokens = _tokens()
    x, aux = NH.pattern_apply(model, tokens, cfg)
    got = L.lm_logits(model.embed, x)
    want, routes = ref.last_logits(_draw(model), list(tokens), ref_config(cfg),
                                   every=True)
    _close(got, want)
    assert float(aux) == 0.0 and len(routes) == 2
    last, _ = bundle.prefill(model, {"tokens": tokens})
    _close(last, want[:, -1])


def test_prefill_then_decode_matches_the_full_forward():
    cfg = _cfg()
    bundle, model = _model(cfg, seed=3)
    tokens = _tokens(S=24, seed=4)
    S0 = 20
    want, _ = ref.last_logits(_draw(model), list(tokens), ref_config(cfg),
                              every=True)
    logits, cache = bundle.prefill(model, {"tokens": tokens[:, :S0]})
    assert set(cache) == {"ssm", "attn"}
    assert cache["ssm"]["state"].shape[0] == 2      # the M blocks
    assert cache["attn"]["k"].shape[:3] == (1, 2, S0)   # one * block
    from repro_torch.serve.kvcache import extend_cache
    cache = extend_cache(cache, 4)
    _close(logits, want[:, S0 - 1])
    for i in range(4):
        logits, cache = bundle.decode_step(model, tokens[:, S0 + i], cache,
                                           S0 + i)
        _close(logits, want[:, S0 + i])


def test_generate_serves_the_pattern_model():
    cfg = _cfg()
    bundle, model = _model(cfg, seed=5)
    tokens = _tokens(S=16, seed=6)
    ids = generate(bundle, model, {"tokens": tokens}, 3)
    assert ids.shape == (2, 3)
    want, _ = ref.last_logits(_draw(model), list(tokens), ref_config(cfg))
    assert torch.equal(ids[:, 0].long(), want.argmax(-1))


def test_dropless_routing_keeps_every_slot_of_one_expert():
    """Every token selects experts 3 and 5 (their selection bias is
    overwhelming): a capacity of 1.25 T k / E would drop most of them;
    dropless computes all, with weights from the scores alone."""
    cfg = _cfg()
    _, model = _model(cfg, seed=7)
    p = model.blocks[1].moe
    with torch.no_grad():
        p.e_bias.zero_()
        p.e_bias[3] = p.e_bias[5] = 100.0
    x = torch.randn(2, 30, cfg.d_model, generator=torch.Generator().manual_seed(8))
    with obs_device_window() as got:
        y, aux = M.moe_ffn(p, x, cfg)
    w = {k: v.detach().float() for k, v in p.named_parameters()}
    want, sel = ref.moe(x.reshape(-1, cfg.d_model), w, ref_config(cfg))
    assert set(sel.unique().tolist()) == {3, 5}
    _close(y.reshape(-1, cfg.d_model), want)
    assert got["counters"]["moe_slots_total"] == 120
    # the busiest expert holds half the slots: 4 x the mean over 8
    assert got["counters"]["moe_busiest_over_mean_total"] == pytest.approx(4.0)
    assert set(got["spans"]) == {"moe.route", "moe.experts", "moe.shared"}


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("kind", ["swiglu", "relu2"])
def test_dropless_matches_capacity_dispatch_when_nothing_drops(kind, router):
    """Dispatch, experts and router are settings of their own: with a
    capacity that holds every slot the two dispatches agree, for either
    kind of expert and either router."""
    cfg = _cfg(mlp_kind=kind, router=router, capacity_factor=8.0)
    g = torch.Generator().manual_seed(16)
    p = M.moe_init(g, cfg, "cpu")
    with torch.no_grad():
        if router == "sigmoid":
            p.e_bias.copy_(torch.randn(p.e_bias.shape, generator=g) * 0.2)
    x = torch.randn(2, 30, cfg.d_model, generator=g)
    y_cap, aux_cap = M.moe_ffn(p, x, cfg)
    y, aux = M.moe_ffn(p, x, dataclasses.replace(cfg, dropless=True))
    assert M.expert_capacity(cfg, 60) >= 60 * cfg.top_k
    _close(y, y_cap, 1e-5)
    assert float(aux) == pytest.approx(float(aux_cap))


class obs_device_window:
    """`obs.device` recording for a block, its reading in the target."""

    def __enter__(self):
        self.out = {}
        obs_device.start("cpu")
        return self.out

    def __exit__(self, *exc):
        self.out.update(obs_device.stop())
        return False


def test_grouped_products_fall_back_to_a_product_per_expert():
    g = torch.Generator().manual_seed(9)
    counts = torch.tensor([3, 0, 5, 1])
    x = torch.randn(9, 6, generator=g)
    w = torch.randn(4, 6, 7, generator=g)
    got = M.grouped_mm(x, w, counts)
    want = torch.cat([x[:3] @ w[0], x[3:8] @ w[2], x[8:] @ w[3]])
    assert torch.equal(got, want)


def test_one_group_is_the_existing_path():
    """``ssm_groups`` = 1 keeps `ssd_chunked` and the whole-width gated
    norm; the grouped scan at one group agrees with it."""
    g = torch.Generator().manual_seed(10)
    B, Sq, H, P, N = 2, 37, 4, 8, 16
    x = torch.randn(B, Sq, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, Sq, H, generator=g))
    a_log = torch.log(torch.rand(H, generator=g) * 15 + 1)
    Bm, Cm = (torch.randn(B, Sq, N, generator=g) for _ in range(2))
    init = torch.randn(B, H, P, N, generator=g)
    y1, s1 = S.ssd_chunked(x, dt, a_log, Bm, Cm, 8, init)
    y2, s2 = S.ssd_grouped(x, dt, a_log, Bm[:, :, None], Cm[:, :, None], 8,
                           init)
    _close(y2, y1, 1e-5)
    _close(s2, s1, 1e-5)
    cfg = get_config("mamba2_1p3b")
    assert cfg.ssm_groups == 1 and cfg.d_inner == 2 * cfg.d_model
    y, z, w = (torch.randn(3, 5, 32, generator=g) for _ in range(3))
    assert torch.equal(S.gated_norm(y, z, w[0, 0], cfg),
                       L.rmsnorm(y * torch.nn.functional.silu(z), w[0, 0],
                                 cfg.norm_eps))
    torch.manual_seed(0)
    base = get_config("zamba2_2p7b")
    old = S.SSM(dataclasses.replace(base, ssm_state=16, d_model=64), "cpu")
    assert old.in_proj.shape == (64, 2 * 128 + 2 * 16 + 2)


def test_grouped_scan_matches_the_reference_scan():
    g = torch.Generator().manual_seed(11)
    B, Sq, H, P, G, N = 2, 29, 8, 4, 2, 5
    x = torch.randn(B, Sq, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, Sq, H, generator=g))
    a_log = torch.log(torch.rand(H, generator=g) * 15 + 1)
    Bm, Cm = (torch.randn(B, Sq, G, N, generator=g) for _ in range(2))
    y, _ = S.ssd_grouped(x, dt, a_log, Bm, Cm, 8)
    A = -torch.exp(a_log)
    for b in range(B):
        want = ref.ssd(x[b] * dt[b][..., None], A * dt[b],
                       Bm[b].repeat_interleave(H // G, 1),
                       Cm[b].repeat_interleave(H // G, 1), 16)
        _close(y[b], want, 1e-5)


def test_loss_and_gradients_through_the_registry():
    from repro_torch.train.step import trainable

    cfg = _cfg()
    bundle, model = _model(cfg, seed=12)
    params = trainable(model)
    tokens = _tokens(S=16, seed=13)
    loss, metrics = bundle.loss(model, {"tokens": tokens, "labels": tokens})
    loss.backward()
    assert torch.isfinite(loss) and float(metrics["aux"]) == 0.0
    grads = {n: p.grad for n, p in params.items()}
    # the selection bias only selects: no gradient reaches it
    assert {n for n, g in grads.items() if g is None} == \
        {"blocks.1.moe.e_bias", "blocks.4.moe.e_bias"}
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0
               for g in grads.values() if g is not None)


def test_config_counts_the_published_model():
    cfg = get_config("nemotron3_nano_30b_a3b")
    assert cfg.block_pattern.count("M") == 23
    assert cfg.block_pattern.count("E") == 23
    assert cfg.block_pattern.count("*") == 6
    assert cfg.d_inner == 4096 and cfg.n_ssm_heads == 64
    model, specs = build(cfg, device="cpu").abstract()
    assert sum(p.numel() for p in model.parameters()) == 31_577_940_288
    assert specs["blocks.1.moe.wi"] == ("experts", "fsdp", "mlp")
    with pytest.raises(ValueError):
        build(dataclasses.replace(cfg, n_layers=51), device="cpu").abstract()


def test_spans_record_device_time_only_inside_a_window():
    cfg = _cfg()
    bundle, model = _model(cfg, seed=14)
    tokens = _tokens(S=16, seed=15)
    bundle.prefill(model, {"tokens": tokens})
    assert obs_device.stop() == {"spans": {}, "counters": {}}
    with obs_device_window() as got:
        bundle.prefill(model, {"tokens": tokens})
    assert set(got["spans"]) == {"ssm.mixer", "moe.route", "moe.experts",
                                 "moe.shared"}
    assert got["counters"]["ssd_chunks_total"] == 2 * 2 * 2
    assert got["counters"]["moe_calls_total"] == 2


def test_taps_hand_each_block_to_a_reader_only_while_reading():
    """Prefill hands each block's input and mixer output, each MoE
    block's experts and the final norm's input to the reader: each
    block's input is the previous one's plus its mixer's output, and the
    experts are the ones the router selects."""
    cfg = _cfg()
    bundle, model = _model(cfg, seed=17)
    tokens = _tokens(S=16, seed=18)
    got = []
    bundle.prefill(model, {"tokens": tokens})
    with taps.reading(lambda site, v: got.append((site, v))):
        logits, _ = bundle.prefill(model, {"tokens": tokens})
    bundle.prefill(model, {"tokens": tokens})
    assert [s for s, _ in got] == ["block", "moe.route", "block", "block",
                                   "block", "moe.route", "block", "final"]
    blocks = [v for s, v in got if s == "block"]
    assert [v["index"] for v in blocks] == list(range(5))
    for a, b in zip(blocks, blocks[1:]):
        assert torch.equal(b["x"], a["x"] + a["y"])
    last = blocks[-1]["x"] + blocks[-1]["y"]
    assert torch.equal(got[-1][1]["x"], last[:, -1])
    h = L.rmsnorm(blocks[1]["x"], model.blocks[1].ln, cfg.norm_eps)
    _, _, idx = M.route_sigmoid(model.blocks[1].moe.router,
                                model.blocks[1].moe.e_bias,
                                h.reshape(-1, cfg.d_model), cfg.top_k,
                                cfg.routed_scale)
    assert torch.equal(got[1][1]["idx"], idx)
    want, _ = ref.last_logits(_draw(model), list(tokens), ref_config(cfg))
    _close(logits, want)
