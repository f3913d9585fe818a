"""Port parity: MoE serving (`models.moe`, the MoE family's layer layout,
prefill and decode) on the CPU.

The reference's parameters (`repro.models.moe.moe_init`, or
``build(cfg).init(PRNGKey(0))`` for a whole model) are carried into the
port, and both packages run the same numpy-drawn activations or prompts.
Held: `expert_capacity` exactly; `moe_ffn`'s output and aux loss (float32
to 1e-5 of the output's largest magnitude and 1e-5 relative; bf16 to 0.05
of it, the bound of `tests/test_torch_models.py`), with top-1 and top-2
routing and at a capacity that drops tokens, whose count must equal a
numpy recount from the router's ids; every carried leaf bit for bit; and
for reduced `llama4_maverick_400b_a17b` (one dense and one MoE layer per
super-layer) and `kimi_k2_1t_a32b` (a leading dense layer, then MoE
layers), prefill's logits and cache and four decode steps against the
reference's `bundle.prefill` (its Pallas flash kernel in interpret mode)
and `bundle.decode_step`: in float32 (1e-4 of the largest logit and
cache entry, as the dense models) at the configs' capacity factor and at
one that drops tokens, in bf16 (0.05 of the largest logit, the cache to
0.05 of its RMS) at the configs' capacity factor. The MoE loss (its
load-balancing term included) equals the reference's `bundle.loss`; its
training is held in `tests/test_torch_train_step_moe.py`."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.layers import attention_backend  # noqa: E402
from repro.serve.kvcache import extend_cache as rextend  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import (MoEBlock,  # noqa: E402
                                            layer_kinds)
from repro_torch.serve import extend_cache  # noqa: E402

MOE_ARCHS = ["llama4_maverick_400b_a17b", "kimi_k2_1t_a32b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 0.05}
FFN_TOL = {"float32": 1e-5, "bfloat16": 0.05}
#: a capacity factor at which the reduced configs drop tokens: capacity
#: is then the floor of 8 slots against a mean load of 16 or more
DROP_CF = 0.25


def _cfgs(arch, dtype, **kw):
    ref = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype,
                              **kw)
    port = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype,
                               **kw)
    return ref, port


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < tol, f"{what}: max error {err:.3g} of the reference's max"


def _close_rms(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.sqrt(((got - want) ** 2).mean() / ((want ** 2).mean() + 1e-30))
    assert err < tol, f"{what}: RMS error {err:.3g} of the reference's RMS"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _moe_from_reference(cfg, rp):
    """A port `MoE` holding the reference's MoE parameter dict."""
    p = tmoe.MoE(cfg, "cpu")
    for name, leaf in _leaves(rp):
        dst = p.get_parameter(name)
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return p


def test_expert_capacity_matches_reference():
    for arch in MOE_ARCHS:
        for cfg in (RC.get_config(arch), RC.reduced(RC.get_config(arch))):
            tcfg = dataclasses.replace(TC.get_config(arch),
                                       **dataclasses.asdict(cfg))
            for cf in (0.25, 1.0, 1.25, 2.0):
                for t in (1, 8, 48, 1000, 16_384):
                    r = dataclasses.replace(cfg, capacity_factor=cf)
                    p = dataclasses.replace(tcfg, capacity_factor=cf)
                    assert tmoe.expert_capacity(p, t) == \
                        rmoe.expert_capacity(r, t), (arch, cf, t)
    maverick = TC.get_config("llama4_maverick_400b_a17b")
    assert tmoe.expert_capacity(maverick, 8 * 2048) == 160
    assert tmoe.expert_capacity(maverick, 8) == 8


def _recount_drops(idx, n_experts, capacity):
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("top_k,n_shared,cf", [(1, 1, 1.25), (2, 0, 1.25),
                                               (1, 1, DROP_CF),
                                               (2, 1, DROP_CF)])
def test_moe_ffn_matches_reference(top_k, n_shared, cf, dtype):
    rcfg, cfg = _cfgs("llama4_maverick_400b_a17b", dtype, top_k=top_k,
                      n_shared_experts=n_shared, capacity_factor=cf)
    rp, _ = rmoe.moe_init(jax.random.PRNGKey(top_k), rcfg)
    tp = _moe_from_reference(cfg, rp)
    assert tp.router.dtype == torch.float32
    assert tp.wi.dtype == getattr(torch, dtype)
    B, S = 2, 64
    x = np.random.default_rng(7).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    rx = jnp.asarray(x).astype(rcfg.dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ry, raux = rmoe.moe_ffn(rp, rx, rcfg)
    ty, taux = tmoe.moe_ffn(tp, tx, cfg)
    assert ty.shape == (B, S, cfg.d_model) and ty.dtype == tx.dtype
    _close(ty, ry, FFN_TOL[dtype], "moe_ffn output")
    assert float(taux) == pytest.approx(float(raux), rel=1e-5)
    # the dispatch: the drops equal a recount from the router's ids
    T = B * S
    C = tmoe.expert_capacity(cfg, T)
    _, _, idx = tmoe.route(tp.router, tx.reshape(T, -1), top_k)
    d = tmoe.dispatch(idx, cfg.n_experts, C)
    dropped = int((~d.keep).sum())
    assert dropped == _recount_drops(idx, cfg.n_experts, C)
    assert int(d.counts.sum()) == T * top_k
    if cf == DROP_CF:
        assert dropped > 0
    # every slot lands in its expert's buffer once, below C or at C
    rows = d.sorted_e[d.keep] * C + d.dest_c[d.keep]
    assert len(set(rows.tolist())) == int(d.keep.sum())
    assert bool((d.dest_c[~d.keep] == C).all())
    assert torch.equal(d.sort_i[d.inv], torch.arange(T * top_k))


def test_route_breaks_ties_to_the_lower_expert():
    router = torch.zeros(4, 6)
    _, gate, idx = tmoe.route(router, torch.ones(3, 4), 2)
    assert idx.tolist() == [[0, 1]] * 3
    assert torch.allclose(gate, torch.full((3, 2), 0.5))


@functools.lru_cache(None)
def _models(arch, dtype, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    rcfg, cfg = _cfgs(arch, dtype, **kw)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    return rb, rp, build(cfg, device="cpu"), \
        model_params_from_reference(cfg, rp, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_every_moe_leaf(arch):
    rb, rp, tb, tp = _models(arch, "float32", None)
    cfg = tb.cfg
    kinds = layer_kinds(cfg)
    blocks = tp.blocks()
    assert len(kinds) == len(blocks) == cfg.n_layers
    assert [isinstance(b, MoEBlock) for b in blocks] == \
        [k == "moe" for k in kinds]
    if arch.startswith("llama4"):
        assert kinds == ("dense", "moe") * (cfg.n_layers // 2)
    else:
        assert kinds == ("dense",) + ("moe",) * (cfg.n_layers - 1)
    layer = 0
    ref_blocks = [(rp["lead"], (i,)) for i in range(cfg.n_dense_layers)]
    n_groups = (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every
    for g in range(n_groups):
        ref_blocks += [(rp["groups"]["dense"], (g, j))
                       for j in range(cfg.moe_every - 1)]
        ref_blocks.append((rp["groups"]["moe"], (g,)))
    for (tree, index), block in zip(ref_blocks, blocks):
        names = dict(block.named_parameters())
        leaves = dict(_leaves(tree))
        assert set(names) == set(leaves), layer
        for name, leaf in leaves.items():
            want = np.array(leaf, np.float32)[index]
            np.testing.assert_array_equal(_f32(names[name]), want)
        layer += 1
    dense_ff = cfg.dense_d_ff or cfg.d_ff
    # the parameters are named by the reference's tree: lead.<i>,
    # groups.<g>.dense.<j>, groups.<g>.moe
    names = {n.split(".")[0] for n, _ in tp.named_parameters()}
    assert names == {"embed", "final_norm", "groups"} | (
        {"lead"} if cfg.n_dense_layers else set())
    for block in blocks:
        if not isinstance(block, MoEBlock):
            assert block.mlp.wo.shape == (dense_ff, cfg.d_model)
        else:
            assert block.moe.shared.wo.shape == (
                cfg.d_ff * cfg.n_shared_experts, cfg.d_model)


B, S, N_DECODE = 2, 64, 4


def _prompts():
    return np.random.default_rng(2025).integers(0, 512, (B, S + N_DECODE),
                                                dtype=np.int32)


#: the drop case runs in float32: which slots are dropped is a
#: discontinuous function of the activations (one token routed elsewhere
#: shifts the rank of every later token of two experts), and bf16
#: activations that differ in their last place between the packages can
#: drop other tokens; `test_moe_ffn_matches_reference` holds the dropping
#: dispatch itself to the reference in bf16, on equal inputs
@pytest.mark.parametrize("dtype,cf", [("float32", None),
                                      ("float32", DROP_CF),
                                      ("bfloat16", None)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, cf):
    rb, rp, tb, tp = _models(arch, dtype, cf)
    tol = TOL[dtype]
    toks = _prompts()
    with attention_backend("flash"):
        rl, rc = jax.jit(lambda p, b: rb.prefill(p, b))(
            rp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tb.prefill(tp, {"tokens": toks[:, :S]})
    assert tl.shape == (B, tb.cfg.padded_vocab)
    _close(tl, rl, tol, "prefill logits")
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == rc[name].shape
        # bf16: a token whose router probabilities nearly tie may go to
        # another expert, whose keys and values in later layers are then
        # outliers by any elementwise bound: the cache is held by its RMS
        (_close if dtype == "float32" else _close_rms)(
            tc[name], rc[name], tol, f"cache {name}")
    rc, tc = rextend(rc, N_DECODE), extend_cache(tc, N_DECODE)
    step = jax.jit(rb.decode_step)
    for i in range(N_DECODE):
        tok = toks[:, S + i]
        rl, rc = step(rp, jnp.asarray(tok), rc, jnp.int32(S + i))
        tl, tc = tb.decode_step(tp, tok, tc, S + i)
        _close(tl, rl, tol, f"decode step {i} logits")
    if dtype == "float32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(rl.argmax(-1)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_drops_tokens_at_the_small_capacity(arch):
    """The drop case of the model test really drops: the first MoE
    layer's router, on the prefill's own activations, overfills an
    expert."""
    _, _, tb, tp = _models(arch, "float32", DROP_CF)
    cfg = tb.cfg
    seen = []
    orig = tmoe.dispatch

    def spy(idx, n_experts, capacity):
        d = orig(idx, n_experts, capacity)
        seen.append((int((~d.keep).sum()),
                     _recount_drops(idx, n_experts, capacity)))
        return d

    tmoe.dispatch = spy
    try:
        tb.prefill(tp, {"tokens": _prompts()[:, :S]})
    finally:
        tmoe.dispatch = orig
    assert len(seen) == layer_kinds(cfg).count("moe")
    assert all(a == b for a, b in seen) and seen[0][0] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_matches_reference(arch):
    """The MoE loss is finite and equals the reference's, its xent and
    its aux (the load-balancing loss summed over the MoE layers) too, in
    float32 to 1e-5 relative."""
    rb, rp, tb, tp = _models(arch, "float32", None)
    toks = _prompts()
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    rl, rm = rb.loss(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tm = tb.loss(tp, batch)
    assert bool(torch.isfinite(tl))
    assert float(tl) == pytest.approx(float(rl), rel=1e-5)
    for k in ("xent", "aux"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    assert float(tm["aux"]) > 0


def test_serve_cli_runs_a_moe_arch_on_the_cpu(capsys):
    for arch in MOE_ARCHS:
        assert tserve.main(["--arch", arch, "--device", "cpu", "--batch",
                            "2", "--prompt-len", "8", "--max-new", "3"]) == 0
        out = capsys.readouterr().out
        assert "generated (2, 3)" in out and "on cpu" in out


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_kimi_head_dim_matches_reference(causal):
    """Head dim 112 (Kimi K2's): the flash kernels' plain version against
    the reference's Pallas kernel in interpret mode, in float32 (2e-3 of
    the output's largest magnitude, the reference tests' bound); the card
    takes this head dim too (`flashattn.HEAD_DIMS`)."""
    from repro.kernels.flashattn import flash_attention as rflash
    from repro_torch.kernels import flashattn as tflash

    assert 112 in tflash.HEAD_DIMS
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((1, 80, 4 if i == 0 else 2, 112))
               .astype(np.float32) for i in range(3))
    want = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=32, block_k=32)
    got = tflash.flash_attention_kernel(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, 32, 32)
    _close(got, want, 2e-3, "flash attention at head dim 112")
