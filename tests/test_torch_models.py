"""Port parity: the LM serving path (dense family), on the CPU.

The JAX package's parameters (``build(cfg).init(PRNGKey(0))``) are
carried into the port with `convert.model_params_from_reference`, and
both packages run the same numpy-drawn prompts at the reduced widths
(`configs.reduced`: 4 layers, d_model 128, 4 heads, 2 KV heads, head_dim
32). Held: prefill's last-position logits, the KV cache, the decode step
after `extend_cache`, and greedy `generate` ids. In float32 (the configs
with ``dtype="float32"``) the tolerance is 1e-4 of the reference's
largest magnitude, where only the order of float32 sums differs; in bf16
the largest difference stays below 0.05 of it (the bound
`tests/test_models.py` holds decode to prefill with), since one bf16
rounding that lands the other way moves a value by 2^-8. The reference
runs both of its attention backends: the pure-jnp online softmax and the
Pallas kernel in interpret mode. `jax.random` bits are not reproduced:
the port's own draws (weights, sampling) are checked for determinism,
shape and range."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.models.layers import attention_backend  # noqa: E402
from repro.serve.kvcache import extend_cache as rextend  # noqa: E402
from repro.serve.step import generate as rgenerate  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import (cache_bytes, extend_cache, generate,  # noqa
                               make_serve_step)

ARCHS = ["qwen3_0p6b", "qwen3_8b"]
# the dense configs' other branches: qkv bias (Qwen1.5), no qk-norm
# (DeepSeek)
DENSE_ARCHS = ARCHS + ["qwen1p5_110b", "deepseek_67b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 0.05}
B, S = 2, 24


def _cfgs(arch, dtype):
    ref = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype)
    port = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype)
    return ref, port


@functools.lru_cache(None)
def _models(arch, dtype):
    """(reference bundle, its params, port bundle, port params)."""
    rcfg, cfg = _cfgs(arch, dtype)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    return rb, rp, build(cfg, device="cpu"), \
        model_params_from_reference(cfg, rp, device="cpu")


def _fresh(rb):
    """``rb`` with a prefill that `jax.jit` has not traced yet: the jit
    cache is keyed by the function, not by the process-wide attention
    backend, so a cached trace would silently keep the other backend."""
    return dataclasses.replace(rb, prefill=lambda p, b: rb.prefill(p, b))


def _ref_prefill(rb, rp, backend, tokens, monkeypatch):
    """The reference's prefill under ``backend``; with "flash" it must
    reach the Pallas kernel."""
    import repro.kernels.flashattn as rflash

    calls = []
    orig = rflash.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(rflash, "flash_attention", spy)
    with attention_backend(backend):
        out = jax.jit(_fresh(rb).prefill)(rp, {"tokens": jnp.asarray(tokens)})
    assert bool(calls) == (backend == "flash")
    return out


def _prompts():
    return np.random.default_rng(2024).integers(0, 512, (B, S + 1),
                                                dtype=np.int32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < tol, f"{what}: max error {err:.3g} of the reference's max"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _split_fields(port_cfg):
    """The port's config as (the reference's fields, the port's own:
    settings of architectures the reference does not hold)."""
    ref_names = {f.name for f in dataclasses.fields(RC.ModelConfig)}
    d = dataclasses.asdict(port_cfg)
    return ({k: v for k, v in d.items() if k in ref_names},
            {k: v for k, v in d.items() if k not in ref_names})


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_are_the_reference_copies(arch):
    port, own = _split_fields(TC.get_config(arch))
    assert port == dataclasses.asdict(RC.get_config(arch))
    port_r, own_r = _split_fields(TC.reduced(TC.get_config(arch)))
    assert port_r == dataclasses.asdict(RC.reduced(RC.get_config(arch)))
    # the port's own fields hold their defaults: the reference's behaviour
    defaults = {f.name: f.default for f in dataclasses.fields(TC.ModelConfig)}
    assert own == own_r == {k: defaults[k] for k in own}
    assert TC.get_config(arch).padded_vocab == RC.get_config(arch).padded_vocab


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["chunked", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, backend,
                                            monkeypatch):
    rb, rp, tb, tp = _models(arch, dtype)
    tol = TOL[dtype]
    toks = _prompts()
    rl, rc = _ref_prefill(rb, rp, backend, toks[:, :S], monkeypatch)
    before = LAUNCHES["flash_attention"]
    tl, tc = tb.prefill(tp, {"tokens": toks[:, :S]})
    assert LAUNCHES["flash_attention"] == before     # CPU: plain version
    assert tl.shape == (B, tb.cfg.padded_vocab)
    assert tl.dtype == tp.embed.tok.dtype
    _close(tl, rl, tol, "prefill logits")
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == rc[name].shape
        _close(tc[name], rc[name], tol, f"cache {name}")
    rc, tc = rextend(rc, 4), extend_cache(tc, 4)
    rl2, _ = jax.jit(rb.decode_step)(rp, jnp.asarray(toks[:, S]), rc,
                                     jnp.int32(S))
    tl2, tc = tb.decode_step(tp, toks[:, S], tc, S)
    _close(tl2, rl2, tol, "decode logits")
    assert tuple(tc["k"].shape) == (tb.cfg.n_layers, B, S + 4,
                                    tb.cfg.n_kv_heads * tb.cfg.head_dim_)


@pytest.mark.parametrize("backend", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch, backend):
    rb, rp, tb, tp = _models(arch, "float32")
    toks = _prompts()[:, :S]
    max_new = 6
    # every step's pick must be clear of a near-tie at the tolerance
    logits, cache = tb.prefill(tp, {"tokens": toks})
    cache = extend_cache(cache, max_new)
    for i in range(max_new):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > TOL["float32"] * logits.abs().max().item(), i
        logits, cache = tb.decode_step(tp, logits.argmax(-1), cache, S + i)
    with attention_backend(backend):
        want = rgenerate(_fresh(rb), rp, {"tokens": jnp.asarray(toks)},
                         max_new)
    got = generate(tb, tp, {"tokens": toks}, max_new)
    assert got.shape == (B, max_new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_forward_matches_reference(mlp_kind):
    """`transformer_apply`'s hidden states in float32, with the SwiGLU and
    the GELU MLP."""
    from repro.models.transformer import transformer_apply as rapply
    from repro_torch.models.transformer import transformer_apply

    rcfg, cfg = (dataclasses.replace(c, mlp_kind=mlp_kind)
                 for c in _cfgs("qwen3_0p6b", "float32"))
    rp = rbuild(rcfg).init(jax.random.PRNGKey(1))
    toks = _prompts()
    want, _ = jax.jit(lambda p, t: rapply(p, t, rcfg))(rp, jnp.asarray(toks))
    got, aux = transformer_apply(
        model_params_from_reference(cfg, rp, device="cpu"),
        torch.from_numpy(toks).long(), cfg)
    _close(got, want, TOL["float32"], "hidden states")
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """prefill(S) + decode_step(token_S) == prefill(S + 1)'s last logits,
    in the configs' own bf16, with seeded port weights."""
    cfg = TC.reduced(TC.get_config(arch))
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_prompts()).long()
    want, _ = bundle.prefill(params, {"tokens": toks})
    _, cache = bundle.prefill(params, {"tokens": toks[:, :S]})
    step = make_serve_step(bundle)
    got, _ = step(params, toks[:, S], extend_cache(cache, 8), S)
    _close(got, want, 0.05, "decode vs prefill")


def test_init_is_deterministic_per_generator():
    cfg = TC.reduced(TC.get_config("qwen3_0p6b"))
    bundle = build(cfg, device="cpu")
    a = bundle.init(torch.Generator().manual_seed(1))
    b = bundle.init(torch.Generator().manual_seed(1))
    c = bundle.init(torch.Generator().manual_seed(2))
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(x, y), name
        assert x.dtype == torch.bfloat16 and not x.requires_grad
        if name.endswith(("wq", "head")):
            assert not torch.equal(x, z), name
            assert abs(x.float().std().item() - 0.02) < 2e-3, name
    assert torch.equal(a.layers[0].ln1, torch.ones_like(a.layers[0].ln1))


def test_sampling_is_deterministic_per_generator():
    cfg = TC.reduced(TC.get_config("qwen3_0p6b"))
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _prompts()[:, :S]}

    def sample(seed):
        return generate(bundle, params, batch, 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (B, 5) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < cfg.padded_vocab


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_build_serves_every_family_and_trains_all_but_moe(arch):
    """Every family builds, serves and trains (the name predates MoE
    training: the MoE family's loss carries its load-balancing loss in
    ``metrics["aux"]``, positive, and weighted into the loss); its
    abstract model has the built model's parameters on ``meta``."""
    cfg = TC.reduced(TC.get_config(arch))
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _prompts()[:, :8]}
    if cfg.frontend:
        name = "frames" if cfg.frontend == "audio" else "patches"
        batch[name] = torch.randn(B, cfg.n_frontend_tokens, cfg.d_model)
    logits, cache = bundle.prefill(params, batch)
    assert logits.shape == (B, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()
    if cfg.family in ("dense", "moe"):
        assert cache_bytes(cache) == 2 * cfg.n_layers * B * 8 * \
            cfg.n_kv_heads * cfg.head_dim_ * 2
    toks = _prompts()[:, :9]
    batch.update(tokens=toks[:, :8], labels=toks[:, 1:])
    loss, metrics = bundle.loss(params, batch)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"xent", "aux"}
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
        assert float(loss) == pytest.approx(
            float(metrics["xent"]) + 0.01 * float(metrics["aux"]), rel=1e-6)
    else:
        assert float(metrics["aux"]) == 0
    shapes, specs = bundle.abstract()
    named = dict(params.named_parameters())
    abstract = dict(shapes.named_parameters())
    assert set(abstract) == set(named) == set(specs)
    for name, p in abstract.items():
        assert p.is_meta and p.shape == named[name].shape \
            and p.dtype == named[name].dtype, name
        assert len(specs[name]) == p.dim(), name


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TC.reduced(TC.get_config("qwen3_0p6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--batch", "1", "--prompt-len", "4", "--max-new", "2"])
    _, rp, _, _ = _models("qwen3_0p6b", "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_params_from_reference(cfg, rp)
    # tokens on another device than the model raise; host arrays move
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="different devices"):
        bundle.prefill(params, {"tokens": torch.zeros(1, 4, dtype=torch.long,
                                                      device="meta")})
    logits, _ = bundle.prefill(params, {"tokens": [[1, 2, 3, 4]]})
    assert logits.device.type == "cpu"


def test_serve_cli_runs_on_the_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "8", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out


def test_loss_remat_policies():
    """"block" and "full" rematerialise each block and "dots" keeps its
    products with no batch dims (the same loss and gradients, the loss
    equal to the forward without grad); other names raise."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("qwen3_0p6b")),
                              dtype="float32")
    toks = _prompts()
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    params.requires_grad_(True)
    out = {}
    for remat in ("block", "full", "dots"):
        loss, _ = build(cfg, device="cpu", remat=remat).loss(params, batch)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                params.layers[0].attn.wq))
    for remat in ("full", "dots"):
        assert torch.equal(out["block"][0], out[remat][0])
        assert torch.equal(out["block"][1][0], out[remat][1][0])
    with torch.no_grad():
        loss, _ = build(cfg, device="cpu").loss(params, batch)
    assert torch.equal(loss, out["block"][0].detach())
    with pytest.raises(ValueError, match="remat"):
        build(cfg, device="cpu", remat="none")
