"""Port parity: the encoder-decoder (SeamlessM4T) and VLM (Llama-3.2-
Vision) families' serving path on the CPU.

`layers.cross_attention` and `encdec._cross_decode` run on the same
numpy-drawn inputs in both packages; the models run with the reference's
parameters (``build(cfg).init(PRNGKey(0))``) carried across by
`convert.model_params_from_reference`, at `reduced()` widths (d_model
128, 4 / 2 heads of 32; SeamlessM4T 2 encoder and 4 decoder layers over
16 frames; the VLM as 2 groups of one self-attention block and one self +
cross block over 16 patches, and as 2 groups of 2 + 1 where noted), on
numpy-drawn prompts of 24 ids and numpy-drawn frontend embeddings. The
reference runs its default chunked attention. Held: the encoder's output,
prefill's logits and every cache leaf (self KV sheets, cross keys and
values), four decode steps after `extend_cache` and greedy `generate`
ids. Tolerances: in float32 1e-4 of the reference's largest magnitude
(the dense family's bound); in bf16 the RMS of the difference within 0.05
of the reference's RMS (one bf16 rounding that lands the other way moves
a value by 2^-8)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.models import encdec as rencdec  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.serve.kvcache import extend_cache as rextend  # noqa: E402
from repro.serve.step import generate as rgenerate  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve import extend_cache, generate  # noqa: E402

ARCHS = ["seamless_m4t_medium", "llama_3p2_vision_90b"]
DTYPES = ["float32", "bfloat16"]
F32_TOL = 1e-4
BF16_RMS_TOL = 0.05
B, S, N_DECODE = 2, 24, 4
FRONTEND = {"seamless_m4t_medium": "frames",
            "llama_3p2_vision_90b": "patches"}


def _cfgs(arch, dtype, **kw):
    ref = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype,
                              **kw)
    port = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype,
                               **kw)
    return ref, port


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, dtype, what):
    """float32: max error within 1e-4 of the reference's max; bf16: RMS
    error within 0.05 of the reference's RMS."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if dtype == "float32":
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < F32_TOL, f"{what}: max error {err:.3g} of the max"
    else:
        err = np.sqrt(((got - want) ** 2).mean()
                      / ((want ** 2).mean() + 1e-30))
        assert err < BF16_RMS_TOL, f"{what}: RMS error {err:.3g} of the RMS"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _both(x, dtype):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.array(x, np.float32)).to(getattr(torch,
                                                                 dtype)))


def _attention(cfg, rp):
    """A port `Attention` holding the reference's attention dict."""
    p = tlayers.Attention(cfg, "cpu")
    for name, leaf in _leaves(rp):
        with torch.no_grad():
            p.get_parameter(name).copy_(torch.from_numpy(
                np.array(leaf, np.float32)))
    return p


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_reference(dtype, qk_norm):
    """24 queries over 40 memory positions (no RoPE, not causal), through
    the flash wrapper's plain version at the reference's blocks."""
    rcfg, cfg = _cfgs("seamless_m4t_medium", dtype, qk_norm=qk_norm)
    rp, _ = rlayers.cross_attention_init(jax.random.PRNGKey(3), rcfg)
    if qk_norm:      # non-trivial norm scales
        rng = np.random.default_rng(9)
        rp = dict(rp, **{n: jnp.asarray(1 + 0.3 * rng.standard_normal(
            rp[n].shape)).astype(rcfg.dtype) for n in ("q_norm", "k_norm")})
    tp = _attention(cfg, rp)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 40, cfg.d_model)).astype(np.float32)
    (rx, tx), (rm, tm) = _both(x, dtype), _both(mem, dtype)
    want = rlayers.cross_attention(rp, rx, rm, rcfg)
    got = tlayers.cross_attention(tp, tx, tm, cfg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype, "cross attention")
    # the same with the memory's projections handed in
    kv = (torch.einsum("bsd,dhk->bshk", tm, tp.wk),
          torch.einsum("bsd,dhk->bshk", tm, tp.wv))
    assert torch.equal(tlayers.cross_attention(tp, tx, tm, cfg, kv=kv), got)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_matches_reference(dtype, qk_norm):
    """One token against a flat (B, Sm, KV * hd) memory cache: float32
    scores and softmax over all 40 positions."""
    rcfg, cfg = _cfgs("llama_3p2_vision_90b", dtype, qk_norm=qk_norm)
    rp, _ = rlayers.cross_attention_init(jax.random.PRNGKey(4), rcfg)
    tp = _attention(cfg, rp)
    rng = np.random.default_rng(10)
    flat = cfg.n_kv_heads * cfg.head_dim_
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    xk, xv = (rng.standard_normal((B, 40, flat)).astype(np.float32)
              for _ in range(2))
    (rx, tx), (rk, tk), (rv, tv) = (_both(a, dtype) for a in (x, xk, xv))
    want = rencdec._cross_decode(rp, rx, rk, rv, rcfg)
    got = tencdec._cross_decode(tp, tx, tk, tv, cfg)
    assert got.shape == (B, 1, cfg.d_model) and got.dtype == tx.dtype
    _close(got, want, dtype, "cross decode")


# --------------------------------------------------------------------------
# SeamlessM4T and the VLM
# --------------------------------------------------------------------------

@functools.lru_cache(None)
def _models(arch, dtype, cross_attn_every=None):
    """(reference bundle, its params, port bundle, port params)."""
    kw = {} if cross_attn_every is None else dict(
        cross_attn_every=cross_attn_every, n_layers=2 * cross_attn_every)
    rcfg, cfg = _cfgs(arch, dtype, **kw)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    return rb, rp, build(cfg, device="cpu"), \
        model_params_from_reference(cfg, rp, device="cpu")


def _inputs(cfg):
    rng = np.random.default_rng(2026)
    toks = rng.integers(0, 512, (B, S + N_DECODE), dtype=np.int32)
    front = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)
                                ).astype(np.float32)
    return toks, front


def _batches(arch, cfg, n=S):
    toks, front = _inputs(cfg)
    name = FRONTEND[arch]
    return ({"tokens": jnp.asarray(toks[:, :n]), name: jnp.asarray(front)},
            {"tokens": toks[:, :n], name: torch.from_numpy(front)})


def _ref_names(arch, cfg, rp):
    """The port's parameter name of every reference leaf element, by the
    reference's stacking: ``enc`` / ``dec`` by layer, the VLM's
    ``groups.self`` by group and block, ``groups.cross`` by group."""
    out = {}
    for name, leaf in _leaves(rp):
        a = np.array(leaf.astype(jnp.float32))
        head, _, rest = name.partition(".")
        if head in ("enc", "dec"):
            for i in range(a.shape[0]):
                out[f"{head}.{i}.{rest}"] = a[i]
        elif head == "groups":
            kind, _, rest = rest.partition(".")
            for g in range(a.shape[0]):
                if kind == "self":
                    for j in range(a.shape[1]):
                        out[f"groups.{g}.self.{j}.{rest}"] = a[g, j]
                else:
                    out[f"groups.{g}.cross.{rest}"] = a[g]
        else:
            out[name] = a
    return out


@pytest.mark.parametrize("arch,every", [("seamless_m4t_medium", None),
                                        ("llama_3p2_vision_90b", None),
                                        ("llama_3p2_vision_90b", 3)])
def test_convert_carries_every_leaf(arch, every):
    rb, rp, tb, tp = _models(arch, "bfloat16", every)
    want = _ref_names(arch, tb.cfg, rp)
    ported = dict(tp.named_parameters())
    assert set(ported) == set(want)
    for name, a in want.items():
        assert ported[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_f32(ported[name]), a, err_msg=name)
    if every == 3:
        assert all(len(g.self_blocks()) == 2 for g in tp.groups)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_reference(dtype):
    rb, rp, tb, tp = _models("seamless_m4t_medium", dtype)
    cfg = tb.cfg
    _, front = _inputs(cfg)
    want = jax.jit(lambda p, f: rencdec.encode(p, f, rb.cfg))(
        rp, jnp.asarray(front))
    got = tencdec.encode(tp, torch.from_numpy(front), cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, "encoder output")


@pytest.mark.parametrize("arch,dtype,every", [
    (arch, dtype, None) for arch in ARCHS for dtype in DTYPES] + [
    ("llama_3p2_vision_90b", "float32", 3)])
def test_prefill_and_decode_match_reference(arch, dtype, every):
    """Prefill (every cache leaf held), then four decode steps; the VLM
    also at 2 groups of 2 self + 1 cross layers."""
    rb, rp, tb, tp = _models(arch, dtype, every)
    toks, _ = _inputs(tb.cfg)
    rbatch, tbatch = _batches(arch, tb.cfg)
    rl, rc = jax.jit(lambda p, b: rb.prefill(p, b))(rp, rbatch)
    tl, tc = tb.prefill(tp, tbatch)
    assert tl.shape == (B, tb.cfg.padded_vocab)
    _close(tl, rl, dtype, "prefill logits")
    ref_leaves, port_leaves = dict(_leaves(rc)), dict(_leaves(tc))
    assert set(ref_leaves) == set(port_leaves) == {
        "self.k", "self.v", "cross_k", "cross_v"}
    for name, want in ref_leaves.items():
        _close(port_leaves[name], want, dtype, f"cache {name}")
    rc, tc = rextend(rc, N_DECODE), extend_cache(tc, N_DECODE)
    step = jax.jit(rb.decode_step)
    for i in range(N_DECODE):
        tok = toks[:, S + i]
        rl, rc = step(rp, jnp.asarray(tok), rc, jnp.int32(S + i))
        tl, tc = tb.decode_step(tp, tok, tc, S + i)
        _close(tl, rl, dtype, f"decode step {i} logits")
    for name, want in _leaves(rc):
        _close(dict(_leaves(tc))[name], want, dtype,
               f"cache {name} after decoding")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(arch):
    """Within the port, float32: prefill(S) and one decode step give
    prefill(S + 1)'s logits (the self and cross caches carry what the
    prompt and the frontend left)."""
    _, _, tb, tp = _models(arch, "float32")
    _, long = _batches(arch, tb.cfg, S + 1)
    _, short = _batches(arch, tb.cfg)
    want, _ = tb.prefill(tp, long)
    _, cache = tb.prefill(tp, short)
    got, _ = tb.decode_step(tp, long["tokens"][:, S], extend_cache(cache, 1),
                            S)
    _close(got, want, "float32", "decode vs prefill(S + 1)")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    rb, rp, tb, tp = _models(arch, "float32")
    rbatch, tbatch = _batches(arch, tb.cfg)
    want = np.asarray(rgenerate(rb, rp, rbatch, 5))
    got = generate(tb, tp, tbatch, 5)
    assert got.dtype == torch.int32 and got.shape == (B, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_cache_leaves_cross_caches_untouched(arch):
    _, _, tb, tp = _models(arch, "float32")
    _, cache = tb.prefill(tp, _batches(arch, tb.cfg)[1])
    out = extend_cache(cache, 3)
    assert out["cross_k"] is cache["cross_k"]
    assert out["cross_v"] is cache["cross_v"]
    for name in ("k", "v"):
        assert out["self"][name].shape[2] == S + 3
        assert torch.equal(out["self"][name][:, :, :S], cache["self"][name])
    rc = jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache)
    assert {k: v.shape for k, v in _leaves(rextend(rc, 3))} == \
        {k: tuple(v.shape) for k, v in _leaves(out)}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_init_matches_reference_shapes(arch):
    rb, _, tb, _ = _models(arch, "bfloat16")
    rc, _ = rb.cache_init(3, 50)
    tc = tb.cache_init(3, 50)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _leaves(tc)} == \
        {k: (v.shape, str(v.dtype)) for k, v in _leaves(rc)}


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_batches_match_the_reference_shapes(arch):
    """`SyntheticLM.for_cell` gives the frontend's stub embeddings under
    the reference's name, shape and dtype, deterministic by seed."""
    from repro.data import SyntheticLM as RSyntheticLM

    cfg = TC.get_config(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    data = SyntheticLM.for_cell(cfg, shape, seed=5, device="cpu")
    want = RSyntheticLM.for_cell(RC.get_config(arch), shape, seed=5
                                 ).batch(0)
    got = data.batch(0)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    front = got[FRONTEND[arch]]
    assert torch.equal(front, data.batch(0)[FRONTEND[arch]])
    assert not torch.equal(front, data.batch(1)[FRONTEND[arch]])
    assert abs(float(front.float().std()) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_families_serve_and_train(arch):
    """``bundle.loss`` trains the enc-dec and VLM families over the
    batch's frontend embeddings: a finite loss and the metrics ``xent`` /
    ``aux`` (its parity with the reference is
    `test_torch_train_step_encdec.py` / ``_vlm``); without them the loss
    and the prefill raise, naming the batch key."""
    _, _, tb, tp = _models(arch, "float32")
    toks, front = _inputs(tb.cfg)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    with pytest.raises(ValueError, match=FRONTEND[arch]):
        tb.loss(tp, batch)
    with pytest.raises(ValueError, match=FRONTEND[arch]):
        tb.prefill(tp, {"tokens": toks[:, :S]})
    loss, metrics = tb.loss(tp, dict(batch, **{FRONTEND[arch]: front}))
    assert bool(torch.isfinite(loss)) and set(metrics) == {"xent", "aux"}
    assert float(metrics["aux"]) == 0.0


def test_serve_cli_runs_the_new_families_on_the_cpu(capsys):
    for arch in ("mamba2_1p3b", "zamba2_2p7b", *ARCHS):
        assert tserve.main(["--arch", arch, "--device", "cpu", "--batch",
                            "2", "--prompt-len", "8", "--max-new", "3"]) == 0
        out = capsys.readouterr().out
        assert "generated (2, 3)" in out and "on cpu" in out
