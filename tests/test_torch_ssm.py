"""Port parity: the SSM (Mamba2) and hybrid (Zamba2) families' serving path
on the CPU.

The mixer's functions (`_causal_conv`, `ssd_chunked`, `ssm_forward`,
`ssm_decode_step`) run on the same numpy-drawn inputs in both packages;
the models run with the reference's parameters (``build(cfg).init(
PRNGKey(0))``) carried across by `convert.model_params_from_reference`, at
`reduced()` widths (4 layers, d_model 128, 8 SSM heads of 32, state 16,
chunk 16; Zamba2 as 2 groups of 2 SSM blocks and the shared block with 4
/ 2 heads of 32), on numpy-drawn prompts of 40 ids (not a multiple of the
chunk). The reference's shared attention runs its default chunked
attention. Held: prefill's logits and every cache leaf (SSM state, raw
conv tail, the shared block's KV sheets), four decode steps after
`extend_cache` and greedy `generate` ids. Tolerances: in float32 1e-4 of
the reference's largest magnitude (the dense family's bound); in bf16 the
RMS of the difference within 0.05 of the reference's RMS (one bf16
rounding that lands the other way moves a value by 2^-8, and the SSD
scan's bf16 state compounds such roundings over the chunks)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.serve.kvcache import extend_cache as rextend  # noqa: E402
from repro.serve.step import generate as rgenerate  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.hybrid import SSMBlock  # noqa: E402
from repro_torch.serve import extend_cache, generate  # noqa: E402

ARCHS = ["mamba2_1p3b", "zamba2_2p7b"]
DTYPES = ["float32", "bfloat16"]
#: float32: largest difference over the reference's largest magnitude
F32_TOL = 1e-4
#: bf16: RMS of the difference over the reference's RMS
BF16_RMS_TOL = 0.05
B, S, N_DECODE = 2, 40, 4


def _cfgs(arch, dtype):
    ref = dataclasses.replace(RC.reduced(RC.get_config(arch)), dtype=dtype)
    port = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype=dtype)
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
    """A numpy array as a reference array and a port tensor of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.array(x, np.float32)).to(getattr(torch,
                                                                 dtype)))


# --------------------------------------------------------------------------
# the mixer's functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 21, 48), (4, 48), (48,)))
    (rx, tx), (rw, tw), (rb, tb) = (_both(a, dtype) for a in (x, w, b))
    got = tssm._causal_conv(tx, tw, tb)
    assert got.dtype == tx.dtype
    _close(got, rssm._causal_conv(rx, rw, rb), dtype, "causal conv")


def test_segsum_matches_reference():
    dA = -np.abs(np.random.default_rng(2).standard_normal((3, 16))
                 ).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(dA)).numpy()
    want = np.asarray(rssm._segsum(jnp.asarray(dA)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def _ssd_inputs(seq, dtype, seed=3, H=4, P=8, N=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, seq, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, seq, H)))).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, seq, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((2, H, P, N)).astype(np.float32)
    return x, dt, a_log, Bm, Cm, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seq", [32, 37])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_reference(dtype, seq, with_state):
    """Chunk 16: a whole number of chunks (32) and a ragged tail (37,
    padded with dt = 0); with and without an initial state."""
    x, dt, a_log, Bm, Cm, s0 = _ssd_inputs(seq, dtype)
    rx, tx = _both(x, dtype)
    rB, tB = _both(Bm, dtype)
    rC, tC = _both(Cm, dtype)
    r0, t0 = (jnp.asarray(s0), torch.from_numpy(s0)) if with_state \
        else (None, None)
    ry, rs = rssm.ssd_chunked(rx, jnp.asarray(dt), jnp.asarray(a_log), rB,
                              rC, 16, r0)
    ty, ts = tssm.ssd_chunked(tx, torch.from_numpy(dt),
                              torch.from_numpy(a_log), tB, tC, 16, t0)
    assert ty.dtype == tx.dtype and ts.dtype == torch.float32
    _close(ty, ry, dtype, "ssd y")
    _close(ts, rs, dtype, "ssd final state")


@functools.lru_cache(None)
def _mixer(dtype):
    rcfg, cfg = _cfgs("mamba2_1p3b", dtype)
    rp, _ = rssm.ssm_init(jax.random.PRNGKey(5), rcfg)
    tp = tssm.SSM(cfg, "cpu")
    for name, leaf in _leaves(rp):
        with torch.no_grad():
            tp.get_parameter(name).copy_(torch.from_numpy(
                np.array(leaf, np.float32)))
    return rcfg, cfg, rp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_forward_and_its_cache_match_reference(dtype):
    """The mixer over 40 positions with ``return_cache``: the output, the
    float32 final state and the raw pre-conv window tail."""
    rcfg, cfg, rp, tp = _mixer(dtype)
    assert tp.a_log.dtype == tp.d_skip.dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model)) \
        .astype(np.float32)
    rx, tx = _both(x, dtype)
    ry, (rs, rc) = rssm.ssm_forward(rp, rx, rcfg, return_cache=True)
    ty, (ts, tc) = tssm.ssm_forward(tp, tx, cfg, return_cache=True)
    assert tc.shape == (B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    _close(ty, ry, dtype, "mixer output")
    _close(ts, rs, dtype, "final state")
    _close(tc, rc, dtype, "conv tail")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_step_matches_reference(dtype):
    rcfg, cfg, rp, tp = _mixer(dtype)
    rng = np.random.default_rng(6)
    C = cfg.d_inner + 2 * cfg.ssm_state
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, C)).astype(np.float32)
    rx, tx = _both(x, dtype)
    rc, tc = _both(conv, dtype)
    ry, rs, rcv = rssm.ssm_decode_step(rp, rx, jnp.asarray(state), rc, rcfg)
    ty, ts, tcv = tssm.ssm_decode_step(tp, tx, torch.from_numpy(state), tc,
                                       cfg)
    assert ts.dtype == torch.float32 and tcv.dtype == tc.dtype
    _close(ty, ry, dtype, "decode output")
    _close(ts, rs, dtype, "decode state")
    _close(tcv, rcv, dtype, "decode conv window")


# --------------------------------------------------------------------------
# Mamba2 and Zamba2
# --------------------------------------------------------------------------

@functools.lru_cache(None)
def _models(arch, dtype):
    """(reference bundle, its params, port bundle, port params)."""
    rcfg, cfg = _cfgs(arch, dtype)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    return rb, rp, build(cfg, device="cpu"), \
        model_params_from_reference(cfg, rp, device="cpu")


def _prompts():
    return np.random.default_rng(2025).integers(0, 512, (B, S + N_DECODE),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_ssm_leaf(arch):
    """Every reference leaf lands in its port parameter bit for bit:
    Mamba2's ``layers[i]``, Zamba2's doubly stacked ``groups[g, j]`` and
    its one ``shared`` block; the SSM's float32 leaves stay float32."""
    rb, rp, tb, tp = _models(arch, "bfloat16")
    cfg = tb.cfg
    ported = dict(tp.named_parameters())
    want = {}
    for name, leaf in _leaves(rp):
        a = np.array(leaf.astype(jnp.float32))
        if name.startswith("layers."):
            for i in range(cfg.n_layers):
                want[name.replace("layers.", f"layers.{i}.", 1)] = a[i]
        elif name.startswith("groups."):
            for g in range(a.shape[0]):
                for j in range(a.shape[1]):
                    want[name.replace("groups.", f"groups.{g}.{j}.", 1)] = \
                        a[g, j]
        else:
            want[name] = a
    assert set(ported) == set(want)
    for name, a in want.items():
        np.testing.assert_array_equal(_f32(ported[name]), a, err_msg=name)
        f32 = name.rsplit(".", 1)[-1] in ("a_log", "d_skip", "dt_bias")
        assert (ported[name].dtype == torch.float32) == f32, name
    assert sum(isinstance(m, SSMBlock) for m in tp.modules()) == cfg.n_layers
    if arch == "zamba2_2p7b":
        assert len(tp.groups) == cfg.n_layers // cfg.attn_every == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill over a ragged 40-id prompt (every cache leaf held), then
    four decode steps."""
    rb, rp, tb, tp = _models(arch, dtype)
    toks = _prompts()
    rl, rc = jax.jit(lambda p, b: rb.prefill(p, b))(
        rp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tb.prefill(tp, {"tokens": toks[:, :S]})
    assert tl.shape == (B, tb.cfg.padded_vocab)
    _close(tl, rl, dtype, "prefill logits")
    ref_leaves, port_leaves = dict(_leaves(rc)), dict(_leaves(tc))
    assert set(ref_leaves) == set(port_leaves) == (
        {"ssm.state", "ssm.conv"} | ({"attn.k", "attn.v"}
                                     if arch == "zamba2_2p7b" else set()))
    for name, want in ref_leaves.items():
        got = port_leaves[name]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        _close(got, want, dtype, f"cache {name}")
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
    prefill(S + 1)'s logits, so the state and conv caches (and the shared
    block's KV sheets) carry everything the prompt left."""
    _, _, tb, tp = _models(arch, "float32")
    toks = _prompts()
    want, _ = tb.prefill(tp, {"tokens": toks[:, :S + 1]})
    _, cache = tb.prefill(tp, {"tokens": toks[:, :S]})
    got, _ = tb.decode_step(tp, toks[:, S], extend_cache(cache, 1), S)
    _close(got, want, "float32", "decode vs prefill(S + 1)")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    rb, rp, tb, tp = _models(arch, "float32")
    toks = _prompts()[:, :S]
    want = np.asarray(rgenerate(rb, rp, {"tokens": jnp.asarray(toks)}, 5))
    got = generate(tb, tp, {"tokens": toks}, 5)
    assert got.dtype == torch.int32 and got.shape == (B, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extend_cache_leaves_ssm_caches_untouched():
    """Only the shared block's KV sheets grow; the SSM state and conv
    window keep their shapes and are the very same tensors."""
    _, _, tb, tp = _models("zamba2_2p7b", "float32")
    _, cache = tb.prefill(tp, {"tokens": _prompts()[:, :S]})
    out = extend_cache(cache, 3)
    assert out["ssm"]["state"] is cache["ssm"]["state"]
    assert out["ssm"]["conv"] is cache["ssm"]["conv"]
    for name in ("k", "v"):
        assert out["attn"][name].shape[2] == S + 3
        assert torch.equal(out["attn"][name][:, :, :S], cache["attn"][name])
        assert not out["attn"][name][:, :, S:].any()
    rout = rextend(jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache), 3)
    assert jax.tree.map(lambda a: a.shape, rout) == \
        {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
         for k, v in out.items()}


def test_hybrid_cache_init_matches_reference_shapes():
    for arch in ARCHS:
        rb, _, tb, _ = _models(arch, "bfloat16")
        rc, _ = rb.cache_init(3, 50)
        tc = tb.cache_init(3, 50)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in _leaves(tc)} == \
            {k: (v.shape, str(v.dtype)) for k, v in _leaves(rc)}


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_families_serve_and_train(arch):
    """``bundle.loss`` trains the SSM and hybrid families: a finite loss
    and the metrics ``xent`` / ``aux`` (its parity with the reference is
    `test_torch_train_step_ssm.py` / ``_hybrid``)."""
    _, _, tb, tp = _models(arch, "float32")
    toks = _prompts()
    loss, metrics = tb.loss(tp, {"tokens": toks[:, :S],
                                 "labels": toks[:, 1:S + 1]})
    assert bool(torch.isfinite(loss)) and set(metrics) == {"xent", "aux"}
    assert float(metrics["aux"]) == 0.0
