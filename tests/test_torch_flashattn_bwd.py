"""Port parity: flash attention's training forward (with the logsumexp
rows) and its backward, on the CPU.

Inputs are drawn with numpy from fixed seeds (bf16 cases round them in
JAX first, so both packages see the same values). The port's kernel
wrappers run their plain versions for CPU tensors. Held to the JAX
package's Pallas kernels in interpret mode (`flash_attention_fwd_kernel`,
`flash_attention_bwd_kernel`), at the shapes of `tests/test_flashattn.py`
(and the backward also at head dims 80, Zamba2's, and 112, Kimi K2's, and
at the Hopper backward's forms with Sq != Sk at head dims 64, 80 and 112)
with their tolerances:
lse to 1e-4; o to 2e-3 in float32 and 2e-2 in bf16; dq, dk, dv to 1e-3
in float32 and 2e-2 in bf16 (relative and absolute), where the two sum
in other orders and round outputs to bf16 at the same points. The
differentiable `kernels.ops.flash_attention` (a
`torch.autograd.Function`) is held to ``jax.grad`` of the JAX
package's `flash_attention` and to torch autograd through a dense
softmax."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flashattn as RF  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import flashattn as TF  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402

# the shape cases of tests/test_flashattn.py: (B, S, H, KV, hd, causal,
# block_q, block_k)
CASES = [
    (2, 128, 4, 2, 32, True, 32, 32),
    (2, 128, 4, 2, 32, False, 32, 32),
    (1, 100, 4, 4, 16, False, 32, 32),     # ragged S, MHA
    (1, 80, 8, 2, 64, True, 32, 16),       # ragged, GQA-4, uneven blocks
    (2, 64, 8, 8, 128, True, 64, 64),      # full head_dim
]
#: Zamba2's shared-attention head dim (80: five 16-deep steps, no power
#: of two), causal and not, GQA-2, ragged S
HD80_CASES = [
    (1, 100, 4, 2, 80, True, 32, 32),
    (1, 100, 4, 2, 80, False, 32, 32),
]
#: Kimi K2's head dim (112: seven 16-deep steps, the last three in the
#: second 64-column box) at its GQA group of 8 (8 heads over 1), causal and
#: not, ragged S
HD112_CASES = [
    (1, 70, 8, 1, 112, True, 32, 32),
    (1, 70, 8, 1, 112, False, 32, 32),
]
#: the forms the Hopper backward serves at head dims 64, 80 and 112, with
#: Sq != Sk: (B, Sq, Sk, H, KV, hd, causal, block_q, block_k):
#: SeamlessM4T's cross attention (not causal, 2 Sk queries over Sk keys)
#: and its causal self-attention (4 heads over 4); Zamba2's head dim with
#: ragged tiles and a GQA group of 2, and Kimi K2's with its group of 8,
#: each causal with Sq > Sk and not with Sq < Sk
HOPPER_FORMS = [
    (1, 64, 32, 2, 2, 64, False, 32, 32),
    (1, 64, 64, 4, 4, 64, True, 32, 32),
    (1, 70, 50, 4, 2, 80, True, 32, 32),
    (1, 50, 70, 4, 2, 80, False, 32, 32),
    (1, 70, 50, 8, 1, 112, True, 32, 32),
    (1, 50, 70, 8, 1, 112, False, 32, 32),
]
TOL_O = {"float32": 2e-3, "bfloat16": 2e-2}
TOL_GRAD = {"float32": 1e-3, "bfloat16": 2e-2}


def _draw(rng, dtype, *shapes):
    """numpy draws rounded to ``dtype`` in JAX, as (jax, torch) pairs."""
    out = []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                        dtype=dtype)
        out.append((x, torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, dtype))))
    return out


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _hm(x):
    """Model layout (B, S, heads, hd) -> head-major (B, heads, S, hd)."""
    return x.transpose(1, 2)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_lse_matches_reference(B, S, H, KV, hd, causal, bq, bk,
                                            dtype):
    rng = np.random.default_rng(S + hd)
    (qj, qt), (kj, kt), (vj, vt) = _draw(rng, dtype, (B, H, S, hd),
                                         (B, KV, S, hd), (B, KV, S, hd))
    want_o, want_lse = RF.flash_attention_fwd_kernel(
        qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    o, lse = TF.flash_attention_fwd_plain(qt, kt, vt, causal, bq, bk)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, S)
    np.testing.assert_allclose(_f32(lse), _f32(want_lse), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_f32(o), _f32(want_o), rtol=TOL_O[dtype],
                               atol=TOL_O[dtype])
    # the model-layout wrapper runs the plain version on the CPU
    before = dict(LAUNCHES)
    o2, lse2 = TF.flash_attention_fwd_kernel(_hm(qt), _hm(kt), _hm(vt),
                                             causal, bq, bk)
    assert dict(LAUNCHES) == before
    assert torch.equal(_hm(o2), o) and torch.equal(lse2, lse)
    # the serving forward is the same output
    assert torch.equal(TF.flash_attention_plain(qt, kt, vt, causal, bq, bk),
                       o)


def _backward_case(B, Sq, Sk, H, KV, hd, causal, bq, bk, dtype, seed):
    """The plain backward (and the model-layout wrapper, which runs it on
    the CPU) against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(seed)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _draw(
        rng, dtype, (B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd),
        (B, H, Sq, hd))
    oj, lsej = RF.flash_attention_fwd_kernel(qj, kj, vj, causal=causal,
                                             block_q=bq, block_k=bk)
    want = RF.flash_attention_bwd_kernel(qj, kj, vj, oj, lsej, doj,
                                         causal=causal, block_q=bq,
                                         block_k=bk)
    ot = torch.from_numpy(np.array(oj, np.float32)).to(qt.dtype)
    lset = torch.from_numpy(np.array(lsej))
    got = TF.flash_attention_bwd_plain(qt, kt, vt, ot, lset, dot, causal,
                                       bq, bk)
    tol = TOL_GRAD[dtype]
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want,
                                (qt, kt, vt)):
        assert g.shape == like.shape and g.dtype == like.dtype, name
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol,
                                   err_msg=name)
    # the model-layout wrapper runs the plain version on the CPU
    before = dict(LAUNCHES)
    wrapped = TF.flash_attention_bwd_kernel(_hm(qt), _hm(kt), _hm(vt),
                                            _hm(ot), lset, _hm(dot), causal,
                                            bq, bk)
    assert dict(LAUNCHES) == before
    for g, w in zip(wrapped, got):
        assert torch.equal(_hm(g), w)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk",
                         CASES + HD80_CASES + HD112_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_reference(B, S, H, KV, hd, causal, bq, bk, dtype):
    _backward_case(B, S, S, H, KV, hd, causal, bq, bk, dtype, 3 * S + hd)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,bq,bk", HOPPER_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_reference_at_hopper_forms(B, Sq, Sk, H, KV, hd,
                                                    causal, bq, bk, dtype):
    """Sq != Sk at head dims 64, 80 and 112 (causal positions aligned at 0):
    the plain backward, which the card's gate trusts, against the
    reference at the forms the Hopper kernels serve."""
    _backward_case(B, Sq, Sk, H, KV, hd, causal, bq, bk, dtype,
                   Sq * Sk + hd)


@pytest.mark.parametrize("Sq,Sk,causal", [(64, 100, False), (48, 80, True),
                                          (80, 48, True)])
def test_backward_cross_lengths_match_dense_autograd(Sq, Sk, causal):
    """Sq != Sk (positions aligned at 0 when causal) and ragged tiles:
    the plain backward against torch autograd of a dense softmax."""
    rng = np.random.default_rng(Sq * Sk)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   for s in ((1, 4, Sq, 32), (1, 2, Sk, 32), (1, 2, Sk, 32),
                             (1, 4, Sq, 32)))
    o, lse = TF.flash_attention_fwd_plain(q, k, v, causal, 32, 32)
    got = TF.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, 32, 32)
    want = _dense_grads(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _dense_grads(q, k, v, do, causal):
    """Torch autograd through a dense float64 softmax; head-major."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    G = q.shape[1] // k.shape[1]
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = q @ kk.transpose(-1, -2) / np.sqrt(q.shape[-1])
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = s.masked_fill(~keep, -1e30)
    o = torch.softmax(s, -1) @ vv
    return torch.autograd.grad(o, (q, k, v), do.double())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("KV", [2, 4])
def test_function_grads_match_jax_grad(causal, KV):
    """The autograd Function (model layout) against ``jax.grad`` of the
    JAX package's differentiable `flash_attention` (its custom VJP over
    the Pallas kernels) and against a dense softmax in torch: the cases
    of `tests/test_flashattn.py::test_flash_grads_match_autodiff`."""
    B, S, H, hd = 1, 64, 4, 16
    rng = np.random.default_rng(KV + 10 * causal)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                        (B, S, H, hd))]
    qj, kj, vj, doj = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        return jnp.sum(RF.flash_attention(q, k, v, causal=causal,
                                          block_q=16, block_k=16) * doj)

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3])
    before = dict(LAUNCHES)
    out = tkops.flash_attention(q, k, v, causal=causal, block_q=16,
                                block_k=16)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert dict(LAUNCHES) == before              # the plain versions
    dense = _dense_grads(*(_hm(x.detach()) for x in (q, k, v)), _hm(do),
                         causal)
    for name, g, w, d in zip(("dq", "dk", "dv"), got, want, dense):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-3, atol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(_f32(g), _f32(_hm(d)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_function_only_under_grad():
    """Without grad (or with no operand needing it) `ops.flash_attention`
    is the serving forward; with it the output carries the Function's
    backward. Both give the same values."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)))
    plain = tkops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert tkops.flash_attention(q, k, v.requires_grad_()).grad_fn \
            is None
    out = tkops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)


def test_backward_wrapper_rejects_bad_operands():
    q = torch.zeros(1, 8, 2, 16)
    k = v = torch.zeros(1, 8, 1, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="do must match q"):
        TF.flash_attention_bwd_kernel(q, k, v, q, lse, q[:, :4])
    with pytest.raises(ValueError, match="lse must be"):
        TF.flash_attention_bwd_kernel(q, k, v, q, lse.double(), q)
    with pytest.raises(ValueError, match="o must match q"):
        TF.flash_attention_bwd_kernel(q, k, v, q.bfloat16(), lse, q)
