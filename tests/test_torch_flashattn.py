"""Port parity: flash attention, on the CPU.

Inputs are drawn with numpy from fixed seeds (bf16 cases round them in
JAX first, so both packages see the same values) and go through the JAX
package's `repro.kernels.flashattn.flash_attention` (its Pallas kernel in
interpret mode), its pure-jnp `repro.models.layers._chunked_attention`,
and the port's `kernels.ops.flash_attention`, whose wrapper runs the
plain version for CPU tensors; at the serving families' head dims (64,
80) and Kimi K2's (112) also `flash_attention_plain` /
`flash_attention_fwd_plain` against
the reference's serving and lse-emitting Pallas kernels. Tolerances are
the JAX package's own against its numpy oracle
(`tests/test_flashattn.py`): 2e-3 relative and absolute in float32,
2e-2 in bf16, where the two sides round p and the output to bf16 at the
same points but sum in another order; the lse to 1e-4."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flashattn as RF  # noqa: E402
from repro.kernels.flashattn import flash_attention as ref_flash  # noqa: E402
from repro.models.layers import _chunked_attention  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels.flashattn import (  # noqa: E402
    flash_attention_fwd_plain, flash_attention_kernel, flash_attention_plain)
from repro_torch.models import layers as TL  # noqa: E402

# the shape cases of tests/test_flashattn.py
CASES = [
    (2, 128, 4, 2, 32, True, 32, 32),
    (2, 128, 4, 2, 32, False, 32, 32),
    (1, 100, 4, 4, 16, False, 32, 32),     # ragged S, MHA
    (1, 80, 8, 2, 64, True, 32, 16),       # ragged, GQA-4, uneven blocks
    (2, 64, 8, 8, 128, True, 64, 64),      # full head_dim
]
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _inputs(seed, dtype, q_shape, kv_shape):
    """numpy draws rounded to ``dtype`` in JAX, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in (q_shape, kv_shape, kv_shape):
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                        dtype=dtype)
        t = torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, dtype))
        out.append((x, t))
    return out


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference(B, S, H, KV, hd, causal, bq, bk, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(S + hd, dtype, (B, S, H, hd),
                                           (B, S, KV, hd))
    before = LAUNCHES["flash_attention"]
    got = tkops.flash_attention(qt, kt, vt, causal=causal, block_q=bq,
                                block_k=bk)
    assert LAUNCHES["flash_attention"] == before      # the plain version
    assert got.shape == (B, S, H, hd) and got.dtype == qt.dtype
    tol = TOL[dtype]
    want = ref_flash(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    chunked = _chunked_attention(qj, kj, vj, causal=causal, q_chunk=bq,
                                 kv_chunk=bk)
    np.testing.assert_allclose(_f32(got), _f32(chunked), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk,causal", [(64, 100, False), (48, 80, True),
                                          (80, 48, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cross_attention_shapes(dtype, Sq, Sk, causal):
    """Sq != Sk: decoder queries over encoder memory (non-causal), and the
    causal mask with positions aligned at 0 on both sides."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(Sq + Sk, dtype, (1, Sq, 4, 32),
                                           (1, Sk, 4, 32))
    got = tkops.flash_attention(qt, kt, vt, causal=causal, block_q=32,
                                block_k=32)
    assert got.shape == (1, Sq, 4, 32)
    want = ref_flash(qj, kj, vj, causal=causal, block_q=32, block_k=32)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# the serving families' head dims on the card's Hopper route: 80
# (Zamba2's shared attention) at a ragged length, causal and not, and 64
# (SeamlessM4T) with twice as many queries as keys, not causal (decoder
# queries over encoder memory), a GQA group of 2; then Kimi K2's head dim
# 112 at its GQA group of 8 (8 heads over 1) with Sq != Sk both ways,
# causal with more queries than keys and not with fewer
SERVE_CASES = [
    (1, 77, 77, 2, 2, 80, True, 32, 32),
    (1, 77, 77, 2, 2, 80, False, 32, 32),
    (1, 96, 48, 4, 2, 64, False, 32, 16),
    (1, 70, 50, 8, 1, 112, True, 32, 32),
    (1, 50, 70, 8, 1, 112, False, 32, 32),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,bq,bk", SERVE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_head_dims_match_reference(B, Sq, Sk, H, KV, hd, causal, bq,
                                           bk, dtype):
    """`flash_attention_plain` and `flash_attention_fwd_plain` against the
    reference's serving and lse-emitting Pallas kernels (head-major)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(Sq + Sk + hd, dtype,
                                           (B, H, Sq, hd), (B, KV, Sk, hd))
    tol = TOL[dtype]
    got = flash_attention_plain(qt, kt, vt, causal, bq, bk)
    assert got.shape == (B, H, Sq, hd) and got.dtype == qt.dtype
    want = RF.flash_attention_kernel(qj, kj, vj, causal=causal, block_q=bq,
                                     block_k=bk)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    o, lse = flash_attention_fwd_plain(qt, kt, vt, causal, bq, bk)
    want_o, want_lse = RF.flash_attention_fwd_kernel(
        qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    assert torch.equal(o, got)
    np.testing.assert_allclose(_f32(o), _f32(want_o), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), _f32(want_lse), rtol=1e-4,
                               atol=1e-4)


def test_head_major_wrapper_matches_the_model_side_one():
    """`flash_attention_plain` takes head-major operands, the reference
    kernel's layout; `flash_attention_kernel`, `ops.flash_attention` and
    `models.layers.chunked_attention` take the model's (B, S, heads,
    hd)."""
    (_, q), (_, k), (_, v) = _inputs(3, "float32", (2, 48, 4, 32),
                                     (2, 48, 2, 32))
    hm = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, block_q=16,
                               block_k=16)
    ks = flash_attention_kernel(q, k, v, causal=True, block_q=16,
                                block_k=16)
    ms = TL.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    assert ks.shape == ms.shape == (2, 48, 4, 32)
    assert torch.equal(hm.transpose(1, 2), ks)
    assert torch.equal(ks, ms)


@pytest.mark.parametrize("block", [8, 24, 48, 512])
def test_plain_version_does_not_depend_on_its_blocks(block):
    """Blocks only shape the arithmetic's order: every blocking agrees
    with an unblocked float64 softmax."""
    (_, q), (_, k), (_, v) = _inputs(11, "float32", (1, 40, 4, 16),
                                     (1, 40, 2, 16))
    got = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                block_q=block, block_k=block)
    qd, kd, vd = (x.double().transpose(1, 2).repeat_interleave(
        2 if x is not q else 1, dim=1) for x in (q, k, v))
    s = qd @ kd.transpose(-1, -2) / 4.0
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.softmax(s, -1) @ vd
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrapper_rejects_bad_operands():
    q = torch.zeros(1, 8, 4, 32)                        # (B, S, H, hd)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, torch.zeros(1, 8, 3, 32),
                               torch.zeros(1, 8, 3, 32))     # 4 % 3
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k.double())
    with pytest.raises(ValueError):
        flash_attention_kernel(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, torch.zeros(1, 9, 2, 32))
    with pytest.raises(ValueError):
        flash_attention_kernel(q[:, :0], k, k)
    with pytest.raises(ValueError):
        flash_attention_plain(q, torch.zeros(1, 3, 8, 32),  # head-major:
                              torch.zeros(1, 3, 8, 32))     # 8 % 3
