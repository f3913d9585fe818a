"""The float32 flash kernels' arithmetic, emulated on the CPU.

The float32 kernels of ``csrc/flashattn.cu`` and ``csrc/flashattn_bwd.cu``
run every product on the tensor cores as three TF32 products
(``csrc/flash_tf32.cuh``): x is split into hi = tf32(x) and lo = tf32(x -
hi) with ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, 10
mantissa bits kept), and a b becomes a_lo b_hi + a_hi b_lo + a_hi b_hi in
float32. This file emulates that rounding on the int32 view, holds it bit
for bit to hand-made edge values, and runs the kernels' forward (64-key
tiles, an online softmax in exp2) and backward (delta = rowsum(o do), p
from the lse, dS = p (dP - delta) scale) with every product split so, at
the JAX package's five test shapes (`tests/test_flashattn.py`) and at
head dims 80 (Zamba2's) and 112 (Kimi K2's). The emulation is held to the
JAX package's Pallas float32 kernels in interpret mode within their
float32 tolerance (2e-3, relative and absolute) and to the port's plain
versions within 1e-5 of each output's RMS (the RMS of the difference):
the split passes the card's gate (chip_smoke.py's ``FLASH_TOL``) with
room to spare."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flashattn as RF  # noqa: E402
from repro_torch.kernels import flashattn as TF  # noqa: E402

# the shape cases of tests/test_flashattn.py, then head dims 80 and 112:
# (B, S, H, KV, hd, causal, block_q, block_k)
CASES = [
    (2, 128, 4, 2, 32, True, 32, 32),
    (2, 128, 4, 2, 32, False, 32, 32),
    (1, 100, 4, 4, 16, False, 32, 32),     # ragged S, MHA
    (1, 80, 8, 2, 64, True, 32, 16),       # ragged, GQA-4, uneven blocks
    (2, 64, 8, 8, 128, True, 64, 64),      # full head_dim
    (1, 100, 4, 2, 80, True, 32, 32),      # Zamba2's head dim, ragged
    (1, 70, 8, 1, 112, False, 32, 32),     # Kimi K2's head dim, GQA-8
]
TOL_REF = 2e-3
TOL_PLAIN = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on a float32 tensor: the 13 low mantissa bits
    rounded off to nearest, ties away from zero (add half an ulp of the
    kept bits to the magnitude, then clear them; a carry moves into the
    exponent, the largest values overflow to inf); NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = (mag + 0x1000) & ~0x1FFF
    out = (bits & -0x80000000) | rounded
    return torch.where(mag > 0x7F800000, bits, out).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi))."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: a_lo b_hi + a_hi b_lo + a_hi b_hi,
    each product of tf32 values exact in float32, summed in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def _valid(Sq, Sk, k0, n, causal):
    qpos = torch.arange(Sq)[:, None]
    kpos = k0 + torch.arange(n)[None, :]
    valid = kpos < Sk
    return valid & (qpos >= kpos) if causal else valid.expand(Sq, n)


def fwd_3xtf32(q, k, v, causal):
    """The float32 forward kernel's arithmetic: q (B, H, Sq, hd), k, v (B,
    KV, Sk, hd) -> (o, lse (B, H, Sq)): 64-key tiles, the running max of
    the raw scores, p = 2^(s c - m c) with c = scale log2(e), the
    denominator in float32, O += P V with P split too."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    Sk = k.shape[2]
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    scale = 1.0 / math.sqrt(hd)
    c = scale * LOG2E
    m = torch.full((B, H, Sq), NEG_INF)
    l = torch.zeros((B, H, Sq))
    o = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, 64):
        kt, vt = kk[:, :, k0:k0 + 64], vv[:, :, k0:k0 + 64]
        s = mm3(q, kt.transpose(-1, -2))
        s = torch.where(_valid(Sq, Sk, k0, kt.shape[2], causal), s, NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        mc = torch.where(mx == NEG_INF, 0.0, mx * c)
        p = torch.exp2(s * c - mc[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm3(p, vt)
        m = mx
    lse = m * scale + torch.log(l.clamp_min(1e-30))
    return o / l.clamp_min(1e-30)[..., None], lse


def bwd_3xtf32(q, k, v, o, lse, do, causal):
    """The float32 backward kernels' arithmetic -> (dq, dk, dv): delta =
    rowsum(o do), p = 2^(s c - lse log2(e)) where unmasked, dP = dO V^T,
    dS = p (dP - delta) scale, dQ = dS K, dK = dS^T Q and dV = P^T dO
    summed over each GQA group; every product split."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    scale = 1.0 / math.sqrt(hd)
    delta = (o * do).sum(-1)
    s = mm3(q, kk.transpose(-1, -2))
    p = torch.where(_valid(Sq, Sk, 0, Sk, causal),
                    torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E),
                    0.0)
    ds = p * (mm3(do, vv.transpose(-1, -2)) - delta[..., None]) * scale
    dq = mm3(ds, kk)
    dk = mm3(ds.transpose(-1, -2), q).reshape(B, KV, G, Sk, hd).sum(2)
    dv = mm3(p.transpose(-1, -2), do).reshape(B, KV, G, Sk, hd).sum(2)
    return dq, dk, dv


def _bits(*words):
    return torch.tensor(np.array(words, np.uint32).view(np.int32))


#: (input bits, tf32 bits)
EDGES = [
    (0x00000000, 0x00000000),     # +0
    (0x80000000, 0x80000000),     # -0
    (0x3F800000, 0x3F800000),     # 1.0, already tf32
    (0x3F800FFF, 0x3F800000),     # just under half an ulp: down
    (0x3F801000, 0x3F802000),     # a tie, kept bits even: away (RNE: down)
    (0x3F803000, 0x3F804000),     # a tie, kept bits odd: away
    (0x3F801001, 0x3F802000),     # just over half: up
    (0xBF801000, 0xBF802000),     # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),     # the carry moves into the exponent
    (0x7F7FE000, 0x7F7FE000),     # the largest tf32
    (0x7F7FF000, 0x7F800000),     # a tie past it overflows to inf
    (0x00001000, 0x00002000),     # a subnormal tie: away
    (0x00000FFF, 0x00000000),     # a subnormal rounds to +0
    (0x80001800, 0x80002000),     # a negative subnormal: up in magnitude
    (0x00000001, 0x00000000),     # the smallest subnormal
    (0x007FFFFF, 0x00800000),     # the largest subnormal: the least normal
    (0x7F800000, 0x7F800000),     # +inf
    (0xFF800000, 0xFF800000),     # -inf
]
NANS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF801000, 0x7FFFFFFF]


def test_tf32_rna_edges_bit_for_bit():
    x, want = (_bits(*col).view(torch.float32) for col in zip(*EDGES))
    got = tf32_rna(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), [
        (hex(a), hex(int(g) & 0xFFFFFFFF), hex(b)) for (a, b), g in
        zip(EDGES, got.view(torch.int32).tolist())
        if (int(g) & 0xFFFFFFFF) != b]
    assert torch.isnan(tf32_rna(_bits(*NANS).view(torch.float32))).all()


def test_split_keeps_float32_precision():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1 << 16, dtype=np.float32)
                         * np.float32(2.0) ** rng.integers(-60, 60, 1 << 16)
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):             # both are tf32: 13 low bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    # the pair holds x to 2^-22 of its magnitude (the lo part's rounding)
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # one tf32 pass keeps 11 bits: the pair is 2^10 times closer
    assert float((hi.double() - x.double()).abs().max()
                 / x.double().abs().max()) > 2.0 ** -13


def _draw(rng, *shapes):
    """numpy draws as (jax, torch) float32 pairs."""
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape, dtype=np.float32)
        out.append((jnp.asarray(x), torch.from_numpy(x)))
    return out


def _check_plain(name, got, want):
    """The RMS of ``got - want`` within TOL_PLAIN of ``want``'s RMS. (Not
    element by element: the plain version is a float32 computation too,
    whose largest element lies up to 7e-6 of the RMS from a float64
    result at these shapes, so two float32 sums in other orders can part
    by 1e-5 of it at one element.)"""
    rms = float(want.pow(2).mean().sqrt())
    err = float((got - want).pow(2).mean().sqrt())
    assert err <= TOL_PLAIN * rms, \
        f"{name}: RMS difference {err:.3g} > {TOL_PLAIN} x RMS {rms:.3g}"


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk", CASES)
def test_forward_3xtf32_matches_reference_and_plain(B, S, H, KV, hd, causal,
                                                    bq, bk):
    rng = np.random.default_rng(S + hd)
    (qj, qt), (kj, kt), (vj, vt) = _draw(rng, (B, H, S, hd), (B, KV, S, hd),
                                         (B, KV, S, hd))
    o, lse = fwd_3xtf32(qt, kt, vt, causal)
    want_o, want_lse = RF.flash_attention_fwd_kernel(
        qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=TOL_REF,
                               atol=TOL_REF)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-4,
                               atol=1e-4)
    plain_o, plain_lse = TF.flash_attention_fwd_plain(qt, kt, vt, causal, bq,
                                                      bk)
    _check_plain("o", o, plain_o)
    _check_plain("lse", lse, plain_lse)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,bq,bk", CASES)
def test_backward_3xtf32_matches_reference_and_plain(B, S, H, KV, hd, causal,
                                                     bq, bk):
    rng = np.random.default_rng(3 * S + hd)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _draw(
        rng, (B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))
    oj, lsej = RF.flash_attention_fwd_kernel(qj, kj, vj, causal=causal,
                                             block_q=bq, block_k=bk)
    ot = torch.from_numpy(np.array(oj))
    lset = torch.from_numpy(np.array(lsej))
    got = bwd_3xtf32(qt, kt, vt, ot, lset, dot, causal)
    want = RF.flash_attention_bwd_kernel(qj, kj, vj, oj, lsej, doj,
                                         causal=causal, block_q=bq,
                                         block_k=bk)
    plain = TF.flash_attention_bwd_plain(qt, kt, vt, ot, lset, dot, causal,
                                         bq, bk)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_REF,
                                   atol=TOL_REF, err_msg=name)
        _check_plain(name, g, p)
