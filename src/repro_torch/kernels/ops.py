"""Public wrappers over the port's kernels.

The counterpart of the reference's `repro.kernels.ops`. Each wrapper
reshapes its operands to the kernel's layout and calls the kernel
wrapper (looked up on its module at call time), which launches the CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.
Operands are int32 word tensors (`core.bitplane.as_words`), or floats
for the sign packing and flash attention. The reference's fold of 1-D
operands into 8 sublane rows and its interpret-mode block sizes served
the TPU's tiles and are gone.
`flash_attention` is differentiable: with grad on it is a
`torch.autograd.Function` whose forward is the lse-emitting kernel and
whose backward is the backward kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import arith, bittranspose, bitweaving
from repro_torch.kernels import bitwise as _bitwise
from repro_torch.kernels import flashattn as _flashattn
from repro_torch.kernels import majority as _majority
from repro_torch.kernels import popcount as _popcount
from repro_torch.kernels import signpack as _signpack
from repro_torch.kernels.vm import run_megakernel, vm_megakernel  # noqa: F401


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Any (..., W) operand as (rows, W); a (W,) vector is one row."""
    if x.dim() == 0:
        raise ValueError("bitwise operands need a word axis")
    return x.reshape(-1, x.shape[-1])


def bitwise(op: str, *args: torch.Tensor) -> torch.Tensor:
    """Fused bitwise op over int32 operands of one shape, (words,) or
    (..., words); the result has that shape."""
    shape = args[0].shape
    return _bitwise.bitwise_kernel(
        op, *(_rows(a) for a in args)).reshape(shape)


def bitwise_banked(op: str, *args: torch.Tensor,
                   n_banks: int = 1) -> torch.Tensor:
    """Bank-parallel bitwise op: operands sharded word-wise over `n_banks`.

    (words,) or (..., words) operands are partitioned with
    `core.bankgroup.shard_words` (zero pad to a multiple of `n_banks`,
    bank axis first), evaluated with the bank-gridded kernel, and
    reassembled with the pad words stripped. Bit-identical to
    `bitwise(op, *args)` for every op and bank count, ``not`` / ``nand``
    included, which drive the pad words to ones.
    """
    from repro_torch.core.bankgroup import shard_words, unshard_words

    shape = args[0].shape
    sharded = tuple(shard_words(_rows(a), n_banks) for a in args)
    out = _bitwise.banked_bitwise_kernel(op, *sharded)
    return unshard_words(out, shape[-1]).reshape(shape)


def majority(planes: torch.Tensor,
             threshold: Optional[int] = None) -> torch.Tensor:
    """(k, words) -> (words,) or (k, rows, words) -> (rows, words) packed
    majority (generalized TRA): each bit set where at least ``threshold``
    (default ``k // 2 + 1``) planes have it set."""
    if planes.dim() == 2:
        return _majority.majority_kernel(planes[:, None, :], threshold)[0]
    return _majority.majority_kernel(planes, threshold)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of (words,) or (..., words) int32 words: a 0-dim
    int64 tensor on their device."""
    return _popcount.popcount_kernel(_rows(words))


def bit_transpose(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(n,) int32 -> (n_bits, n//32) vertical planes (LSB-first order)."""
    return bittranspose.bit_transpose_kernel(values, n_bits)


def bit_untranspose(planes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(b, g) vertical planes -> (32g,) int32 values built from the first
    ``n_bits`` planes; the bits above them are zero (the kernel reads only
    those planes, with no padded copy)."""
    b = planes.shape[0]
    if not 0 <= n_bits <= min(b, 32):
        raise ValueError(f"n_bits must be in 0..{min(b, 32)}, got {n_bits}")
    return bittranspose.bit_untranspose_kernel(planes[:n_bits])


def bitweaving_scan(planes: torch.Tensor, c1: int, c2: int,
                    n_bits: int) -> torch.Tensor:
    """(b, g) planes -> (g,) packed words of ``c1 <= v <= c2``."""
    return bitweaving.bitweaving_scan_kernel(planes, c1, c2, n_bits)


def bitserial_add(a_planes: torch.Tensor, b_planes: torch.Tensor,
                  sub: bool = False) -> torch.Tensor:
    """(n_bits, words) or (n_bits, rows, words) plane add / sub, modulo
    ``2**n_bits``; the result has the operands' shape."""
    if a_planes.dim() == 2:
        return arith.bitserial_add_kernel(
            a_planes[:, None, :], b_planes[:, None, :], sub)[:, 0]
    return arith.bitserial_add_kernel(a_planes, b_planes, sub)


def bitserial_lt(a_planes: torch.Tensor,
                 b_planes: torch.Tensor) -> torch.Tensor:
    """Packed unsigned ``a < b`` over (n_bits, words) or (n_bits, rows,
    words) vertical planes: (words,) or (rows, words)."""
    if a_planes.dim() == 2:
        return arith.bitserial_lt_kernel(a_planes[:, None, :],
                                         b_planes[:, None, :])[0]
    return arith.bitserial_lt_kernel(a_planes, b_planes)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(32 w,) or (r, 32 w) float32 / bf16 -> (w,) or (r, w) int32 words
    of IEEE sign bits (bit i of word j = lane 32 j + i; -0.0 -> 1)."""
    if x.dim() == 1:
        return _signpack.pack_signs_kernel(x[None, :])[0]
    return _signpack.pack_signs_kernel(x)


def unpack_signs(words: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(w,) or (r, w) int32 words -> (32 w,) or (r, 32 w) in {+1, -1} of
    ``dtype`` (a set bit gives -1)."""
    if words.dim() == 1:
        return _signpack.unpack_signs_kernel(words[None, :], dtype)[0]
    return _signpack.unpack_signs_kernel(words, dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_hm`` custom VJP: the forward saves q, k,
    v, o and lse (no O(S^2) state), the backward recomputes p from them.
    Both call the kernel wrappers, which take the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = _flashattn.flash_attention_fwd_kernel(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.args
        dq, dk, dv = _flashattn.flash_attention_bwd_kernel(
            q, k, v, o, lse, do, causal=causal, block_q=block_q,
            block_k=block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Attention in the model-side layout: q (B, Sq, H, hd), k / v (B, Sk,
    KV, hd) -> (B, Sq, H, hd), read in place on the card (the reference's
    wrapper transposes). Differentiable: where grad is on and an operand
    needs it, the forward is `flash_attention_fwd_kernel` and the backward
    `flash_attention_bwd_kernel`; otherwise (serving) the lse-free
    `flash_attention_kernel`.

    DTensor operands take the reference's ``shard_map`` branch
    (`_flash_on_mesh`) on their own mesh: each rank runs the kernels on
    its local shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _flash_on_mesh(q, k, v, causal, block_q, block_k,
                              q.device_mesh)
    return _flash_local(q, k, v, causal, block_q, block_k)


def _flash_local(q, k, v, causal, block_q, block_k):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
    return _flashattn.flash_attention_kernel(q, k, v, causal=causal,
                                             block_q=block_q,
                                             block_k=block_k)


def _flash_on_mesh(q, k, v, causal, block_q, block_k, mesh):
    """The reference's mesh branch (`repro.kernels.flashattn.
    flash_attention` under a mesh) on DTensors: the kernels run inside
    `local_map` on each rank's shard, batch on the data axes and heads on
    the model axis as `resolve_spec` places them (other placements, such
    as a sequence sharded by the "sp" rules, are redistributed first).

    A rank's q heads are a contiguous block of ``H / shards`` heads. When
    the shards divide the KV heads too, k and v are sharded on their heads
    alike and each rank holds its own group. Otherwise k and v stay
    replicated over the head axes and each rank slices out the KV heads
    its q heads map to, as the reference's ``_local`` does; each rank then
    writes only its slice of dk and dv, so their gradients are ``Partial``
    (summed over the head axes), not ``Replicate``."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import (mesh_sizes, placements_of,
                                           resolve_spec)
    from repro_torch.launch.hlocost import per_shard
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    spec = resolve_spec((B, Sq, H, hd), ("batch", None, "heads", None), mesh)
    sizes = mesh_sizes(mesh)
    h_axes = () if spec[2] is None else (
        (spec[2],) if isinstance(spec[2], str) else tuple(spec[2]))
    h_shards, idx = 1, 0
    for a in h_axes:                  # this rank's block of q heads
        h_shards *= sizes[a]
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    H_loc = H // h_shards
    kv_split = KV % h_shards == 0
    if not kv_split and H_loc % G and G % H_loc:
        raise ValueError(f"{H_loc} q heads a shard do not map onto whole "
                         f"groups of {G} (H {H}, KV {KV})")
    q_pl = placements_of(spec, mesh)
    kv_pl = placements_of(
        (spec[0], None, spec[2] if kv_split else None, None), mesh)
    kv_grad = kv_pl if kv_split else tuple(
        Partial() if a in h_axes else p for a, p in zip(sizes, kv_pl))
    start, count = (idx * H_loc) // G, max(1, H_loc // G)

    def local(a, b, c):
        if not kv_split:
            b, c = b[:, :, start:start + count], c[:, :, start:start + count]
        return _flash_local(a, b, c, causal, block_q, block_k)

    shards = math.prod(sizes[a] for a, p in zip(sizes, q_pl)
                       if isinstance(p, Shard))
    f = local_map(per_shard(local, shards), out_placements=(q_pl,),
                  in_placements=(q_pl, kv_pl, kv_pl),
                  in_grad_placements=(q_pl, kv_grad, kv_grad),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(q, k, v)
