"""Flash attention: softmax(q k^T / sqrt(hd) + mask) v per head, its
logsumexp rows, and its backward.

Port of the Pallas `repro.kernels.flashattn` kernels:

- `flash_attention_kernel` (the serving forward) and
  `flash_attention_fwd_kernel` (the same forward that also returns ``lse
  (B, H, Sq)`` float32, the training forward) launch ``csrc/flashattn.cu``
  (a CTA per query tile and head, an online softmax over key tiles; a
  null lse pointer runs the serving kernel unchanged);
- `flash_attention_bwd_kernel` launches ``csrc/flashattn_bwd.cu`` (a dq
  CTA per query tile and head; a dk / dv CTA per key tile and key/value
  head that loops over its GQA group, so the group's sum needs no
  atomics; in bf16, p and ds enter the products as hi + lo bf16 parts).

The C launchers pick the kernel by head dim and dtype. In bf16 the
forward runs the Hopper kernel (TMA ring, wgmma, setmaxnreg;
``csrc/flash_sm90.cuh``) at head dims 64 (SeamlessM4T), 80 (Zamba2's
shared attention), 112 (Kimi K2) and 128 (every dense config served and
trained), and the first design on ``mma.sync`` at 16 and 32 (test shapes,
off every main path); the backward runs the Hopper kernels at every head
dim. Float32 runs Hopper kernels of its own at every head dim
(``csrc/flash_tf32.cuh``): each product as three TF32 products on wgmma
(hi = tf32(x), lo = tf32(x - hi); a_lo b_hi + a_hi b_lo + a_hi b_hi in
float32), after a pre-pass that writes each operand's hi / lo copies, and
transposed ones for the products over rows, into a workspace the wrapper
allocates. A kernel that fails to build or launch raises; nothing falls
back on another.

The kernel wrappers take the model's layout, q (B, Sq, H, hd) and k / v
(B, Sk, KV, hd), and read it through its strides. For ``meta`` tensors,
under `launch.hlocost.count` only, they return empty outputs of the
kernel's shapes and charge the count the launch's `flash_cost`. For CPU
tensors they run the plain versions, `flash_attention_plain`,
`flash_attention_fwd_plain` and `flash_attention_bwd_plain`, which keep
the reference kernels' head-major layout and blocking: ``block_q`` x
``block_k`` tiles, the tiles above the diagonal skipped when causal,
float32 scores and softmax state; the forward rounds ``p`` to v's dtype
before the PV product, the backward stays in float32 throughout. The CUDA
kernels' tiles are fixed by the card (64 to 128 rows), so ``block_q`` /
``block_k`` shape only the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
#: the backward's: every head dim of the forward
BWD_HEAD_DIMS = HEAD_DIMS
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flashattn")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        s = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_workspace.restype = ctypes.c_longlong
        lib.flash_attention_workspace.argtypes = [i] * 7
        lib.flash_attention_launch.restype = i
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, p, s, s, s, s, i, i, i, i, i, i, i, ctypes.c_float,
            i, p, p]
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flashattn_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        s = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
        lib.flash_attention_bwd_workspace.argtypes = [i] * 7
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, s, s, s, s, s, s, s, i, i, i, i, i,
            i, i, ctypes.c_float, i, i, p, p]
    return lib


def _workspace(size_fn, q: torch.Tensor, k: torch.Tensor):
    """The launch's scratch (float32's split copies of the operands, see
    ``csrc/flash_tf32.cuh``): a fresh byte buffer of the size the C
    library asks for, or None (bf16 needs none)."""
    B, Sq, H, hd = q.shape
    nbytes = size_fn(B, Sq, k.shape[1], H, k.shape[2], hd,
                     _DTYPE_CODE[q.dtype])
    return (torch.empty(nbytes, dtype=torch.uint8, device=q.device)
            if nbytes else None)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           head_axis: int) -> None:
    """Shapes, dtypes and devices of q, k, v whose heads lie on
    ``head_axis`` (1 head-major, 2 the model's layout)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"flash attention takes 4-D tensors; {name} is "
                             f"{getattr(x, 'shape', type(x))}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    seq_axis = 3 - head_axis
    B, H, hd = q.shape[0], q.shape[head_axis], q.shape[3]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if H % k.shape[head_axis]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[head_axis]} key/value heads")
    if q.shape[seq_axis] < 1 or k.shape[seq_axis] < 1:
        raise ValueError("flash attention needs at least one query and key")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")


def flash_cost(kind: str, q: torch.Tensor, k: torch.Tensor,
               causal: bool) -> Tuple[int, int]:
    """(FLOPs, bytes) of one launch of flash kernel ``kind``
    ("flash_attention", "flash_attention_fwd" or "flash_attention_bwd")
    on model-layout q (B, Sq, H, hd) and k (B, Sk, KV, hd), from their
    shapes alone: the unmasked (query, key) pairs (causal: query i sees
    keys 0..i), two products of hd MACs each for a forward (five for the
    backward: s, dp, dv, dq, dk); q, k, v read and o written (the lse
    forward also writes the float32 lse; the backward reads q, k, v, o,
    do and the lse and writes dq, dk, dv). The kernels' bounds and
    `launch.hlocost`'s count both take it."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n = min(Sq, Sk)
    pairs = n * (n + 1) // 2 + (Sq - n) * Sk if causal else Sq * Sk
    es = q.element_size()
    if kind == "flash_attention_bwd":
        flops = 10 * B * H * hd * pairs
        nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * Sq
    else:
        flops = 4 * B * H * hd * pairs
        nbytes = es * (2 * q.numel() + 2 * k.numel()) + (
            4 * B * H * Sq if kind == "flash_attention_fwd" else 0)
    return flops, nbytes


def _charge_meta(kind: str, q: torch.Tensor, k: torch.Tensor,
                 causal: bool) -> None:
    """Charge one launch of ``kind`` on ``meta`` tensors to the innermost
    active count (a `launch.hlocost` dispatch mode); raise outside one: a
    ``meta`` call never runs a plain version."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "charge_kernel"):
            mode.charge_kernel(kind, *flash_cost(kind, q, k, causal))
            return
    raise ValueError(f"{kind} takes meta tensors only under "
                     "launch.hlocost.count")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    """The reference kernel's blocked online softmax in PyTorch.

    q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), H % KV == 0 -> (B, H, Sq,
    hd) in q's dtype. Causal masks ``qpos >= kpos`` with positions aligned
    at 0; keys past ``Sk`` (the padding of the last block) are masked."""
    return flash_attention_fwd_plain(q, k, v, causal, block_q, block_k)[0]


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              block_q: int = 512, block_k: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_plain` that also returns each row's logsumexp,
    ``lse = m + log(max(l, 1e-30))`` of the scaled, masked scores: (out
    (B, H, Sq, hd), lse (B, H, Sq) float32)."""
    _check(q, k, v, head_axis=1)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    pad_k = nk * bk - Sk
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
    scale = float(1.0 / np.sqrt(hd))
    qg = q.reshape(B, KV, G, Sq, hd)
    dev = q.device
    out = torch.empty((B, KV, G, Sq, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=dev)
    for qi in range(nq):
        rows = slice(qi * bq, min((qi + 1) * bq, Sq))
        qt = qg[:, :, :, rows].float()                  # (B, KV, G, bq, hd)
        n = qt.shape[3]
        qpos = qi * bq + torch.arange(n, device=dev)
        m = torch.full((B, KV, G, n), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, n), device=dev)
        acc = torch.zeros((B, KV, G, n, hd), device=dev)
        for ki in range(nk):
            if causal and (qi + 1) * bq - 1 < ki * bk:
                continue                       # wholly above the diagonal
            cols = slice(ki * bk, (ki + 1) * bk)
            kt = k[:, :, None, cols].float()            # (B, KV, 1, bk, hd)
            vt = v[:, :, None, cols]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            valid = (kpos < Sk)[None, :]
            if causal:
                valid = valid & (qpos[:, None] >= kpos[None, :])
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(v.dtype).float(), vt.float())
            m = m_new
        out[:, :, :, rows] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse[:, :, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return out.reshape(B, H, Sq, hd), lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, block_q: int = 512,
                              block_k: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The reference's backward kernels block for block, in PyTorch.

    q, o, do: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); lse: (B, H, Sq)
    float32, the forward's -> (dq in q's dtype, dk and dv in k's dtype).
    Float32 throughout: ``delta = rowsum(o do)``; per (query tile, key
    tile) p = exp(s - lse) where unmasked, dv += p^T do, ds = p (do v^T -
    delta) scale, dq += ds k, dk += ds^T q. The query axis is padded to
    whole tiles with lse = +inf (p = 0: padded rows add nothing), the key
    axis with masked zeros; dk / dv are kept per query head and summed
    over each GQA group before the cast, as the reference does."""
    _check(q, k, v, head_axis=1)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    pq, pk = nq * bq - Sq, nk * bk - Sk
    F = torch.nn.functional
    delta = (o.float() * do.float()).sum(-1)
    qf, dof = F.pad(q.float(), (0, 0, 0, pq)), F.pad(do.float(), (0, 0, 0, pq))
    lse = F.pad(lse.float(), (0, pq), value=float("inf"))
    delta = F.pad(delta, (0, pq))
    kf, vf = F.pad(k.float(), (0, 0, 0, pk)), F.pad(v.float(), (0, 0, 0, pk))
    qf, dof = (x.reshape(B, KV, G, nq * bq, hd) for x in (qf, dof))
    lse, delta = (x.reshape(B, KV, G, nq * bq) for x in (lse, delta))
    scale = float(1.0 / np.sqrt(hd))
    dev = q.device
    dq = torch.zeros_like(qf)
    dk_h = torch.zeros((B, KV, G, nk * bk, hd), device=dev)
    dv_h = torch.zeros_like(dk_h)
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qt, dot = qf[:, :, :, rows], dof[:, :, :, rows]
        qpos = qi * bq + torch.arange(bq, device=dev)
        for ki in range(nk):
            if causal and (qi + 1) * bq - 1 < ki * bk:
                continue                       # wholly above the diagonal
            cols = slice(ki * bk, (ki + 1) * bk)
            kt, vt = kf[:, :, None, cols], vf[:, :, None, cols]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            valid = (kpos < Sk)[None, :]
            if causal:
                valid = valid & (qpos[:, None] >= kpos[None, :])
            p = torch.where(valid, torch.exp(s - lse[..., rows, None]), 0.0)
            dv_h[..., cols, :] += torch.matmul(p.transpose(-1, -2), dot)
            dp = torch.matmul(dot, vt.transpose(-1, -2))
            ds = p * (dp - delta[..., rows, None]) * scale
            dq[..., rows, :] += torch.matmul(ds, kt)
            dk_h[..., cols, :] += torch.matmul(ds.transpose(-1, -2), qt)
    dq = dq[..., :Sq, :].reshape(B, H, Sq, hd).to(q.dtype)
    dk = dk_h.sum(2)[..., :Sk, :].to(k.dtype)
    dv = dv_h.sum(2)[..., :Sk, :].to(v.dtype)
    return dq, dk, dv


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernel can read it in place (unit stride on hd;
    for bf16's 16-byte loads also 16-byte aligned rows), else a fresh
    contiguous copy."""
    ok = x.stride(3) == 1
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 \
            and all(s % 8 == 0 for s in x.stride()[:3])
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _strides(x: torch.Tensor):
    """(batch, sequence, head) strides of a 4-D operand, for the launch."""
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _on_card(name: str, q: torch.Tensor, head_dims=HEAD_DIMS) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{name} takes head_dim in {head_dims}, got "
                         f"{q.shape[3]}")


def _launch_fwd(q, k, v, causal: bool, lse) -> torch.Tensor:
    """One launch of ``csrc/flashattn.cu``; ``lse`` is None (serving) or a
    contiguous (B, H, Sq) float32 buffer it fills."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = (_readable(x) for x in (q, k, v))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    ws = _workspace(lib.flash_attention_workspace, q, k)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), _strides(q), _strides(k), _strides(v),
            _strides(out), B, Sq, Sk, H, KV, hd, int(causal),
            float(1.0 / np.sqrt(hd)), _DTYPE_CODE[q.dtype], _build.ptr(ws),
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_launch")
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           block_q: int = 512,
                           block_k: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H % KV == 0 -> (B, Sq, H,
    hd), hd in `HEAD_DIMS`, float32 or bfloat16.

    On the card the operands are read through their strides (unit stride
    on hd), so views cost no copy. CPU tensors run `flash_attention_plain`
    on head-major views."""
    _check(q, k, v, head_axis=2)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            block_q, block_k).transpose(1, 2)
    if q.device.type == "meta":
        _charge_meta("flash_attention", q, k, causal)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _on_card("flash_attention_kernel", q)
    out = _launch_fwd(q, k, v, causal, None)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               block_q: int = 512, block_k: int = 512
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_kernel` that also returns each row's logsumexp:
    (out (B, Sq, H, hd), lse (B, H, Sq) float32), the residuals of the
    backward. CPU tensors run `flash_attention_fwd_plain`."""
    _check(q, k, v, head_axis=2)
    if q.device.type == "cpu":
        out, lse = flash_attention_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            block_q, block_k)
        return out.transpose(1, 2), lse
    if q.device.type == "meta":
        _charge_meta("flash_attention_fwd", q, k, causal)
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                            dtype=torch.float32, device=q.device))
    _on_card("flash_attention_fwd_kernel", q)
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, lse)
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               causal: bool = True, block_q: int = 512,
                               block_k: int = 512
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Gradients of `flash_attention_fwd_kernel`'s output: q, o, do (B,
    Sq, H, hd); k, v (B, Sk, KV, hd); lse (B, H, Sq) float32 -> (dq (B,
    Sq, H, hd) in q's dtype, dk and dv (B, Sk, KV, hd) in k's dtype).

    On the card ``delta = rowsum(o do)`` is one float32 PyTorch reduction,
    then ``csrc/flashattn_bwd.cu`` launches its dq and dk / dv kernels
    (counted as one launch). CPU tensors run `flash_attention_bwd_plain`
    on head-major views."""
    _check(q, k, v, head_axis=2)
    B, Sq, H, hd = q.shape
    for name, x in (("o", o), ("do", do)):
        if not isinstance(x, torch.Tensor) or x.shape != q.shape \
                or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if not isinstance(lse, torch.Tensor) or tuple(lse.shape) != (B, H, Sq) \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32 on "
                         f"{q.device}")
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_plain(
            *(x.transpose(1, 2) for x in (q, k, v, o)), lse,
            do.transpose(1, 2), causal, block_q, block_k)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if q.device.type == "meta":
        _delta(o, do)                   # the card's one PyTorch reduction
        _charge_meta("flash_attention_bwd", q, k, causal)
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty(k.shape, dtype=k.dtype, device=q.device),
                torch.empty(k.shape, dtype=k.dtype, device=q.device))
    _on_card("flash_attention_bwd_kernel", q, BWD_HEAD_DIMS)
    grads = _launch_bwd(q, k, v, o, lse, do, causal)
    LAUNCHES["flash_attention_bwd"] += 1
    return grads


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(o do)`` (B, H, Sq) float32, contiguous: float32 products
    (do is promoted inside the multiply, not copied)."""
    return (o.float() * do).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, o, lse, do, causal: bool, split: bool = True):
    """One launch of ``csrc/flashattn_bwd.cu`` after ``delta = rowsum(o
    do)``. ``split=False`` rounds p and ds to bf16 once in the head-dim-128
    bf16 kernels instead of entering them as hi + lo parts: it exists to
    measure what the split costs, and the port never passes it."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    delta = _delta(o, do)
    q, k, v, do = (_readable(x) for x in (q, k, v, do))
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _bwd_lib()
    ws = _workspace(lib.flash_attention_bwd_workspace, q, k)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dq),
            _build.ptr(dk), _build.ptr(dv), _strides(q), _strides(k),
            _strides(v), _strides(do), _strides(dq), _strides(dk),
            _strides(dv), B, Sq, Sk, H, KV, hd, int(causal),
            float(1.0 / np.sqrt(hd)), _DTYPE_CODE[q.dtype], int(split),
            _build.ptr(ws), _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_bwd_launch")
    return dq, dk, dv
