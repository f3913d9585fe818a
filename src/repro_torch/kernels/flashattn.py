"""Flash attention forward: softmax(q k^T / sqrt(hd) + mask) v per head.

Port of the Pallas `repro.kernels.flashattn.flash_attention_kernel`.
`flash_attention_kernel` takes the model's layout, q (B, Sq, H, hd) and
k / v (B, Sk, KV, hd), and launches ``csrc/flashattn.cu`` for CUDA
tensors (one CTA per 64-row query tile and head, an online softmax over
64-key tiles; bf16 on ``mma.sync``, float32 on scalar FMAs), which reads
them through their strides. For CPU tensors it runs the plain version,
`flash_attention_plain`, which keeps the reference kernel's head-major
layout and blocking: ``block_q`` x ``block_k`` tiles, the tiles above the
diagonal skipped when causal, float32 scores and softmax state, ``p``
rounded to v's dtype before the PV product. The CUDA kernel's tiles are
fixed by the card (64 x 64), so ``block_q`` / ``block_k`` shape only the
plain version. The forward that also emits the logsumexp and the
backward kernels wait for the training slice.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flashattn")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        s = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_launch.restype = i
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, s, s, s, s, i, i, i, i, i, i, i, ctypes.c_float, i,
            p]
    return lib


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    """The reference kernel's blocked online softmax in PyTorch.

    q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), H % KV == 0 -> (B, H, Sq,
    hd) in q's dtype. Causal masks ``qpos >= kpos`` with positions aligned
    at 0; keys past ``Sk`` (the padding of the last block) are masked."""
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
    return out.reshape(B, H, Sq, hd)


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernel can read it in place (unit stride on hd;
    for bf16's 16-byte loads also 16-byte aligned rows), else a fresh
    contiguous copy."""
    ok = x.stride(3) == 1
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 \
            and all(s % 8 == 0 for s in x.stride()[:3])
    return x if ok else x.clone(memory_format=torch.contiguous_format)


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel runs on cuda or cpu, not "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    q, k, v = (_readable(x) for x in (q, k, v))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)

    def strides(x):                     # batch, sequence, head
        return (ctypes.c_longlong * 3)(*x.stride()[:3])

    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            strides(q), strides(k), strides(v), strides(out),
            B, Sq, Sk, H, KV, hd, int(causal), float(1.0 / np.sqrt(hd)),
            _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_launch")
    LAUNCHES["flash_attention"] += 1
    return out
