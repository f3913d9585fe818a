"""A plain PyTorch Qwen3 decoder in float32: the reference of the LM
cells. Written from the published architecture (RMSNorm, GQA attention
with RMSNorm on each head's q and k before RoPE, SwiGLU MLP, untied
head), with the departures of the configuration as it is run: the norm
epsilon and the untied head of ``configs/<model>.json``, the logits and
the loss over every row of the (padded) head, and the loss's z-term
(1e-4 x logsumexp^2 per token), as the port computes them.

Weights are a dict in the layout `perfbench.data.weight_shapes` names.
The products run in float32 with TF32 off; ``quant="fp8"`` rounds both
operands of every product to float8 e4m3 (scaled by their largest
magnitude) on the way forward: the control, a precision below the
configuration's bf16.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Z_LOSS = 1e-4
FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 at the tensor's own scale; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return _Fp8.apply(x) if quant == "fp8" else x


def _mm(eq: str, a, b, quant):
    return torch.einsum(eq, _q(a, quant), _q(b, quant))


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, heads, hd), positions 0..S-1; the halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs.to(torch.float32)[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer(x, w: Sequence[torch.Tensor], cfg: Mapping, quant=None):
    """One decoder layer; ``w`` = (ln1, wq, wk, wv, wo, q_norm, k_norm,
    ln2, wi, wo_mlp)."""
    ln1, wq, wk, wv, wo, qn, kn, ln2, wi, wo2 = w
    eps, hd = cfg["rms_norm_eps"], cfg["head_dim"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    h = rmsnorm(x, ln1, eps)
    q = rmsnorm(_mm("bsd,dhk->bshk", h, wq, quant), qn, eps)
    k = rmsnorm(_mm("bsd,dhk->bshk", h, wk, quant), kn, eps)
    v = _mm("bsd,dhk->bshk", h, wv, quant)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = _mm("bqhd,bkhd->bhqk", q, k, quant) / math.sqrt(hd)
    S = x.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm("bhqk,bkhd->bqhd", p, v, quant)
    x = x + _mm("bshk,hkd->bsd", o, wo, quant)
    h = rmsnorm(x, ln2, eps)
    gu = _mm("bsd,dcf->bscf", h, wi, quant)
    a = torch.nn.functional.silu(gu[:, :, 0]) * gu[:, :, 1]
    return x + _mm("bsf,fd->bsd", a, wo2, quant)


LAYER_KEYS = ("ln1", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
              "attn.q_norm", "attn.k_norm", "ln2", "mlp.wi", "mlp.wo")


def _layer_weights(W, i) -> List[torch.Tensor]:
    return [W[f"layers.{i}.{k}"] for k in LAYER_KEYS]


def hidden(W, tokens, cfg, quant=None, remat=False):
    """tokens (B, S) -> final-normed hidden states (B, S, D)."""
    x = W["embed.tok"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        w = _layer_weights(W, i)
        if remat:
            x = checkpoint(layer, x, w, cfg, quant, use_reentrant=False)
        else:
            x = layer(x, w, cfg, quant)
    return rmsnorm(x, W["final_norm"], cfg["rms_norm_eps"])


def loss(W, tokens, labels, cfg, quant=None, remat=True):
    """Mean token cross-entropy plus the z-term, over every head row."""
    x = hidden(W, tokens, cfg, quant, remat)
    logits = _mm("bsd,dv->bsv", x, W["embed.head"], quant)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - ll + Z_LOSS * lse * lse).mean()


@torch.no_grad()
def last_logits(W, tokens, cfg, quant=None) -> torch.Tensor:
    """(B, S) prompts -> the last position's logits (B, V)."""
    x = hidden(W, tokens, cfg, quant)[:, -1:]
    return _mm("bsd,dv->bsv", x, W["embed.head"], quant)[:, 0]


def warmup_cosine(step: int, peak: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``final_frac`` of it at ``total``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (final_frac + (1 - final_frac) * 0.5
                   * (1 + math.cos(math.pi * t)))


def train(W: Dict[str, torch.Tensor], cfg: Mapping,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          opt: Mapping, quant: Optional[str] = None,
          store_dtype=torch.bfloat16, rows: Optional[int] = None
          ) -> Dict:
    """``len(batches)`` AdamW steps from weights ``W`` (float32, updated
    in place): each step's loss over its whole batch (one sequence at a
    time, the gradients summed in float32), the gradients clipped to a
    global norm of ``opt["clip"]``, AdamW in float32, and the parameters
    stored in ``store_dtype`` between steps, as the configuration holds
    them. ``rows`` keeps only the first rows of each batch (a planted
    fault). Returns the losses, each leaf's gradient norm at the first
    step as the optimizer gets it, and its change over the steps."""
    names = list(W)
    p0 = {n: W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    b1, b2 = opt["b1"], opt["b2"]
    losses, first_grads = [], None
    for step, (tokens, labels) in enumerate(batches):
        if rows is not None:
            tokens, labels = tokens[:rows], labels[:rows]
        params = {n: W[n].detach().requires_grad_(True) for n in names}
        grads = {n: torch.zeros_like(W[n]) for n in names}
        total = 0.0
        for r in range(tokens.shape[0]):
            ls = loss(params, tokens[r:r + 1], labels[r:r + 1], cfg, quant)
            g = torch.autograd.grad(ls, [params[n] for n in names])
            for n, gi in zip(names, g):
                grads[n] += gi
            total += float(ls.detach())
            del g, ls
        n_rows = tokens.shape[0]
        losses.append(total / n_rows)
        gn = math.sqrt(sum(float((grads[n] / n_rows).double().pow(2).sum())
                           for n in names))
        scale = min(1.0, opt["clip"] / max(gn, 1e-9))
        with torch.no_grad():
            lr = warmup_cosine(step, opt["lr"], opt["warmup"], opt["total"])
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for n in names:
                gr = grads[n] / n_rows * scale
                m[n].mul_(b1).add_(gr, alpha=1 - b1)
                v[n].mul_(b2).add_(gr * gr, alpha=1 - b2)
                u = (m[n] / c1) / (torch.sqrt(v[n] / c2) + opt["eps"])
                new = W[n] - lr * (u + opt["weight_decay"] * W[n])
                W[n].copy_(new.to(store_dtype).to(W[n].dtype))
            if first_grads is None:
                first_grads = {n: grads[n] / n_rows * scale for n in names}
        del grads, params
    change = {n: W[n] - p0[n] for n in names}
    return {"losses": losses, "grads": leaf_norms(first_grads),
            "change": leaf_norms(change)}


def leaf_of(name: str) -> str:
    """A parameter's leaf: its name without layer indices."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The L2 norm of each leaf (its layers' parameters together)."""
    sq: Dict[str, float] = {}
    for n, t in tensors.items():
        leaf = leaf_of(n)
        sq[leaf] = sq.get(leaf, 0.0) + float(t.double().pow(2).sum())
    return {k: math.sqrt(x) for k, x in sq.items()}
