"""Inputs made from ``--seed``: the SSB columns, the LM weights and the
token ids, on the device, in a few large calls.

The benchmark makes them and hands the same to the program and to the
plain reference, which makes them again after the window: the same seed
and the same calls in the same order give the same values.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    words = [seed % 2**64] + [zlib.crc32(str(t).encode()) for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *tags))
    return g


def ssb_columns(config: Mapping, rows: int, seed: int, device
                ) -> Iterator[Tuple[Mapping, torch.Tensor]]:
    """Each column of ``config`` as ``rows`` int32 codes drawn uniformly
    over its [min, max], in the configuration's order."""
    g = generator(device, seed, "columns")
    for col in config["columns"]:
        yield col, torch.randint(col["min"], col["max"] + 1, (rows,),
                                 generator=g, dtype=torch.int32,
                                 device=device)


# ---------------------------------------------------------------------------
# a dense decoder's weights, in the port's checkpoint layout
# ---------------------------------------------------------------------------

INIT_STD = 0.02


def weight_shapes(cfg: Mapping, padded_vocab: int) -> List[Tuple[str, tuple]]:
    """Every weight of a dense decoder (``configs/<model>.json`` keys) by
    name and shape, in the layout the port's `Transformer` holds them."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    out = [("embed.tok", (padded_vocab, d)), ("embed.head", (d, padded_vocab))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,)), (p + "attn.wq", (d, h, hd)),
                (p + "attn.wk", (d, kv, hd)), (p + "attn.wv", (d, kv, hd)),
                (p + "attn.wo", (h, hd, d)), (p + "attn.q_norm", (hd,)),
                (p + "attn.k_norm", (hd,)), (p + "ln2", (d,)),
                (p + "mlp.wi", (d, 2, f)), (p + "mlp.wo", (f, d))]
    out.append(("final_norm", (d,)))
    return out


def lm_weights(cfg: Mapping, padded_vocab: int, seed: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The weights as views of one buffer drawn in one call: N(0, 0.02^2)
    matrices, the output projections (``attn.wo``, ``mlp.wo``) scaled by
    1/sqrt(2 L), norm scales 1."""
    shapes = weight_shapes(cfg, padded_vocab)
    sizes = [int(np.prod(s)) for _, s in shapes]
    g = generator(device, seed, "weights")
    flat = torch.randn(sum(sizes), generator=g, dtype=dtype, device=device)
    flat.mul_(INIT_STD)
    out_scale = 1.0 / np.sqrt(2 * cfg["num_hidden_layers"])
    out: Dict[str, torch.Tensor] = {}
    for (name, shape), t in zip(shapes, flat.split(sizes)):
        t = t.view(shape)
        if name.endswith(("norm", "ln1", "ln2")):
            t.fill_(1)
        elif name.endswith(("attn.wo", "mlp.wo")):
            t.mul_(out_scale)
        out[name] = t
    return out


def token_ids(vocab: int, shape, seed: int, index: int, device
              ) -> torch.Tensor:
    """The ``index``-th draw of ids in [0, vocab) under ``seed``."""
    g = generator(device, seed, "ids", index)
    return torch.randint(0, vocab, shape, generator=g, dtype=torch.int64,
                         device=device)


def leaf_name(name: str) -> str:
    """A parameter's leaf: its name without layer indices
    (``layers.3.attn.wq`` -> ``layers.attn.wq``)."""
    return ".".join(p for p in name.split(".") if not p.isdigit())
