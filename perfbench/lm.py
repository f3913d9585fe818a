"""What the LM drivers share: the port's configuration made from
``configs/<model>.json``, the benchmark's weights loaded into the port's
model, and the reference's weights made again from the seed."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from perfbench import data

#: ``configs/<model>.json`` key -> the port's `ModelConfig` field
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "vocab_size": "vocab_size", "rope_theta": "rope_theta",
          "rms_norm_eps": "norm_eps", "torch_dtype": "dtype",
          "attention_bias": "qkv_bias"}


#: the port pads its token table and head to a multiple of this many rows
VOCAB_PAD = 2048


def padded(vocab: int) -> int:
    """Rows of the port's token table and head for ``vocab`` ids."""
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def sized(config: Mapping, overrides: Mapping) -> Dict:
    """The configuration with a CPU rehearsal's smaller sizes, if any."""
    out = dict(config)
    out.update({k: v for k, v in overrides.items() if k in FIELDS})
    return out


#: what a model configuration's file holds besides `FIELDS`: the keys
#: that `port_config` checks, and those that document the file
CONFIG_KEYS = tuple(FIELDS) + (
    "name", "system", "source", "arch", "max_position_embeddings",
    "hidden_act", "tie_word_embeddings", "reduced", "reduced_why", "assumed",
    "footprint")


def dtype(config: Mapping) -> torch.dtype:
    """The type the configuration stores its weights and activations in."""
    return getattr(torch, config["torch_dtype"])


def port_config(config: Mapping):
    """The port's `ModelConfig` of ``config["arch"]`` with every size and
    setting of ``config``; raises where the file holds a key that no
    driver reads, or asks for what the port's dense family cannot do."""
    from repro_torch.configs.base import get_config

    from perfbench.harness import known_keys

    known_keys(config, CONFIG_KEYS, f"configs/{config['name']}")
    cfg = get_config(config["arch"])
    if cfg.family != "dense" or cfg.mlp_kind != "swiglu" or not cfg.qk_norm:
        raise ValueError(f"{cfg.name} is not a dense SwiGLU decoder with "
                         "qk-norm")
    if config["hidden_act"] != "silu" or config["tie_word_embeddings"]:
        raise ValueError("the port's dense family gates with silu and "
                         "unties its head")
    return dataclasses.replace(cfg, **{FIELDS[k]: config[k] for k in FIELDS})


def load_model(cfg, weights: Mapping[str, torch.Tensor], device):
    """The port's dense `Transformer` holding ``weights`` (every
    parameter, by name and shape)."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, torch.device(device))
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the port's parameters differ from the "
                         f"benchmark's weights: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise ValueError(f"{n}: {tuple(p.shape)} in the port, "
                                 f"{tuple(weights[n].shape)} here")
            p.copy_(weights[n])
    return model


def reference_weights(config: Mapping, padded_vocab: int, seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """The same weights again, as float32 tensors of their own."""
    w = data.lm_weights(config, padded_vocab, seed, device, dtype(config))
    return {n: t.float() for n, t in w.items()}
